"""Port parity: the local substrate (``repro_torch.core.local`` and the
``substrate='local'`` front door of ``repro_torch.core.api``) against the
JAX package's (tests/test_local.py, mirrored case by case).

Graphs come from the reference's generators (numpy, seeded) and cross to
the port as the same arrays.  Everything here is held bitwise on unit
weights: the explorer's candidate sets and work counters, the padded
buffer ``induced_padded`` builds from the same CSR, and every field of
``solve(..., seed=)`` including ``extras['local']`` key by key.  The
reference's program-cache test (no retrace for a second seed in the same
bucket) becomes a bucket check here: the port has no programs to cache.
The serving half of tests/test_local.py is in
tests/test_torch_serve_densest.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.api as ref_api
from repro.core import densest_subgraph_brute
from repro.core.local import LocalExplorer as RefExplorer
from repro.core.local import check_count as ref_check_count
from repro.core.local import check_seed as ref_check_seed
from repro.core.local import induced_padded as ref_induced_padded
from repro.graph.edgelist import from_numpy as ref_from_numpy
from repro.graph.edgelist import to_csr as ref_to_csr
from repro.graph.generators import planted_dense_subgraph
from repro_torch.core import api
from repro_torch.core.local import LocalExplorer, check_count, check_seed, induced_padded
from repro_torch.graph.edgelist import from_reference, to_csr

EPS = 0.5
PROB = api.Problem.undirected(eps=EPS)
PROB_LOCAL = dataclasses.replace(PROB, substrate="local")
REF_PROB_LOCAL = dataclasses.replace(ref_api.Problem.undirected(eps=EPS), substrate="local")
OUTCOME = ("best_alive", "best_t", "best_density", "best_size", "alive", "t_alive",
           "history_n", "history_m", "history_rho")
EXPLORATION = ("seed", "rounds", "nodes_touched", "edges_scanned", "frontier_exhausted")


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _planted(n=400, k=30, seed=7):
    g, planted = planted_dense_subgraph(n, 4.0, k, 0.6, seed=seed)
    return g, _port(g), planted


def _clique_plus_path(kq=6, path_len=5):
    """A kq-clique with a pendant path hanging off node 0 (both packages)."""
    src, dst = [], []
    for u in range(kq):
        for v in range(u + 1, kq):
            src.append(u)
            dst.append(v)
    for i in range(path_len):
        src.append(0 if i == 0 else kq + i - 1)
        dst.append(kq + i)
    n = kq + path_len
    ref = ref_from_numpy(np.asarray(src), np.asarray(dst), n)
    return ref, _port(ref), n


def _explorers(ref_graph, port_graph):
    return RefExplorer.from_edgelist(ref_graph), LocalExplorer.from_edgelist(port_graph)


def _same_exploration(got, want):
    np.testing.assert_array_equal(got.candidates, want.candidates)
    assert got.candidates.dtype == want.candidates.dtype
    for f in EXPLORATION:
        assert getattr(got, f) == getattr(want, f), f


def _explore_both(ref_graph, port_graph, seed, **kw):
    rex, pex = _explorers(ref_graph, port_graph)
    got, want = pex.explore(seed, **kw), rex.explore(seed, **kw)
    _same_exploration(got, want)
    return got, pex


def _bits(x) -> bytes:
    return x.numpy().tobytes() if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()


# ---------------------------------------------------------------------------
# explorer invariants (each against the reference's exploration)
# ---------------------------------------------------------------------------


def test_explore_invariants_and_determinism():
    ref_g, g, planted = _planted()
    rex, ex = _explorers(ref_g, g)
    for s in [int(planted[0]), 0, 17]:
        a = ex.explore(s, budget=64)
        b = ex.explore(s, budget=64)  # same explorer: scratch must be clean
        _same_exploration(b, a)
        _same_exploration(a, rex.explore(s, budget=64))
        c = a.candidates
        assert s in c
        assert len(c) <= 64
        assert np.array_equal(c, np.unique(c))  # sorted + unique
        assert a.nodes_touched >= len(c)
        assert a.edges_scanned > 0
    assert not ex._member.any()
    assert not ex._deg_t.any()


def test_budget_one_returns_exactly_the_seed():
    ref_g, g, _ = _planted()
    a, _ = _explore_both(ref_g, g, 5, budget=1)
    np.testing.assert_array_equal(a.candidates, [5])
    assert a.rounds == 0


def test_isolated_seed_exhausts_immediately():
    ref_g = ref_from_numpy(np.asarray([0]), np.asarray([1]), 4)  # nodes 2, 3 isolated
    a, _ = _explore_both(ref_g, _port(ref_g), 3, budget=8)
    np.testing.assert_array_equal(a.candidates, [3])
    assert a.frontier_exhausted


def test_pruning_keeps_clique_drops_pendant_path():
    ref_g, g, n = _clique_plus_path(kq=6, path_len=5)
    a, _ = _explore_both(ref_g, g, 1, budget=n)
    assert set(range(6)) <= set(a.candidates.tolist())
    assert a.frontier_exhausted
    assert (6 + 4) not in a.candidates  # path tail never admitted
    assert len(a.candidates) < n


def test_volume_cap_skips_hub_rows():
    """A hub one hop from the seed whose row does not fit the work budget
    is never admitted, while the small rows around it are."""
    src = [0, 0, 0, 0, 0] + [1] * 1000
    dst = [1, 2, 3, 4, 5] + list(range(6, 1006))
    ref_g = ref_from_numpy(np.asarray(src), np.asarray(dst), 1006)
    g = _port(ref_g)
    a, _ = _explore_both(ref_g, g, 0, budget=50, volume_factor=2)  # cap = 100 slots
    assert 1 not in a.candidates
    assert {2, 3, 4, 5} <= set(a.candidates.tolist())
    assert a.edges_scanned <= 100
    b, _ = _explore_both(ref_g, g, 0, budget=50, volume_factor=50)
    assert 1 in b.candidates


def test_alpha_zero_disables_density_pruning():
    ref_g, g, n = _clique_plus_path(kq=6, path_len=5)
    a, _ = _explore_both(ref_g, g, 1, budget=n, max_rounds=n, alpha=0.0)
    assert len(a.candidates) == n


@pytest.mark.parametrize("bad,exc", [(2.5, TypeError), (True, TypeError), ("5", TypeError),
                                     (-1, ValueError), (50, ValueError)])
def test_seed_validation_matches_reference(bad, exc):
    with pytest.raises(exc):
        ref_check_seed(bad, 50)
    with pytest.raises(exc):
        check_seed(bad, 50)


def test_seed_and_count_validation():
    ref_g, g, _ = _planted(n=50, k=8)
    ex = LocalExplorer.from_edgelist(g)
    assert check_seed(np.int64(5), 50) == ref_check_seed(np.int64(5), 50) == 5
    with pytest.raises(ValueError):
        ex.explore(5, budget=0)
    with pytest.raises(TypeError):
        ex.explore(5, budget=2.0)
    with pytest.raises(ValueError):
        ex.explore(5, alpha=-0.5)
    with pytest.raises(ValueError):
        check_count(0, "radius")
    with pytest.raises(ValueError):
        ref_check_count(0, "radius")
    with pytest.raises(TypeError, match="bool"):
        check_count(True, "budget")
    directed = from_reference(np.asarray([0]), np.asarray([1]), np.ones(1, np.float32),
                              np.ones(1, bool), 3, True, "cpu")
    with pytest.raises(ValueError, match="undirected"):
        LocalExplorer.from_edgelist(directed)


# ---------------------------------------------------------------------------
# induced_padded: the reference's buffer, bitwise, from the same CSR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("floors", [(64, 256), (8, 32)])
def test_induced_padded_matches_reference_bitwise(floors):
    rng = np.random.default_rng(11)
    ref_g, _, planted = _planted()
    w = rng.integers(1, 5, ref_g.n_edges_padded).astype(np.float32)
    ref_g = ref_from_numpy(np.asarray(ref_g.src), np.asarray(ref_g.dst), ref_g.n_nodes, weight=w)
    g = _port(ref_g)
    ref_csr = ref_to_csr(ref_g, return_weights=True)
    csr = to_csr(g, return_weights=True)
    for a, b in zip(csr, ref_csr):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    n = g.n_nodes
    member, local_id = np.zeros(n, bool), np.zeros(n, np.int32)
    ref_member, ref_local_id = np.zeros(n, bool), np.zeros(n, np.int32)
    for nodes in (np.sort(planted), np.arange(0, 400, 7), np.asarray([3])):
        got = induced_padded(*csr, nodes, member, local_id,
                             node_floor=floors[0], edge_floor=floors[1])
        want = ref_induced_padded(*ref_csr, nodes, ref_member, ref_local_id,
                                  node_floor=floors[0], edge_floor=floors[1])
        assert got.n_nodes == want.n_nodes and not got.directed
        for f in ("src", "dst", "weight", "mask"):
            t = getattr(got, f)
            assert t.device.type == "cpu" and t.dim() == 1
            assert _bits(t) == np.asarray(getattr(want, f)).tobytes(), f
        assert not member.any()  # scratch reset before return


def test_induced_padded_shares_the_host_arrays():
    """The buffer is CPU tensors over the numpy arrays (no copy): the
    device copy is the caller's, once per solve or per stacked group."""
    _, g, planted = _planted()
    ex = LocalExplorer.from_edgelist(g)
    padded, _ = ex.extract(int(planted[0]))
    for f in ("src", "dst", "weight", "mask"):
        t = getattr(padded, f)
        assert t.device.type == "cpu"
        assert isinstance(t.numpy(), np.ndarray) and t.is_contiguous()


# ---------------------------------------------------------------------------
# api lowering: Problem(substrate='local')
# ---------------------------------------------------------------------------


def test_resolve_forces_exact_backend_and_no_compaction():
    r = PROB_LOCAL.resolve(1000)
    assert (r.substrate, r.backend, r.compaction) == ("local", "exact", "off")
    assert dataclasses.asdict(r) == dataclasses.asdict(REF_PROB_LOCAL.resolve(1000))


@pytest.mark.parametrize("kw", [
    dict(objective="directed"), dict(backend="sketch"), dict(backend="pallas"),
    dict(stream_mode="turnstile"),
])
def test_problem_validation_matrix(kw):
    with pytest.raises(ValueError):
        dataclasses.replace(REF_PROB_LOCAL, **kw).resolve(10)
    with pytest.raises(ValueError):
        dataclasses.replace(PROB_LOCAL, **kw).resolve(10)


@pytest.mark.parametrize("kw", [dict(local_budget=0), dict(local_rounds=0),
                                dict(local_alpha=-1.0)])
def test_problem_knob_validation(kw):
    with pytest.raises(ValueError):
        dataclasses.replace(REF_PROB_LOCAL, **kw)
    with pytest.raises(ValueError):
        dataclasses.replace(PROB_LOCAL, **kw)


def test_solve_validation_matrix():
    """The reference's cases the port has (it takes no ``mesh`` and no
    ``degree_fn``), and ``seed=`` refused with a turnstile stream mode."""
    ref_g, g, _ = _planted(n=60, k=8)
    with pytest.raises(ValueError, match="seed"):
        api.solve(g, PROB_LOCAL)  # missing seed
    with pytest.raises(ValueError, match="per-seed"):
        api.solve(g, PROB, seed=3)  # seed on a whole-graph substrate
    turnstile = api.Problem.undirected(stream_mode="turnstile")
    with pytest.raises(ValueError, match="per-seed"):
        api.solve(g, turnstile, seed=3)
    with pytest.raises(ValueError, match="per-seed"):
        ref_api.solve(ref_g, ref_api.Problem.undirected(stream_mode="turnstile"), seed=3)
    with pytest.raises(ValueError, match="seed="):
        api.solve(g, PROB_LOCAL, seed=60)
    with pytest.raises(TypeError, match="seed"):
        api.solve(g, PROB_LOCAL, seed=2.5)


def _solve_both(ref_g, g, seed, **kw):
    want = ref_api.Solver().solve(ref_g, dataclasses.replace(REF_PROB_LOCAL, **kw), seed=seed)
    got = api.Solver().solve(g, dataclasses.replace(PROB_LOCAL, **kw), seed=seed)
    for f in OUTCOME:
        a, b = getattr(got, f), getattr(want, f)
        assert a.device == g.device, f
        assert _bits(a) == np.asarray(b).tobytes(), f
    assert got.passes == int(want.passes)
    prov, ref_prov = dataclasses.asdict(got.provenance), dataclasses.asdict(want.provenance)
    for k in ("objective", "policy", "backend", "substrate", "n_nodes", "max_passes",
              "compaction"):
        assert prov[k] == ref_prov[k], k
    loc, ref_loc = got.extras["local"], want.extras["local"]
    assert sorted(loc) == sorted(ref_loc)
    for k, v in ref_loc.items():
        if k == "candidates":
            np.testing.assert_array_equal(loc[k], v)
        else:
            assert loc[k] == v and type(loc[k]) is type(v), k
    return got


@pytest.mark.parametrize("kw", [{}, dict(local_budget=64), dict(local_rounds=2),
                                dict(local_alpha=0.5), dict(track_history=True)])
def test_solve_local_matches_reference(kw):
    ref_g, g, planted = _planted()
    for s in (int(planted[0]), 0, 17, 399):
        _solve_both(ref_g, g, s, **kw)


def test_solve_local_integer_weights_match_reference():
    rng = np.random.default_rng(3)
    ref_g, _, planted = _planted()
    w = rng.integers(1, 4, ref_g.n_edges_padded).astype(np.float32)
    ref_g = ref_from_numpy(np.asarray(ref_g.src), np.asarray(ref_g.dst), ref_g.n_nodes, weight=w)
    for s in (int(planted[0]), 5):
        _solve_both(ref_g, _port(ref_g), s)


def test_solve_local_provenance_extras_and_guarantee():
    ref_g, g, planted = _planted()
    s = int(planted[0])
    res = _solve_both(ref_g, g, s)
    assert res.provenance.substrate == "local"
    info = res.extras["local"]
    assert info["seed"] == s and s in info["candidates"]
    assert info["n_candidates"] == len(info["candidates"])
    assert info["nodes_touched"] >= info["n_candidates"]
    nodes = res.nodes()
    assert set(nodes.tolist()) <= set(info["candidates"].tolist())
    assert int(res.best_size) == len(nodes)
    ref_small, _, sp = _planted(n=18, k=6, seed=3)
    _, rho_star = densest_subgraph_brute(ref_small)
    r2 = _solve_both(ref_small, _port(ref_small), int(sp[0]))
    assert float(r2.best_density) <= rho_star + 1e-5


def test_local_queries_share_one_bucket():
    """The reference's no-retrace test: two seeds land in one pow2 bucket
    there (one cached program); the port lands them in the same bucket."""
    ref_g, g, planted = _planted()
    r1 = _solve_both(ref_g, g, int(planted[0]))
    r2 = _solve_both(ref_g, g, int(planted[1]))
    assert r1.extras["local"]["bucket"] == r2.extras["local"]["bucket"]
