"""Port parity: Algorithms 2 and 3 (``AtLeastKFraction``, ``DirectedST``)
against the reference, in the engine and through the front door.

Unit weights keep every degree and total integer-valued, so the port and
``repro`` must agree bitwise on sets, sizes, passes, final bitmaps and the
per-pass |S| and |E(S)| histories.  One exception, in the reference's
arithmetic: XLA's CPU code lowers the directed density ``total /
sqrt(|S|·|T|)`` to ``total * rsqrt(|S|·|T|)`` with an approximate rsqrt
(within 1 ulp of the exact value, not always the correctly rounded one),
while the port divides in IEEE f32.  Directed densities (and their
``history_rho``) are therefore held to 1 ulp; every other field stays
bitwise.

Also the mirrors of tests/test_engine.py's at_least_k and directed cells,
tests/test_api.py's solve and compaction cells, tests/test_core_topk.py
and tests/test_core_directed.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as ref_api
from repro.core import countsketch as ref_cs
from repro.core import engine as ref_engine
from repro.core import peel_directed as ref_pd
from repro.graph.generators import directed_planted, erdos_renyi, planted_dense_subgraph
from repro.kernels.peel_degree import ops as ref_ops
import repro_torch.core.api as api
from repro_torch.core import countsketch, engine
from repro_torch.core import exact as port_exact
from repro_torch.core import peel_directed, peel_topk
from repro_torch.core.peel import densest_subgraph
from repro_torch.graph import generators as port_gen
from repro_torch.graph.edgelist import from_numpy, from_reference
from repro_torch.kernels.peel_degree import ops


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    a, b = _np(want), _np(got)
    assert b.shape == a.shape, (b.shape, a.shape)
    assert b.tobytes() == a.astype(b.dtype).tobytes(), (b, a)


def _ulps(got, want) -> int:
    a = np.asarray(_np(want), np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(_np(got), np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


def _same_outcome(got, want, *, directed=False, history=True):
    """Bitwise, except the directed density: within 1 ulp (see above)."""
    for f in ("best_alive", "best_t", "best_size", "alive", "t_alive"):
        _same(getattr(got, f), getattr(want, f))
    assert got.passes == int(want.passes)
    fields = ["best_density"] + (["history_rho"] if history else [])
    for f in fields:
        if directed:
            assert _ulps(getattr(got, f), getattr(want, f)) <= 1, f
        else:
            _same(getattr(got, f), getattr(want, f))
    if history:
        _same(got.history_n, want.history_n)
        _same(got.history_m, want.history_m)


def _planted():
    return planted_dense_subgraph(250, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]


def _dir():
    return directed_planted(200, avg_deg=3, ks=15, kt=12, p_dense=0.9, seed=5)[0]


def _backends(name, edges):
    """(reference backend, port backend) of one cell."""
    if name == "exact":
        return ref_engine.ExactBackend(), engine.ExactBackend()
    if name == "pallas":
        ref = ref_ops.degree_backend_from_tiling(
            ref_ops.tiling_for_edges(edges, tile_size=128, block=128), use_pallas=False)
        return ref, ops.degree_backend_from_tiling(ops.tiling_for_edges(_port(edges), 128))
    rp = ref_cs.make_sketch_params(5, 1 << 9, seed=2)
    return ref_cs.SketchBackend(rp), countsketch.SketchBackend(
        countsketch.make_sketch_params(5, 1 << 9, seed=2))


# -- the engine: tests/test_engine.py's at_least_k and directed cells ---------


@pytest.mark.parametrize("backend", ["exact", "pallas", "sketch"])
@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
def test_matrix_at_least_k(backend, variant):
    edges = _planted()
    k, eps, mp = 30, 0.5, 64
    fb = variant == "floor_fallback"
    ref_be, port_be = _backends(backend, edges)
    want = jax.jit(lambda e: ref_engine.run_peel(
        e, ref_engine.AtLeastKFraction(k=k, eps=eps, min_deg_fallback=fb, ceil_count=not fb),
        ref_be, mp, track_history=True))(edges)
    got = engine.run_peel(
        _port(edges),
        engine.AtLeastKFraction(k=k, eps=eps, min_deg_fallback=fb, ceil_count=not fb),
        port_be, mp, track_history=True)
    _same_outcome(got, want)
    assert int(got.best_size) >= k


@pytest.mark.parametrize("backend", ["exact", "sketch"])
@pytest.mark.parametrize("c", [0.5, 1.0, 2.0])
def test_matrix_directed_st(backend, c):
    edges = _dir()
    eps, mp = 0.5, 64
    ref_be, port_be = _backends(backend, edges)
    want = jax.jit(lambda e: ref_engine.run_peel(
        e, ref_engine.DirectedST(eps=eps, c=jnp.float32(c)), ref_be, mp,
        track_history=True))(edges)
    got = engine.run_peel(
        _port(edges), engine.DirectedST(eps=eps, c=torch.tensor(c, dtype=torch.float32)),
        port_be, mp, track_history=True)
    _same_outcome(got, want, directed=True)
    assert got.best_t.shape == (edges.n_nodes,)


def test_sketch_backend_directed_runs_and_is_sane():
    """DirectedST × SketchBackend: per-endpoint tables give a dense pair
    close to the exact answer on a strongly planted block, and the run is
    the reference's."""
    edges, _, _ = directed_planted(300, avg_deg=3, ks=20, kt=15, p_dense=0.95, seed=2)
    rp = ref_cs.make_sketch_params(t=5, b=1 << 13, seed=3)
    p = countsketch.make_sketch_params(t=5, b=1 << 13, seed=3)
    mp, pe = 64, _port(edges)
    policy = engine.DirectedST(eps=0.5, c=torch.tensor(1.0))
    sk = engine.run_peel(pe, policy, countsketch.SketchBackend(p), mp)
    ex = engine.run_peel(pe, policy, engine.ExactBackend(), mp)
    assert float(sk.best_density) >= 0.5 * float(ex.best_density)
    want = jax.jit(lambda e: ref_engine.run_peel(
        e, ref_engine.DirectedST(eps=0.5, c=jnp.float32(1.0)), ref_cs.SketchBackend(rp),
        mp))(edges)
    _same_outcome(sk, want, directed=True, history=False)


def test_directed_undirected_placeholders():
    """An undirected run carries empty ``bool[0]`` T-side arrays, as the
    reference does; a directed run starts T at all nodes."""
    edges = _planted()
    got = engine.run_peel(_port(edges), engine.UndirectedThreshold(0.5),
                          engine.ExactBackend(), 8)
    assert got.best_t.shape == got.t_alive.shape == (0,)
    assert got.best_t.dtype == torch.bool
    assert got.best_s is got.best_alive


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
@pytest.mark.parametrize("eps", [0.5, 0.25, 1.0])
def test_at_least_k_ties_equal_and_zero_degrees(variant, eps):
    """The rank on (degree, id) with equal degrees, zero degrees, signed
    zeros and dead nodes: the port's removal bitmap is the reference's,
    alone and as lanes of a sweep (eps as an f32 lane tensor)."""
    fb = variant == "floor_fallback"
    deg = np.array([1, -0.0, 0.0, 2, -0.0, 0.0, 1, 3, 0.0, 5, 2, 2, 1, 0.0, -0.0, 1],
                   np.float32)
    alive = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1], bool)
    n_s = int(alive.sum())
    total = np.float32(6.0)
    rho = np.float32(total / n_s)
    ref_pol = ref_engine.AtLeastKFraction(k=3, eps=eps, min_deg_fallback=fb, ceil_count=not fb)
    ref_stats = ref_engine.PassStats(rho=jnp.float32(rho), total=jnp.float32(total),
                                     n_s=jnp.int32(n_s), n_t=jnp.int32(n_s))
    want, _ = ref_pol.removal(jnp.asarray(alive), jnp.asarray(alive), jnp.asarray(deg),
                              jnp.asarray(deg), ref_stats)
    pol = engine.AtLeastKFraction(k=3, eps=eps, min_deg_fallback=fb, ceil_count=not fb)
    stats = engine.PassStats(rho=torch.tensor(rho), total=torch.tensor(total),
                             n_s=torch.tensor(n_s), n_t=torch.tensor(n_s))
    got, none = pol.removal(torch.from_numpy(alive), torch.from_numpy(alive),
                            torch.from_numpy(deg), torch.from_numpy(deg), stats)
    assert none is None
    _same(got, want)
    assert 0 < int(got.sum()) < n_s
    # Three lanes, the middle one this case; eps in f32 as a sweep has it.
    lanes = torch.tensor([0.25, eps, 1.0], dtype=torch.float32)
    pol_l = engine.AtLeastKFraction(k=3, eps=lanes, min_deg_fallback=fb, ceil_count=not fb)
    rep = lambda a: torch.from_numpy(np.stack([a] * 3))
    stats_l = engine.PassStats(rho=torch.tensor([rho] * 3), total=torch.tensor([total] * 3),
                               n_s=torch.tensor([n_s] * 3), n_t=torch.tensor([n_s] * 3))
    got_l, _ = pol_l.removal(rep(alive), rep(alive), rep(deg), rep(deg), stats_l)
    _same(got_l[1], want)


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
def test_at_least_k_ties_on_a_regular_graph(variant):
    """A 2-regular ring, a triangle and isolated nodes: every pass ranks
    ties, and the whole run is the reference's."""
    ring = np.arange(12)
    src = np.concatenate([ring, [12, 13, 14]])
    dst = np.concatenate([(ring + 1) % 12, [13, 14, 12]])
    from repro.graph import from_numpy as ref_from_numpy

    edges = ref_from_numpy(src, dst, 20)
    fb = variant == "floor_fallback"
    for k in (3, 9):
        want = jax.jit(lambda e: ref_engine.run_peel(
            e, ref_engine.AtLeastKFraction(k=k, eps=0.5, min_deg_fallback=fb,
                                           ceil_count=not fb),
            ref_engine.ExactBackend(), 32, track_history=True))(edges)
        got = engine.run_peel(
            _port(edges), engine.AtLeastKFraction(k=k, eps=0.5, min_deg_fallback=fb,
                                                  ceil_count=not fb),
            engine.ExactBackend(), 32, track_history=True)
        _same_outcome(got, want)


def test_fn_backend_has_no_directed_rule():
    with pytest.raises(NotImplementedError):
        engine.FnBackend(lambda e, w: w).directed(None, None)


# -- the front door: tests/test_api.py's cells --------------------------------


FIELDS = ("best_alive", "best_t", "best_size", "alive", "t_alive", "history_n", "history_m")


def _same_result(got, want, directed=False):
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f))
    assert got.passes == int(want.passes)
    for f in ("best_density", "history_rho"):
        if directed:
            assert _ulps(getattr(got, f), getattr(want, f)) <= 1, f
        else:
            _same(getattr(got, f), getattr(want, f))
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(want.provenance, cache_hit=False))


def _solve_both(edges, **kw):
    want = ref_api.Solver().solve(edges, ref_api.Problem(**kw))
    got = api.solve(_port(edges), api.Problem(**kw))
    return got, want


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
@pytest.mark.parametrize("compaction", ["off", "geometric", "twophase"])
def test_solve_at_least_k_matches_reference(variant, compaction):
    fb = variant == "floor_fallback"
    got, want = _solve_both(
        _planted(), objective="at_least_k", k=30, eps=0.5, min_deg_fallback=fb,
        ceil_count=not fb, compaction=compaction, track_history=True, twophase_passes=2)
    _same_result(got, want)
    assert got.provenance.policy == "at_least_k_fraction"


@pytest.mark.parametrize("backend", ["pallas", "sketch"])
def test_solve_at_least_k_other_backends_match_reference(backend):
    kw = dict(objective="at_least_k", k=30, eps=0.5, backend=backend, track_history=True,
              tile_size=128, tile_block=128, sketch_buckets=1 << 9)
    got, want = _solve_both(_planted(), **kw)
    _same_result(got, want)
    if backend == "pallas":  # K1's sums are exact: the exact backend's answer
        exact, _ = _solve_both(_planted(), **{**kw, "backend": "exact"})
        for f in FIELDS + ("best_density", "history_rho"):
            _same(getattr(got, f), getattr(exact, f))


@pytest.mark.parametrize("c", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("compaction", ["off", "geometric", "twophase"])
def test_solve_directed_matches_reference(c, compaction):
    got, want = _solve_both(_dir(), objective="directed", c=c, eps=0.5,
                            compaction=compaction, track_history=True, twophase_passes=2)
    _same_result(got, want, directed=True)
    assert got.provenance.policy == "directed_st"


def test_solve_directed_sketch_matches_reference():
    got, want = _solve_both(_dir(), objective="directed", c=1.0, eps=0.5, backend="sketch",
                            sketch_buckets=1 << 9, track_history=True)
    _same_result(got, want, directed=True)


@pytest.mark.parametrize("compaction", ["off", "geometric"])
def test_solve_directed_grid_matches_reference(compaction):
    got, want = _solve_both(_dir(), objective="directed", eps=0.5, compaction=compaction)
    _same_result(got, want, directed=True)
    ex, rex = got.extras, want.extras
    assert ex["best_c"] == rex["best_c"]
    np.testing.assert_array_equal(ex["c_grid"], rex["c_grid"])
    assert ex["c_grid"].dtype == rex["c_grid"].dtype == np.float32
    np.testing.assert_array_equal(ex["c_passes"], rex["c_passes"])
    assert _ulps(np.float32(ex["c_density"]), np.float32(rex["c_density"])) <= 1
    if compaction == "geometric":
        strip = lambda segs: [{k: v for k, v in s.items() if k != "cache_hit"} for s in segs]
        assert strip(ex["compaction"]["segments"]) == strip(rex["compaction"]["segments"])


@pytest.mark.parametrize("objective", ["at_least_k", "directed"])
def test_ladder_of_many_rungs_matches_reference(monkeypatch, objective):
    """Small floors force a ladder of several rungs; the directed one
    renumbers S and T together (survivors are S | T, each keeps its bits),
    and the rungs, the answer and the history are the reference's."""
    for mod in (ref_api, api):
        monkeypatch.setattr(mod, "_COMPACT_MIN_EDGES", 16)
        monkeypatch.setattr(mod, "_COMPACT_MIN_NODES", 16)
    if objective == "directed":
        edges = directed_planted(600, avg_deg=5, ks=30, kt=10, p_dense=0.7, seed=9)[0]
        kw = dict(objective="directed", c=2.0, eps=0.5)
    else:
        edges = erdos_renyi(600, avg_deg=10, seed=11)
        kw = dict(objective="at_least_k", k=40, eps=0.5)
    got, want = _solve_both(edges, compaction="geometric", track_history=True, **kw)
    _same_result(got, want, directed=objective == "directed")
    segs = got.extras["compaction"]["segments"]
    strip = lambda s: [{k: v for k, v in x.items() if k != "cache_hit"} for x in s]
    assert strip(segs) == strip(want.extras["compaction"]["segments"])
    assert len(segs) >= 3
    off = api.solve(_port(edges), api.Problem(compaction="off", track_history=True, **kw))
    for f in FIELDS + ("best_density", "history_rho"):
        _same(getattr(got, f), getattr(off, f))


@pytest.mark.parametrize("mode", ["geometric", "twophase"])
def test_compaction_zero_pass_runs_match_off(mode):
    """k > n runs no pass: every mode returns the full initial set."""
    edges = _port(erdos_renyi(50, avg_deg=4, seed=0))
    off = api.solve(edges, api.Problem.at_least_k(k=60, eps=0.5, compaction="off"))
    on = api.solve(edges, api.Problem.at_least_k(k=60, eps=0.5, compaction=mode))
    assert off.passes == on.passes == 0
    for f in FIELDS + ("best_density",):
        _same(getattr(on, f), getattr(off, f))
    assert bool(on.best_alive.all())


def test_result_helpers_match_reference():
    got, want = _solve_both(_dir(), objective="directed", c=1.0, eps=0.5)
    np.testing.assert_array_equal(got.nodes(), want.nodes())
    np.testing.assert_array_equal(got.t_nodes(), want.t_nodes())
    assert got.best_s is got.best_alive and got.mask is got.best_alive
    assert [f.name for f in dataclasses.fields(api.DenseSubgraphResult)] == [
        f.name for f in dataclasses.fields(ref_api.DenseSubgraphResult)]


def test_run_cell_matches_reference():
    edges = _dir()
    prob = dict(objective="directed", c=0.5, eps=0.5, max_passes=40)
    want = ref_api.run_cell(edges, ref_api.Problem(**prob))
    got = api.run_cell(_port(edges), api.Problem(**prob))
    _same_outcome(got, want, directed=True, history=False)
    with pytest.raises(ValueError):
        api.run_cell(_port(edges), api.Problem.directed(c=None))


# -- tests/test_core_topk.py ---------------------------------------------------


@pytest.mark.parametrize("k", [5, 20, 60])
def test_size_constraint_respected(k):
    edges = erdos_renyi(150, avg_deg=8, seed=0)
    res = peel_topk.densest_subgraph_at_least_k(_port(edges), k=k, eps=0.5)
    assert int(res.best_size) >= k
    assert int(res.best_alive.sum()) == int(res.best_size)
    from repro.core import densest_subgraph_at_least_k as ref_topk

    _same_outcome(res, ref_topk(edges, k=k, eps=0.5), history=False)


def test_matches_unconstrained_when_k_small():
    edges = _port(erdos_renyi(150, avg_deg=10, seed=1))
    nodes_star, rho_star = port_exact.densest_subgraph_exact(edges)
    k = max(2, len(nodes_star) // 2)
    res = peel_topk.densest_subgraph_at_least_k(edges, k=k, eps=0.25)
    assert float(res.best_density) >= rho_star / (2 * 1.25) - 1e-6


def test_theorem9_bound_when_k_large():
    edges = _port(planted_dense_subgraph(300, avg_deg=4, k=25, p_dense=0.9, seed=2)[0])
    res = peel_topk.densest_subgraph_at_least_k(edges, k=100, eps=0.5)
    assert int(res.best_size) >= 100
    _, rho_star = port_exact.densest_subgraph_exact(edges)
    assert 0.0 < float(res.best_density) <= rho_star + 1e-5


def test_fractional_removal_makes_more_passes():
    edges = _port(erdos_renyi(400, avg_deg=8, seed=3))
    p1 = densest_subgraph(edges, eps=0.5).passes
    p2 = peel_topk.densest_subgraph_at_least_k(edges, k=2, eps=0.5).passes
    assert p2 >= p1


# -- tests/test_core_directed.py ---------------------------------------------


def test_directed_brute_comparison_tiny():
    rng = np.random.default_rng(0)
    for _ in range(4):
        n = 7
        src = rng.integers(0, n, 16)
        dst = rng.integers(0, n, 16)
        keep = src != dst
        edges = from_numpy(src[keep], dst[keep], n, directed=True, device="cpu")
        _, _, rho_star = port_exact.densest_directed_brute(edges)
        res, _, _, _ = peel_directed.densest_directed_search(edges, eps=0.05, delta=1.3)
        assert float(res.best_density) >= rho_star / (2 * 1.05 * 1.3) - 1e-6
        assert float(res.best_density) <= rho_star + 1e-6


def test_planted_directed_block():
    edges, s_ids, t_ids = port_gen.directed_planted(
        300, avg_deg=3, ks=20, kt=15, p_dense=0.9, seed=1, device="cpu")
    res, best_c, rhos, passes = peel_directed.densest_directed_search(edges, eps=0.5)
    s_found = set(np.nonzero(res.best_s.numpy())[0].tolist())
    t_found = set(res.t_nodes().tolist())
    assert len(s_found & set(s_ids.tolist())) >= 0.7 * len(s_ids)
    assert len(t_found & set(t_ids.tolist())) >= 0.7 * len(t_ids)
    assert float(res.best_density) > 5.0
    ref, ref_c, ref_rhos, ref_passes = ref_pd.densest_directed_search(
        directed_planted(300, avg_deg=3, ks=20, kt=15, p_dense=0.9, seed=1)[0], eps=0.5)
    assert best_c == ref_c
    np.testing.assert_array_equal(passes, ref_passes)
    _same(res.best_alive, ref.best_alive)
    _same(res.best_t, ref.best_t)


def test_directed_pass_bound():
    edges = _port(erdos_renyi(500, avg_deg=6, seed=2, directed=True))
    r = peel_directed.densest_subgraph_directed(edges, c=1.0, eps=0.5)
    assert r.passes <= 2 * (math.ceil(math.log(500) / math.log(1.5)) + 4)


def test_c_grid_covers_range():
    grid = api.c_grid(1000, delta=2.0)
    assert grid.min() <= 1.0 / 1000 and grid.max() >= 1000
    assert np.allclose(grid[1:] / grid[:-1], 2.0, rtol=1e-5)
    for n, delta in [(1000, 2.0), (7, 1.3), (976_000, 2.0), (1, 2.0)]:
        got, want = api.c_grid(n, delta), ref_api.c_grid(n, delta)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_best_pair_density_matches_recomputation():
    edges = _port(directed_planted(200, avg_deg=3, ks=12, kt=12, p_dense=0.8, seed=5)[0])
    res = peel_directed.densest_subgraph_directed(edges, c=1.0, eps=0.5)
    s, t = res.best_s.numpy(), res.best_t.numpy()
    mask = edges.mask.numpy()
    m_in = np.sum(s[edges.src.numpy()[mask]] & t[edges.dst.numpy()[mask]])
    assert float(res.best_density) == pytest.approx(m_in / np.sqrt(s.sum() * t.sum()), rel=1e-5)
    # IEEE f32: the count over sqrt(|S|·|T|), rounded as the port rounds it.
    want = np.float32(m_in) / np.sqrt(np.float32(s.sum()) * np.float32(t.sum()))
    assert res.best_density.numpy().tobytes() == np.float32(want).tobytes()


def test_vmapped_c_search_matches_loop():
    edges = directed_planted(n=2000, avg_deg=5.0, ks=40, kt=16, p_dense=0.5, seed=4)[0]
    pe = _port(edges)
    best, best_c, rhos, passes = peel_directed.densest_directed_search(pe, eps=0.5)
    vc, vrho, vrhos, vpasses = peel_directed.densest_directed_search_vmapped(pe, eps=0.5)
    assert vrhos.tobytes() == np.float32(rhos).tobytes()  # lanes == the loop, bitwise
    assert vc == best_c and vrho == float(best.best_density)
    np.testing.assert_array_equal(vpasses, passes)
    rc, rrho, rrhos, rpasses = ref_pd.densest_directed_search_vmapped(edges, eps=0.5)
    assert vc == rc and _ulps(vrhos, rrhos) <= 1
    np.testing.assert_array_equal(vpasses, rpasses)


@pytest.mark.parametrize("hook", [False, True])
def test_densest_subgraph_wrapper_matches_reference(hook):
    """``core/peel.py``: Algorithm 1's wrapper, with and without a
    ``degree_fn`` hook (the sketch's), bitwise the reference's."""
    from repro.core.peel import densest_subgraph as ref_densest

    edges = _planted()
    kw_ref, kw = {}, {}
    if hook:
        kw_ref["degree_fn"] = ref_cs.sketched_degree_fn(ref_cs.make_sketch_params(5, 512, 1))
        kw["degree_fn"] = countsketch.sketched_degree_fn(countsketch.make_sketch_params(5, 512, 1))
    want = ref_densest(edges, eps=0.5, **kw_ref)
    got = densest_subgraph(_port(edges), eps=0.5, **kw)
    _same_outcome(got, want)
    assert got.provenance.compaction == want.provenance.compaction == "off"
    if hook:
        with pytest.raises(ValueError):
            densest_subgraph(_port(edges), compaction="geometric", **kw)
