"""Port parity: the §5.1 Count-Sketch backend (``repro_torch.core.countsketch``)
against ``repro.core.countsketch``.

* The hash parameters are equal arrays (one ``default_rng`` stream).
* ``query_degrees`` is bitwise equal, the median of an even number of
  tables included (the mean of the two middle values, signed zeros kept
  in the reference's stable order).
* ``run_peel`` with ``SketchBackend`` and ``solve(backend='sketch')`` are
  bitwise equal to the reference on unit weights.
* The reference's own Count-Sketch tests (tests/test_countsketch.py) hold
  for the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as ref_api
from repro.core import countsketch as ref_cs
from repro.core.density import alive_edge_weight as ref_alive_edge_weight
from repro.core.engine import UndirectedThreshold as RefUndirected
from repro.core.engine import run_peel as ref_run_peel
from repro.graph.generators import chung_lu_power_law, erdos_renyi, planted_dense_subgraph
from repro.kernels.l0_sampler import ops as ref_l0
from repro_torch.core import api, countsketch
from repro_torch.core.density import alive_edge_weight
from repro_torch.core.engine import ExactBackend, FnBackend, UndirectedThreshold, run_peel
from repro_torch.graph.edgelist import from_reference
from repro_torch.kernels.l0_sampler import ops as l0


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _bits(x):
    return x.numpy().tobytes() if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()


FIELDS = ("best_alive", "best_density", "best_size", "alive", "history_n", "history_m",
          "history_rho")


@pytest.mark.parametrize("t,b,seed", [(5, 8192, 0), (4, 1 << 12, 1), (1, 128, 7), (8, 32768, 3)])
def test_sketch_params_equal_reference(t, b, seed):
    p, rp = countsketch.make_sketch_params(t, b, seed), ref_cs.make_sketch_params(t, b, seed)
    for f in ("a_h", "c_h", "a_g", "c_g"):
        got, want = getattr(p, f), np.asarray(getattr(rp, f))
        assert got.dtype == np.uint32 and np.array_equal(got, want), f
    assert (p.n_tables, p.n_buckets) == (rp.n_tables, rp.n_buckets)
    assert (p.a_h % 2 == 1).all() and (p.a_g % 2 == 1).all()


@pytest.mark.parametrize("L,C,d,seed", [(32, 1 << 14, 3, 0), (8, 256, 3, 4), (1, 1000, 5, 9)])
def test_l0_params_equal_reference(L, C, d, seed):
    p, rp = l0.make_l0_params(L, C, d, seed), ref_l0.make_l0_params(L, C, d, seed)
    for f in ("a_lvl", "c_lvl", "a_fp", "c_fp", "a_cell", "c_cell"):
        got, want = getattr(p, f), np.asarray(getattr(rp, f))
        assert got.dtype == np.uint32 and np.array_equal(got, want), f
    assert l0.l0_sketch_shape(p) == ref_l0.l0_sketch_shape(rp) == (L, d, C, 4)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6])
def test_query_degrees_bitwise(t):
    edges = chung_lu_power_law(1500, avg_deg=6, seed=t)
    rp = ref_cs.make_sketch_params(t, 256, seed=t)
    p = countsketch.make_sketch_params(t, 256, seed=t)
    w = ref_alive_edge_weight(edges, jnp.ones(edges.n_nodes, bool))
    want_c = ref_cs.sketch_degrees_from_edges(rp, edges, w)
    want = ref_cs.query_degrees(rp, want_c, jnp.arange(edges.n_nodes))
    e = _port(edges)
    got_c = countsketch.sketch_degrees_from_edges(
        p, e, alive_edge_weight(e, torch.ones(e.n_nodes, dtype=torch.bool)))
    assert _bits(got_c) == _bits(want_c)
    got = countsketch.query_degrees(p, got_c, torch.arange(e.n_nodes, dtype=torch.int32))
    assert _bits(got) == _bits(want)
    # The backend's cached node index gives the same bits.
    deg, total = countsketch.SketchBackend(p).undirected(
        e, alive_edge_weight(e, torch.ones(e.n_nodes, dtype=torch.bool)))
    assert _bits(deg) == _bits(want) and float(total) == float(jnp.sum(w))


@pytest.mark.parametrize("t", [4, 5])
def test_median_keeps_signed_zeros_like_the_reference(t):
    """A stable sort, -0.0 == 0.0: the middle value's sign is that of the
    equal element that sorts there first, as in XLA's sort."""
    rng = np.random.default_rng(t)
    est = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, 2.5], np.float32), size=(t, 4000))
    want = np.asarray(jnp.median(jnp.asarray(est), axis=0))
    got = countsketch.median_over_tables(torch.from_numpy(est)).numpy()
    assert got.tobytes() == want.tobytes()


GRAPHS = [
    ("er", lambda: erdos_renyi(180, avg_deg=8, seed=0)),
    ("planted", lambda: planted_dense_subgraph(250, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]),
]


@pytest.mark.parametrize("graph", [g for g, _ in GRAPHS])
@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_run_peel_with_sketch_backend_bitwise(graph, eps):
    edges = dict(GRAPHS)[graph]()
    mp = 64
    rp = ref_cs.make_sketch_params(5, 1 << 9, seed=2)
    want = ref_run_peel(edges, RefUndirected(eps), ref_cs.SketchBackend(rp), mp,
                        track_history=True)
    p = countsketch.make_sketch_params(5, 1 << 9, seed=2)
    got = run_peel(_port(edges), UndirectedThreshold(eps), countsketch.SketchBackend(p), mp,
                   track_history=True)
    for f in FIELDS:
        assert _bits(getattr(got, f)) == _bits(getattr(want, f)), f
    assert got.passes == int(want.passes)
    # The degree_fn hook over the same sketch runs the same peel.
    hooked = run_peel(_port(edges), UndirectedThreshold(eps),
                      FnBackend(countsketch.sketched_degree_fn(p)), mp, track_history=True)
    for f in FIELDS:
        assert _bits(getattr(hooked, f)) == _bits(getattr(got, f)), f


def test_densest_subgraph_sketched_equals_reference():
    edges, _ = planted_dense_subgraph(1500, avg_deg=4, k=40, p_dense=0.8, seed=4)
    want = ref_cs.densest_subgraph_sketched(edges, eps=0.5, t=5, b=1 << 12, seed=0)
    got = countsketch.densest_subgraph_sketched(_port(edges), eps=0.5, t=5, b=1 << 12, seed=0)
    for f in FIELDS:
        assert _bits(getattr(got, f)) == _bits(getattr(want, f)), f
    assert got.provenance.backend == "sketch" and got.provenance.compaction == "off"


def test_auto_resolves_to_sketch_above_one_million_nodes():
    """``backend='auto'`` (asked for: the default backend is 'exact' in both
    packages) picks the sketch, ladder off, above 1M nodes."""
    for mod in (api, ref_api):
        assert mod.Problem().backend == "exact"
        p = mod.Problem.undirected(backend="auto").resolve(1_100_000)
        assert (p.backend, p.compaction) == ("sketch", "off")
        q = mod.Problem.undirected(backend="auto").resolve(1_000_000)
        assert (q.backend, q.compaction) == ("exact", "geometric")
    assert dataclasses.asdict(api.Problem.undirected(backend="auto").resolve(1_100_000)) == (
        dataclasses.asdict(ref_api.Problem.undirected(backend="auto").resolve(1_100_000)))


def test_auto_above_threshold_solves_through_the_sketch(monkeypatch):
    """With the threshold lowered on both packages, 'auto' picks the sketch
    and the answers are equal."""
    monkeypatch.setattr(ref_api, "_AUTO_SKETCH_NODES", 100)
    monkeypatch.setattr(api, "_AUTO_SKETCH_NODES", 100)
    edges = erdos_renyi(600, avg_deg=10, seed=11)
    kw = dict(backend="auto", track_history=True)
    want = ref_api.Solver().solve(edges, ref_api.Problem.undirected(**kw))
    got = api.solve(_port(edges), api.Problem.undirected(**kw))
    assert got.provenance.backend == want.provenance.backend == "sketch"
    for f in FIELDS:
        assert _bits(getattr(got, f)) == _bits(getattr(want, f)), f


def test_directed_sketch_waits_for_the_directed_objective():
    """The directed objective has arrived: ``SketchBackend.directed`` keeps
    separate out and in tables (one K2 launch each on the card) and its
    out-degree, in-degree and total are bitwise the reference's, on a
    directed graph with part of S and T dead."""
    from repro.graph.generators import directed_planted

    edges, _, _ = directed_planted(400, avg_deg=4, ks=20, kt=15, p_dense=0.6, seed=3)
    alive = np.random.default_rng(5).random(edges.n_nodes) < 0.8
    t_alive = np.random.default_rng(6).random(edges.n_nodes) < 0.7
    ok = np.asarray(edges.mask) & alive[np.asarray(edges.src)] & t_alive[np.asarray(edges.dst)]
    w = np.where(ok, np.asarray(edges.weight), np.float32(0))
    for t, b, seed in [(5, 1 << 9, 2), (4, 256, 1)]:
        rp = ref_cs.make_sketch_params(t, b, seed=seed)
        want = ref_cs.SketchBackend(rp).directed(edges, jnp.asarray(w))
        p = countsketch.make_sketch_params(t, b, seed=seed)
        got = countsketch.SketchBackend(p).directed(_port(edges), torch.from_numpy(w))
        for g, x in zip(got, want):
            assert _bits(g) == _bits(x)
        # The two tables are the reference's counters of each endpoint alone.
        e = _port(edges)
        for ids, ref_ids in ((e.src, edges.src), (e.dst, edges.dst)):
            got_c = countsketch.sketch_endpoint_counters(p, ids, torch.from_numpy(w))
            assert _bits(got_c) == _bits(
                ref_cs.sketch_endpoint_counters(rp, ref_ids, jnp.asarray(w)))


# -- the reference's Count-Sketch tests (tests/test_countsketch.py), on the port


def _exact_degrees_np(edges):
    mask = edges.mask.numpy()
    deg = np.zeros(edges.n_nodes)
    np.add.at(deg, edges.src.numpy()[mask], 1)
    np.add.at(deg, edges.dst.numpy()[mask], 1)
    return deg


def _estimate(edges, p):
    w = alive_edge_weight(edges, torch.ones(edges.n_nodes, dtype=torch.bool))
    counters = countsketch.sketch_degrees_from_edges(p, edges, w)
    return countsketch.query_degrees(
        p, counters, torch.arange(edges.n_nodes, dtype=torch.int32)).numpy()


def test_sketch_accurate_on_heavy_nodes():
    edges = _port(chung_lu_power_law(2000, avg_deg=10, seed=0))
    deg = _exact_degrees_np(edges)
    est = _estimate(edges, countsketch.make_sketch_params(t=5, b=1 << 12, seed=1))
    heavy = deg >= np.quantile(deg, 0.99)
    rel_err = np.abs(est[heavy] - deg[heavy]) / np.maximum(deg[heavy], 1)
    assert np.median(rel_err) < 0.15


def test_sketch_error_decreases_with_buckets():
    edges = _port(chung_lu_power_law(2000, avg_deg=10, seed=0))
    deg = _exact_degrees_np(edges)
    errs = [np.mean(np.abs(_estimate(edges, countsketch.make_sketch_params(5, b, seed=2)) - deg))
            for b in (1 << 8, 1 << 10, 1 << 13)]
    assert errs[2] < errs[1] < errs[0]


def test_sketched_peeling_close_to_exact():
    edges = _port(planted_dense_subgraph(1500, avg_deg=4, k=40, p_dense=0.8, seed=4)[0])
    exact = float(run_peel(edges, UndirectedThreshold(0.5), ExactBackend(), 64).best_density)
    sk = float(countsketch.densest_subgraph_sketched(edges, eps=0.5, t=5, b=1 << 12).best_density)
    assert 0.75 * exact <= sk <= 1.25 * exact


def test_sketch_memory_is_sublinear():
    p = countsketch.make_sketch_params(t=5, b=1 << 10)
    assert p.n_tables * p.n_buckets < 100_000 // 2
