"""Port parity: the batched sweep driver ``Solver.solve_batch`` (eps, c and
stacked-graph sweeps) against the reference's and against a loop of
standalone solves.

A sweep is one peel loop with a lane axis: every lane must be bitwise its
standalone ``solve`` (eps values exactly representable in float32), and
bitwise the reference's lane on unit weights (directed densities within
1 ulp of the reference's, whose CPU code multiplies by an approximate
rsqrt; see tests/test_torch_objectives.py).  The reference's
``test_solve_batch_is_one_program`` becomes the host-sync bound: one sync a
pass for all lanes, plus the final test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.api as ref_api
from repro.graph.edgelist import EdgeList as RefEdgeList
from repro.graph.generators import directed_planted, erdos_renyi, planted_dense_subgraph
import repro_torch.core.api as api
from repro_torch import hostsync
from repro_torch.graph.edgelist import from_reference
from repro_torch.kernels.count_sketch import ops as cs_ops
from repro_torch.kernels.peel_degree import ops as k1_ops


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
    assert b.tobytes() == a.astype(b.dtype).tobytes()


def _ulps(got, want) -> int:
    a = np.asarray(_np(want), np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(_np(got), np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


def _und():
    return planted_dense_subgraph(260, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]


def _dir():
    return directed_planted(200, avg_deg=3, ks=15, kt=12, p_dense=0.9, seed=5)[0]


LANE_FIELDS = ("best_alive", "best_t", "best_density", "best_size", "alive", "t_alive",
               "history_n", "history_m", "history_rho")


def _lane_is_standalone(sweep, i, single):
    """Lane ``i`` of a port sweep == a port standalone solve, bitwise."""
    for f in LANE_FIELDS:
        _same(getattr(sweep, f)[i], getattr(single, f))
    assert sweep.passes[i] == single.passes


def _same_as_reference(got, want, directed=False):
    for f in LANE_FIELDS:
        if directed and f in ("best_density", "history_rho"):
            assert _ulps(getattr(got, f), getattr(want, f)) <= 1, f
        else:
            _same(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(np.asarray(got.passes), np.asarray(want.passes))
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(want.provenance, cache_hit=False))


@pytest.mark.parametrize("backend", ["exact", "pallas", "sketch"])
def test_solve_batch_eps_matches_loop(backend):
    edges = _und()
    grid = [0.125, 0.25, 0.5, 1.0]  # f32-exact eps values
    kw = dict(max_passes=48, track_history=True, backend=backend, tile_size=128,
              tile_block=128, sketch_buckets=1 << 9)
    rb = api.solve_batch(_port(edges), api.Problem.undirected(**kw), eps=grid)
    assert rb.provenance.batch == "eps" and rb.provenance.compaction == "off"
    assert rb.best_alive.shape == (len(grid), edges.n_nodes)
    for i, e in enumerate(grid):
        ri = api.solve(_port(edges), api.Problem.undirected(eps=e, compaction="off", **kw))
        _lane_is_standalone(rb, i, ri)
    want = ref_api.Solver().solve_batch(edges, ref_api.Problem.undirected(**kw), eps=grid)
    _same_as_reference(rb, want)


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
def test_solve_batch_eps_at_least_k_matches_loop(variant):
    edges = _und()
    grid = [0.25, 0.5, 1.0]
    fb = variant == "floor_fallback"
    kw = dict(k=30, max_passes=48, min_deg_fallback=fb, ceil_count=not fb,
              track_history=True)
    rb = api.solve_batch(_port(edges), api.Problem.at_least_k(**kw), eps=grid)
    for i, e in enumerate(grid):
        ri = api.solve(_port(edges), api.Problem.at_least_k(eps=e, compaction="off", **kw))
        _lane_is_standalone(rb, i, ri)
    want = ref_api.Solver().solve_batch(edges, ref_api.Problem.at_least_k(**kw), eps=grid)
    _same_as_reference(rb, want)


@pytest.mark.parametrize("backend", ["exact", "sketch"])
def test_solve_batch_c_matches_loop(backend):
    edges = _dir()
    cs = [0.5, 1.0, 2.0, 4.0]
    kw = dict(eps=0.5, max_passes=48, backend=backend, sketch_buckets=1 << 9,
              track_history=True)
    rb = api.solve_batch(_port(edges), api.Problem.directed(**kw), c=cs)
    assert rb.provenance.batch == "c"
    for i, c in enumerate(cs):
        ri = api.solve(_port(edges), api.Problem.directed(c=c, compaction="off", **kw))
        _lane_is_standalone(rb, i, ri)
    want = ref_api.Solver().solve_batch(edges, ref_api.Problem.directed(**kw), c=cs)
    _same_as_reference(rb, want, directed=True)


def _two_graphs(directed=False):
    g1 = erdos_renyi(250, avg_deg=6, seed=4, directed=directed)
    perm = np.random.default_rng(1).permutation(g1.src.shape[0])
    g2 = RefEdgeList(src=g1.src[perm], dst=g1.dst[perm], weight=g1.weight[perm],
                     mask=g1.mask[perm], n_nodes=g1.n_nodes, directed=directed)
    g3 = erdos_renyi(250, avg_deg=6, seed=5, directed=directed)
    m = min(g1.src.shape[0], g3.src.shape[0])
    cut = lambda g: RefEdgeList(src=g.src[:m], dst=g.dst[:m], weight=g.weight[:m],
                                mask=g.mask[:m], n_nodes=g.n_nodes, directed=directed)
    return [cut(g1), cut(g2), cut(g3)]


@pytest.mark.parametrize("cell", ["undirected", "at_least_k", "directed", "sketch"])
def test_solve_batch_graphs_matches_loop(cell):
    graphs = _two_graphs(directed=cell == "directed")
    kw = dict(eps=0.5, max_passes=32, track_history=True)
    if cell == "at_least_k":
        kw["k"] = 20
    if cell == "directed":
        kw["c"] = 1.0
    if cell == "sketch":
        kw.update(backend="sketch", sketch_buckets=1 << 9)
    obj = "undirected" if cell == "sketch" else cell
    prob = api.Problem(objective=obj, **kw)
    rb = api.solve_batch([_port(g) for g in graphs], prob)
    assert rb.provenance.batch == "graphs"
    for i, g in enumerate(graphs):
        _lane_is_standalone(rb, i, api.solve(_port(g), dataclasses.replace(prob, compaction="off")))
    want = ref_api.Solver().solve_batch(graphs, ref_api.Problem(objective=obj, **kw))
    _same_as_reference(rb, want, directed=cell == "directed")


def test_solve_batch_accepts_prestacked_edgelist():
    graphs = [_port(g) for g in _two_graphs()]
    prob = api.Problem.undirected(eps=0.5, max_passes=32)
    rb = api.solve_batch(api.stack_graphs(graphs), prob)
    for i, g in enumerate(graphs):
        _same(rb.best_alive[i], api.solve(g, prob).best_alive)
    with pytest.raises(ValueError, match="same-shape"):
        api.stack_graphs([graphs[0], _port(erdos_renyi(100, avg_deg=3, seed=0))])


def test_solve_batch_host_syncs_one_a_pass():
    """All lanes share one continuation read a pass: the sweep makes the
    slowest lane's passes + 1 host syncs (the reference's one program)."""
    edges = _port(_und())
    hostsync.read.count = 0
    rb = api.solve_batch(edges, api.Problem.undirected(max_passes=32),
                         eps=[0.25, 0.5, 1.0, 2.0])
    assert hostsync.read.count == max(rb.passes) + 1
    assert len(set(rb.passes)) > 1  # lanes finish at different passes


def test_solve_batch_eps_keys_fixed_directed_c():
    edges = _dir()
    for c in (1.0, 8.0):
        prob = api.Problem.directed(c=c, max_passes=48)
        rb = api.solve_batch(_port(edges), prob, eps=[0.5])
        _lane_is_standalone(rb, 0, api.solve(_port(edges), dataclasses.replace(
            prob, eps=0.5, compaction="off")))
        want = ref_api.Solver().solve_batch(edges, ref_api.Problem.directed(c=c, max_passes=48),
                                            eps=[0.5])
        _same_as_reference(rb, want, directed=True)


def test_solve_batch_trip_bound_from_loosest_eps():
    edges = _und()
    prob = dict(objective="undirected")
    got = api.solve_batch(_port(edges), api.Problem(**prob), eps=[0.1, 1.0])
    want = ref_api.Solver().solve_batch(edges, ref_api.Problem(**prob), eps=[0.1, 1.0])
    assert got.provenance.max_passes == want.provenance.max_passes == (
        api.Problem(eps=0.1).resolved_max_passes(edges.n_nodes))
    _same_as_reference(got, want)


@pytest.mark.parametrize(
    "case",
    ["no_axis", "two_axes", "explicit_ladder", "turnstile", "stacked_pallas",
     "stacked_directed_grid", "directed_eps_without_c", "c_on_undirected", "mesh"],
)
def test_solve_batch_validation_matches_reference(case):
    """The reference's errors, word for word."""
    und, dire = _und(), _dir()
    graphs = _two_graphs()
    calls = {
        "no_axis": (und, dict(), {}),
        "two_axes": (dire, dict(objective="directed", c=1.0), dict(eps=[0.5], c=[1.0])),
        "explicit_ladder": (und, dict(max_passes=16, compaction="geometric"), dict(eps=[0.5])),
        "turnstile": (und, dict(stream_mode="turnstile"), dict(eps=[0.5])),
        "stacked_pallas": (graphs, dict(backend="pallas"), {}),
        "stacked_directed_grid": (_two_graphs(True), dict(objective="directed"), {}),
        "directed_eps_without_c": (dire, dict(objective="directed"), dict(eps=[0.5])),
        "c_on_undirected": (und, dict(), dict(c=[1.0])),
        "mesh": (und, dict(substrate="mesh"), dict(eps=[0.5])),
    }
    graph, pkw, kw = calls[case]
    with pytest.raises(ValueError) as ref_err:
        ref_api.Solver().solve_batch(graph, ref_api.Problem(**pkw), **kw)
    port_graph = [_port(g) for g in graph] if isinstance(graph, list) else _port(graph)
    with pytest.raises(ValueError) as err:
        api.solve_batch(port_graph, api.Problem(**pkw), **kw)
    assert str(err.value) == str(ref_err.value)


def test_solve_batch_auto_compaction_resolves_off():
    rb = api.solve_batch(_port(_und()), api.Problem.undirected(max_passes=16), eps=[0.5])
    assert rb.provenance.compaction == "off"
    with pytest.raises(TypeError):
        api.solve_batch("not a graph", api.Problem.undirected(), eps=[0.5])


def test_pallas_sweep_launches_k1_once_per_live_lane(monkeypatch):
    """The pallas backend's degree rule runs once per live lane a pass (the
    card launches K1 as many times): Σ lanes' passes in all."""
    calls = []
    real = k1_ops.tiled_degrees

    def counting(tiling, w_alive, *, n_nodes):
        calls.append(w_alive.shape)
        return real(tiling, w_alive, n_nodes=n_nodes)

    monkeypatch.setattr(k1_ops, "tiled_degrees", counting)
    edges = _port(_und())
    rb = api.solve_batch(edges, api.Problem.undirected(max_passes=32, backend="pallas",
                                                       tile_size=128),
                         eps=[0.25, 1.0, 2.0])
    assert len(calls) == sum(rb.passes) and len(set(rb.passes)) > 1
    assert all(s == (edges.n_edges_padded,) for s in calls)


def test_directed_sketch_sweep_two_tables_a_live_lane(monkeypatch):
    calls = []
    real = cs_ops.count_sketch_update

    def counting(ids, w, params):
        calls.append(ids.shape)
        return real(ids, w, params)

    monkeypatch.setattr(cs_ops, "count_sketch_update", counting)
    edges = _port(_dir())
    rb = api.solve_batch(edges, api.Problem.directed(backend="sketch", sketch_buckets=1 << 9,
                                                     max_passes=48), c=[0.25, 1.0, 4.0])
    assert len(calls) == 2 * sum(rb.passes)
    calls.clear()
    one = api.solve(edges, api.Problem.directed(c=1.0, backend="sketch",
                                                sketch_buckets=1 << 9, max_passes=48))
    assert len(calls) == 2 * one.passes
