"""Port parity: the front door (``repro_torch.core.api``) against
``repro.core.api``.

* ``Problem`` has the reference's fields under the same names and defaults.
* ``Problem.resolve`` raises ``ValueError`` exactly where the reference
  does and resolves to the same fields elsewhere.
* ``solve()`` is bitwise equal to the reference's for unit weights, for
  backend exact/pallas × compaction off/geometric/twophase, including the
  ladder's segment list (the undirected cells of tests/test_api.py's
  compaction matrix), for ``backend='sketch'`` and for a one-shot
  ``stream_mode='turnstile'`` solve.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.core.api as ref_api
import repro_torch.core.api as api
from repro.graph.generators import erdos_renyi, planted_dense_subgraph
from repro_torch.graph.edgelist import from_reference


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _bits(x):
    return x.numpy().tobytes() if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()


def test_problem_fields_and_defaults_match_reference():
    ref = [(f.name, f.default) for f in dataclasses.fields(ref_api.Problem)]
    got = [(f.name, f.default) for f in dataclasses.fields(api.Problem)]
    assert got == ref
    assert api.Problem() == api.Problem(**dataclasses.asdict(ref_api.Problem()))
    assert dataclasses.asdict(api.Problem.undirected(0.3, backend="pallas")) == (
        dataclasses.asdict(ref_api.Problem.undirected(0.3, backend="pallas"))
    )


@pytest.mark.parametrize("objective", ["undirected", "at_least_k", "directed"])
@pytest.mark.parametrize("stream_mode", ["insert", "turnstile"])
def test_resolve_validation_matrix_matches_reference(objective, stream_mode):
    grid = itertools.product(
        ["exact", "sketch", "pallas", "auto"],
        ["jit", "mesh", "streaming", "local", "auto"],
        ["off", "twophase", "geometric", "auto"],
        [None, "spill"],
        [100, 2_000_000],
    )
    k = 3 if objective == "at_least_k" else None
    for backend, substrate, compaction, spill, n in grid:
        kw = dict(objective=objective, k=k, backend=backend, substrate=substrate,
                  compaction=compaction, spill_dir=spill, stream_mode=stream_mode)
        ref_p, port_p = ref_api.Problem(**kw), api.Problem(**kw)
        try:
            want = dataclasses.asdict(ref_p.resolve(n))
        except ValueError:
            with pytest.raises(ValueError):
                port_p.resolve(n)
            continue
        assert dataclasses.asdict(port_p.resolve(n)) == want, kw


@pytest.mark.parametrize(
    "kw",
    [dict(objective="undirected", eps=0.5, twophase_passes=0),
     dict(objective="at_least_k"), dict(c_delta=1.0), dict(wire_dtype="f16"),
     dict(backend="cuda"), dict(local_alpha=-1.0), dict(sample_edges=0)],
)
def test_post_init_rejects_like_reference(kw):
    with pytest.raises(ValueError):
        ref_api.Problem(**kw)
    with pytest.raises(ValueError):
        api.Problem(**kw)


@pytest.mark.parametrize("kw", [dict(substrate="mesh")])
def test_mesh_without_a_mesh_raises_like_reference(kw):
    """Every cell is ported; the mesh substrate asks for its mesh with the
    reference's words (the mesh cells themselves: tests/test_torch_mapreduce.py)."""
    edges = erdos_renyi(50, avg_deg=4, seed=0)
    with pytest.raises(ValueError) as want:
        ref_api.Solver().solve(edges, ref_api.Problem(**kw))
    with pytest.raises(ValueError) as got:
        api.solve(_port(edges), api.Problem(**kw))
    assert str(got.value) == str(want.value) == "substrate='mesh' needs solve(..., mesh=Mesh)"


@pytest.mark.parametrize(
    "kw", [dict(substrate="streaming"), dict(substrate="streaming", compaction="off")],
)
def test_streaming_cells_solve_like_reference(kw):
    """The two streaming cells that used to raise here solve as the
    reference does, bitwise (the full matrix is tests/test_torch_streaming.py)."""
    edges = erdos_renyi(50, avg_deg=4, seed=0)
    ref = ref_api.Solver().solve(edges, ref_api.Problem(**kw))
    got = api.solve(_port(edges), api.Problem(**kw))
    for field in ("best_alive", "best_t", "best_density", "best_size", "alive", "t_alive",
                  "history_n", "history_m", "history_rho"):
        assert _bits(getattr(got, field)) == _bits(getattr(ref, field)), field
    assert got.passes == int(ref.passes)
    assert set(got.extras["streaming"]) == set(ref.extras["streaming"])
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(ref.provenance)


@pytest.mark.parametrize(
    "kw", [dict(objective="at_least_k", k=5), dict(objective="directed", c=1.0)],
)
def test_ported_objectives_solve_like_reference(kw):
    """The two objectives that used to raise here now solve as the
    reference does: bitwise, except the directed density, which the
    reference's CPU code forms with an approximate rsqrt (1 ulp; the full
    matrix is tests/test_torch_objectives.py)."""
    directed = kw["objective"] == "directed"
    edges = erdos_renyi(50, avg_deg=4, seed=0, directed=directed)
    ref = ref_api.Solver().solve(edges, ref_api.Problem(**kw))
    got = api.solve(_port(edges), api.Problem(**kw))
    for field in ("best_alive", "best_t", "best_size", "alive", "t_alive"):
        assert _bits(getattr(got, field)) == _bits(getattr(ref, field)), field
    ulps = abs(int(got.best_density.numpy().view(np.int32))
               - int(np.asarray(ref.best_density).view(np.int32)))
    assert ulps <= (1 if directed else 0)
    assert got.passes == int(ref.passes)
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(ref.provenance, cache_hit=False)
    )


def _quickstart():
    return planted_dense_subgraph(n=2000, avg_deg=4, k=60, p_dense=0.6, seed=7)[0]


def _deep():
    return erdos_renyi(600, avg_deg=10, seed=11)


GRAPHS = {"quickstart": (_quickstart, 1024), "deep": (_deep, 128)}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("backend", ["exact", "pallas"])
@pytest.mark.parametrize("compaction", ["off", "geometric", "twophase"])
def test_solve_bit_identical_to_reference(monkeypatch, graph, backend, compaction):
    make, tile = GRAPHS[graph]
    if graph == "deep":  # small floors force a ladder of >= 3 rungs
        for mod in (ref_api, api):
            monkeypatch.setattr(mod, "_COMPACT_MIN_EDGES", 16)
            monkeypatch.setattr(mod, "_COMPACT_MIN_NODES", 16)
    edges = make()
    prob = dict(eps=0.5, backend=backend, compaction=compaction, track_history=True,
                tile_size=tile, tile_block=min(tile, 512), twophase_passes=2)
    ref = ref_api.Solver().solve(edges, ref_api.Problem.undirected(**prob))
    got = api.solve(_port(edges), api.Problem.undirected(**prob))
    for field in ("best_alive", "best_density", "best_size", "alive",
                  "history_n", "history_m", "history_rho"):
        assert _bits(getattr(got, field)) == _bits(getattr(ref, field)), field
    assert got.passes == int(ref.passes)
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(ref.provenance, cache_hit=False)
    )
    if compaction == "off":
        assert got.extras is None
        return
    ref_lad, lad = ref.extras["compaction"], got.extras["compaction"]
    strip = lambda segs: [{k: v for k, v in s.items() if k != "cache_hit"} for s in segs]
    assert strip(lad["segments"]) == strip(ref_lad["segments"])
    assert {k: v for k, v in lad.items() if k != "segments"} == {
        k: v for k, v in ref_lad.items() if k != "segments"
    }
    if graph == "deep" and compaction == "geometric":
        assert len(lad["segments"]) >= 3


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("cell", ["sketch", "turnstile"])
def test_sketch_and_turnstile_solves_bit_identical_to_reference(graph, cell):
    """The cells of this slice through the front door: ``backend='sketch'``
    (§5.1) and a one-shot ``stream_mode='turnstile'`` solve (the deep
    graph's 3,000 edges and the quickstart's 4,500 do not fit 1,024
    samples, so both decode above level 0)."""
    make, _ = GRAPHS[graph]
    edges = make()
    if cell == "sketch":
        prob = dict(eps=0.5, backend="sketch", track_history=True, sketch_buckets=1 << 10)
    else:
        prob = dict(eps=0.5, stream_mode="turnstile", sample_edges=1 << 10, track_history=True)
    ref = ref_api.Solver().solve(edges, ref_api.Problem.undirected(**prob))
    got = api.solve(_port(edges), api.Problem.undirected(**prob))
    for field in ("best_alive", "best_density", "best_size", "alive",
                  "history_n", "history_m", "history_rho"):
        assert _bits(getattr(got, field)) == _bits(getattr(ref, field)), field
    assert got.passes == int(ref.passes)
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(ref.provenance, cache_hit=False)
    )
    if cell == "sketch":
        assert got.extras is None and got.provenance.backend == "sketch"
        return
    info, ref_info = dict(got.extras["turnstile"]), dict(ref.extras["turnstile"])
    np.testing.assert_array_equal(info.pop("sample_nodes"), ref_info.pop("sample_nodes"))
    assert info == ref_info and info["level"] > 0


def test_quickstart_recovers_the_planted_block():
    edges, planted = planted_dense_subgraph(n=2000, avg_deg=4, k=60, p_dense=0.6, seed=7)
    res = api.solve(_port(edges), api.Problem.undirected(eps=0.5, backend="pallas"))
    recall = len(np.intersect1d(res.nodes(), planted)) / len(planted)
    assert recall > 0.9
    assert res.density == float(res.best_density) > 0
    assert res.provenance.compaction == "geometric"
