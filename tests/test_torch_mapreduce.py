"""Port parity: the §5.2 mesh substrate (``repro_torch.core.mapreduce``, the
engine's ``MeshSegmentSumBackend`` and the mesh paths of the port's front
door) against ``repro.core.mapreduce``.

* In this process, at world size 1 over gloo (an in-memory store, 60 s
  timeout): mirrors of tests/test_api.py's ``test_solve_mesh_matches_jit``
  and ``test_compaction_mesh_substrate_bit_identical``, the single-device
  cases of tests/test_mesh_ladder.py (degeneracy to the jit ladder,
  directed, at_least_k, zero-pass runs, the ladder builder), the mesh rows
  of tests/test_engine.py's matrix, the three tests of
  tests/test_twophase_peel.py, the bf16 wire and the sketch, each against
  the reference on a one-device mesh; ``resolve(have_mesh=)``; the mesh
  validation errors, word for word.
* Four gloo ranks, spawned once for the module (tests/torch_mesh_ranks.py;
  every process group with a 60 s timeout, the spawn joined within 240 s):
  a 4-rank mesh and a 2×2 mesh over ``("data", "model")``, on graphs with
  uneven survivors across shards, a rung whose survivors all sit on one
  shard, a permuted edge order, directed, at_least_k, the sketch, the raw
  builders and the golden fixture's mesh cases.  Every rank returns the
  same answer, equal to the reference's.

Unit weights keep every degree, total and sketch counter an exact integer,
so the comparisons are bitwise, except the directed density: the
reference's CPU code forms it with an approximate rsqrt (1 ulp).  The bf16
wire at world size 4 is held to the reference's 4-device answers in the
golden fixture bitwise too (it agrees on both graphs there, including the
200k graph whose reduced degrees are far past bf16's exact integers).  The
collective counts are pinned: one ``all_reduce`` a pass, one more for the
trigger in each ladder segment that can compact (and one at ladder entry),
and 4 ``all_gather`` a rung.
"""

import dataclasses
import datetime
import itertools
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core.api as ref_api
import repro_torch.core.api as api
from repro.core import engine as ref_engine
from repro.core import mapreduce as ref_mr
from repro.graph.generators import directed_planted, erdos_renyi, planted_dense_subgraph
from repro_torch import collectives
from repro_torch.core import engine, mapreduce
from repro_torch.graph.edgelist import from_reference

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.dirname(__file__))

import torch_mesh_ranks as ranks  # noqa: E402
import torch_port_golden as golden  # noqa: E402

OUTCOME = ranks.OUTCOME
WORLD = 4
JOIN_S = 240


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ulps(a, b) -> int:
    a, b = np.float32(_host(a)), np.float32(_host(b))
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def _same(got, ref, fields=OUTCOME, density_ulps=0):
    """``got`` (port outcome or a rank's host dict) against ``ref``, field
    for field: bitwise, the densities (best and per pass) to
    ``density_ulps``."""
    get = (lambda o, f: o[f]) if isinstance(got, dict) else getattr
    for f in fields:
        a, b = _host(get(got, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if f in ("best_density", "history_rho"):
            ulps = np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                          - b.astype(np.float32).view(np.int32))
            assert (ulps <= density_ulps).all(), (f, a, b)
            continue
        assert a.tobytes() == b.astype(a.dtype).tobytes(), f
    assert get(got, "passes") == int(ref.passes)


def _strip(lad):
    out = dict(lad)
    out["segments"] = [{k: v for k, v in s.items() if k != "cache_hit"} for s in lad["segments"]]
    return out


def _und():
    return planted_dense_subgraph(260, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]


def _dir():
    return directed_planted(200, avg_deg=3, ks=15, kt=12, p_dense=0.9, seed=5)[0]


def _rmesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1), ("data",))


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo mesh over ``("data",)`` for this module's process."""
    import torch.distributed as dist

    saved = mapreduce.GROUP_TIMEOUT
    mapreduce.GROUP_TIMEOUT = datetime.timedelta(seconds=60)
    try:
        yield mapreduce.make_mesh((1,), ("data",), device="cpu")
    finally:
        dist.destroy_process_group()
        mapreduce.GROUP_TIMEOUT = saved


@pytest.fixture
def small_ladder_floor(monkeypatch):
    """Multi-rung ladders on few-hundred-edge graphs (the production floor
    of 4096 global edges would leave one rung), in both packages."""
    for mod in (ref_api, api):
        monkeypatch.setattr(mod, "_LADDER_MIN_EDGES", 64)


def _ladder_reduces(lad) -> int:
    """``all_reduce`` calls of a collective ladder: one at entry, then a
    pass's degree reduction, plus its trigger count outside the last rung."""
    segs = lad["segments"]
    return 1 + sum(s["passes"] for s in segs) + sum(s["passes"] for s in segs[:-1])


# ---------------------------------------------------------------------------
# World size 1, in this process
# ---------------------------------------------------------------------------


def test_solve_mesh_matches_jit(mesh1):
    """tests/test_api.py::test_solve_mesh_matches_jit, and both against the
    reference's one-device mesh."""
    edges = _und()
    ref = ref_api.solve(edges, ref_api.Problem.undirected(eps=0.5, substrate="mesh"),
                        mesh=_rmesh())
    rm = api.solve(_port(edges), api.Problem.undirected(eps=0.5, substrate="mesh"), mesh=mesh1)
    rj = api.solve(_port(edges), api.Problem.undirected(eps=0.5))
    _same(rm, ref)
    _same(rj, ref)
    _same(mapreduce.densest_subgraph_distributed(_port(edges), mesh1, ("data",), eps=0.5), ref)
    assert rm.provenance.substrate == "mesh" == ref.provenance.substrate
    assert dataclasses.asdict(rm.provenance) == dataclasses.asdict(
        dataclasses.replace(ref.provenance, cache_hit=False))


def test_compaction_mesh_substrate_bit_identical(mesh1):
    """tests/test_api.py::test_compaction_mesh_substrate_bit_identical."""
    edges = _port(_und())
    off = api.solve(edges, api.Problem.undirected(eps=0.2, substrate="mesh"), mesh=mesh1)
    on = api.solve(edges, api.Problem.undirected(eps=0.2, substrate="mesh",
                                                 compaction="geometric"), mesh=mesh1)
    ref = ref_api.Solver().solve(_und(), ref_api.Problem.undirected(eps=0.2, substrate="mesh"),
                                 mesh=_rmesh())
    _same(off, ref)
    _same(on, ref)


CELLS = {
    "off": dict(compaction="off"),
    "geometric": dict(compaction="geometric"),
    "twophase": dict(compaction="twophase", twophase_passes=2),
    "off.bf16": dict(compaction="off", wire_dtype="bf16"),
    "geometric.bf16": dict(compaction="geometric", wire_dtype="bf16"),
    "sketch": dict(backend="sketch", sketch_buckets=256),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_mesh_cells_bit_identical_to_reference(mesh1, small_ladder_floor, cell):
    """Each mesh cell at world size 1 against the reference's one-device
    mesh: every outcome field, the ladder report but ``cache_hit``, and
    the collectives it launched.  bf16 is a cast there and back."""
    edges = _und()
    kw = dict(eps=0.1, substrate="mesh", track_history=True, **CELLS[cell])
    ref = ref_api.Solver().solve(edges, ref_api.Problem.undirected(**kw), mesh=_rmesh())
    collectives.reset()
    got = api.solve(_port(edges), api.Problem.undirected(**kw), mesh=mesh1)
    _same(got, ref)
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(ref.provenance, cache_hit=False))
    lad = (got.extras or {}).get("compaction")
    if lad is None:
        assert ref.extras is None or "compaction" not in ref.extras
    else:
        assert _strip(lad) == _strip(ref.extras["compaction"])
    if cell.startswith("geometric"):
        assert lad["single_program"] and lad["host_round_trips"] == 0
        assert len(lad["segments"]) > 1
        assert collectives.all_reduce.count == _ladder_reduces(lad)
        assert collectives.all_gather.count == 4 * (len(lad["segments"]) - 1)
    else:
        assert collectives.all_reduce.count == got.passes
        assert collectives.all_gather.count == 0


@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_single_device_mesh_ladder_degenerates_to_jit_ladder(mesh1, small_ladder_floor, eps):
    """tests/test_mesh_ladder.py: the mesh ladder == the jit host ladder ==
    off, to the bit, history included; its report is collective-only."""
    edges = _port(_und())
    off = api.solve(edges, api.Problem.undirected(eps=eps, track_history=True,
                                                  compaction="off"))
    jit_ladder = api.solve(edges, api.Problem.undirected(eps=eps, track_history=True,
                                                         compaction="geometric"))
    mesh_ladder = api.solve(edges, api.Problem.undirected(
        eps=eps, track_history=True, compaction="geometric", substrate="mesh"), mesh=mesh1)
    for f in OUTCOME:
        assert torch.equal(getattr(off, f), getattr(jit_ladder, f)), f
        assert torch.equal(getattr(off, f), getattr(mesh_ladder, f)), f
    assert off.passes == jit_ladder.passes == mesh_ladder.passes
    lad = mesh_ladder.extras["compaction"]
    assert lad["single_program"] is True and lad["host_round_trips"] == 0
    assert sum(seg["passes"] for seg in lad["segments"]) == off.passes
    assert len(lad["segments"]) > 1
    jl = jit_ladder.extras["compaction"]
    assert jl["single_program"] is False
    assert jl["host_round_trips"] == len(jl["segments"]) >= 1


@pytest.mark.parametrize("c", [0.5, 1.0, None])
def test_mesh_ladder_directed_matches_host_ladder(mesh1, small_ladder_floor, c):
    edges = _dir()
    ref = ref_api.Solver().solve(
        edges, ref_api.Problem.directed(c=c, eps=0.5, substrate="mesh", compaction="off"),
        mesh=_rmesh())
    off = api.solve(_port(edges), api.Problem.directed(c=c, eps=0.5, substrate="mesh",
                                                       compaction="off"), mesh=mesh1)
    on = api.solve(_port(edges), api.Problem.directed(c=c, eps=0.5, substrate="mesh",
                                                      compaction="geometric"), mesh=mesh1)
    _same(off, ref, density_ulps=1)
    _same(on, ref, density_ulps=1)
    if c is None:
        assert on.extras["best_c"] == off.extras["best_c"] == ref.extras["best_c"]
        np.testing.assert_array_equal(on.extras["c_density"], off.extras["c_density"])
        np.testing.assert_array_equal(on.extras["c_passes"], ref.extras["c_passes"])


def test_mesh_ladder_at_least_k_and_zero_pass_runs(mesh1, small_ladder_floor):
    edges = _und()
    for k in (30, edges.n_nodes + 10):  # k > n: the zero-pass run
        ref = ref_api.Solver().solve(
            edges, ref_api.Problem.at_least_k(k=k, eps=0.5, substrate="mesh",
                                              compaction="off"), mesh=_rmesh())
        for comp in ("off", "geometric"):
            got = api.solve(_port(edges), api.Problem.at_least_k(
                k=k, eps=0.5, substrate="mesh", compaction=comp), mesh=mesh1)
            _same(got, ref)


def test_make_distributed_peel_ladder_builder_single_device(mesh1, small_ladder_floor):
    edges = _und()
    ref_run = ref_mr.make_distributed_peel_ladder(
        _rmesh(), ("data",), eps=0.5, n_nodes=edges.n_nodes, m_edges=edges.n_edges_padded)
    run = mapreduce.make_distributed_peel_ladder(
        mesh1, ("data",), eps=0.5, n_nodes=edges.n_nodes, m_edges=edges.n_edges_padded)
    assert run.schedule == ref_run.schedule and run.n_edge_slots == ref_run.n_edge_slots
    assert all(a > b for a, b in zip(run.schedule, run.schedule[1:]))
    sh = mapreduce.shard_edges(_port(edges).with_padding(run.n_edge_slots), mesh1, ("data",))
    out = run(sh.src, sh.dst, sh.weight, sh.mask)
    ref = ref_api.Solver().solve(edges, ref_api.Problem.undirected(eps=0.5, compaction="off"))
    _same(out, ref, fields=("best_alive", "best_density", "best_size", "alive"))


# -- tests/test_engine.py's mesh rows ---------------------------------------

ENGINE_GRAPHS = {
    "er": lambda: erdos_renyi(180, avg_deg=8, seed=0),
    "planted": lambda: planted_dense_subgraph(250, avg_deg=4, k=25, p_dense=0.8, seed=3)[0],
}


def _engine_pair(edges, ref_policy, port_policy, mesh1, mp=64):
    """run_peel with the mesh backend: the reference inside shard_map on
    one device, the port on its one-rank shard."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.graph.edgelist import EdgeList as RefEdges

    rmesh = _rmesh()
    sh = ref_mr.shard_edges(edges, rmesh, ("data",))

    def local(src, dst, weight, mask):
        e = RefEdges(src=src, dst=dst, weight=weight, mask=mask, n_nodes=sh.n_nodes)
        return ref_engine.run_peel(e, ref_policy, ref_engine.MeshSegmentSumBackend(("data",)),
                                   mp, track_history=True)

    ref = jax.jit(shard_map(local, mesh=rmesh, in_specs=(P(("data",)),) * 4, out_specs=P(),
                            check_vma=False))(sh.src, sh.dst, sh.weight, sh.mask)
    psh = mapreduce.shard_edges(_port(edges), mesh1, ("data",))
    backend = engine.MeshSegmentSumBackend(mapreduce.edge_shards(mesh1, ("data",)).group)
    got = engine.run_peel(psh, port_policy, backend, mp, track_history=True)
    return got, ref


@pytest.mark.parametrize("graph", sorted(ENGINE_GRAPHS))
@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_matrix_undirected_threshold_mesh(mesh1, graph, eps):
    got, ref = _engine_pair(ENGINE_GRAPHS[graph](), ref_engine.UndirectedThreshold(eps),
                            engine.UndirectedThreshold(eps), mesh1)
    _same(got, ref)


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
def test_matrix_at_least_k_mesh(mesh1, variant):
    fb = variant == "floor_fallback"
    kw = dict(k=30, eps=0.5, min_deg_fallback=fb, ceil_count=not fb)
    got, ref = _engine_pair(ENGINE_GRAPHS["planted"](), ref_engine.AtLeastKFraction(**kw),
                            engine.AtLeastKFraction(**kw), mesh1)
    _same(got, ref)


@pytest.mark.parametrize("c", [0.5, 1.0, 2.0])
def test_matrix_directed_st_mesh(mesh1, c):
    import jax.numpy as jnp

    got, ref = _engine_pair(
        _dir(), ref_engine.DirectedST(eps=0.5, c=jnp.float32(c)),
        engine.DirectedST(eps=0.5, c=torch.tensor(c, dtype=torch.float32)), mesh1)
    _same(got, ref, density_ulps=1)


# -- tests/test_twophase_peel.py --------------------------------------------


@pytest.mark.parametrize("seed,eps,k1", [(0, 0.5, 3), (1, 1.0, 2), (2, 0.3, 5)])
def test_twophase_matches_single_phase(mesh1, seed, eps, k1):
    """Both phases and the merge, against the reference's builder and the
    port's one-phase peel."""
    from repro.graph import generators as gen

    edges = gen.planted_dense_subgraph(n=400, avg_deg=4.0, k=40, p_dense=0.6, seed=seed)[0]
    rsh = ref_mr.shard_edges(edges, _rmesh(), ("data",))
    ref = ref_mr.make_distributed_peel_twophase(
        _rmesh(), ("data",), eps=eps, n_nodes=rsh.n_nodes, phase1_passes=k1,
    )(rsh.src, rsh.dst, rsh.weight, rsh.mask)
    sh = mapreduce.shard_edges(_port(edges), mesh1, ("data",))
    one = mapreduce.make_distributed_peel(mesh1, ("data",), eps=eps, n_nodes=sh.n_nodes)
    two = mapreduce.make_distributed_peel_twophase(mesh1, ("data",), eps=eps,
                                                   n_nodes=sh.n_nodes, phase1_passes=k1)
    r1 = one(sh.src, sh.dst, sh.weight, sh.mask)
    r2 = two(sh.src, sh.dst, sh.weight, sh.mask)
    assert float(r2.best_density) == pytest.approx(float(r1.best_density), rel=1e-6)
    assert torch.equal(r1.best_alive, r2.best_alive)
    _same(r2, ref)


def test_twophase_lemma4_bound_holds():
    """After k passes the alive count is below n/(1+eps)^k (the static
    size the two-phase compaction relies on), in the port's peel."""
    from repro.graph import generators as gen
    from repro_torch.core.peel import densest_subgraph

    edges = gen.chung_lu_power_law(n=5000, exponent=2.0, avg_deg=10.0, seed=3)
    eps = 0.5
    res = densest_subgraph(_port(edges), eps=eps, track_history=True)
    hn = res.history_n.numpy()[: res.passes]
    assert len(hn) > 2
    for k in range(1, len(hn)):
        assert hn[k] <= edges.n_nodes / (1 + eps) ** k + 1e-9


def test_distributed_topk_meets_guarantee(mesh1):
    """Algorithm 2 on the mesh: |S~| >= k, its density is its density, the
    (3+3eps) bound against the one-device Algorithm 2, and the reference's
    builder's answer bitwise."""
    from repro.core.peel_topk import densest_subgraph_at_least_k
    from repro_torch.core.density import density_of

    eps, k = 0.5, 30
    edges = planted_dense_subgraph(n=300, avg_deg=4.0, k=25, p_dense=0.8, seed=7)[0]
    rsh = ref_mr.shard_edges(edges, _rmesh(), ("data",))
    ref = ref_mr.make_distributed_topk_peel(_rmesh(), ("data",), k=k, eps=eps,
                                            n_nodes=rsh.n_nodes)(rsh.src, rsh.dst,
                                                                 rsh.weight, rsh.mask)
    pe = _port(edges)
    sh = mapreduce.shard_edges(pe, mesh1, ("data",))
    r = mapreduce.make_distributed_topk_peel(mesh1, ("data",), k=k, eps=eps,
                                             n_nodes=sh.n_nodes)(sh.src, sh.dst, sh.weight,
                                                                 sh.mask)
    assert int(r.best_alive.sum()) >= k
    assert float(density_of(pe, r.best_alive)) == pytest.approx(float(r.best_density), rel=1e-5)
    one = densest_subgraph_at_least_k(edges, k=k, eps=eps)
    assert float(r.best_density) >= float(one.best_density) / (3 * (1 + eps))
    _same(r, ref, fields=("best_alive", "best_density", "best_size", "alive"))


def test_sketched_builder_and_directed_sketch(mesh1):
    """make_distributed_sketched_peel == the reference's builder (K2's
    plain version on each shard here); the mesh sketch has no directed
    rule, in either package."""
    edges = _und()
    rsh = ref_mr.shard_edges(edges, _rmesh(), ("data",))
    want = ref_mr.make_distributed_sketched_peel(
        _rmesh(), ("data",), eps=0.5, n_nodes=rsh.n_nodes, b=256, node_chunk=100,
    )(rsh.src, rsh.dst, rsh.weight, rsh.mask)
    sh = mapreduce.shard_edges(_port(edges), mesh1, ("data",))
    got = mapreduce.make_distributed_sketched_peel(
        mesh1, ("data",), eps=0.5, n_nodes=sh.n_nodes, b=256, node_chunk=100,
    )(sh.src, sh.dst, sh.weight, sh.mask)
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert _ulps(got[1], want[1]) == 0 and got[2] == int(want[2])
    prob = dict(substrate="mesh", backend="sketch", compaction="off")
    with pytest.raises(NotImplementedError, match="use SketchBackend"):
        ref_api.solve(_dir(), ref_api.Problem.directed(c=1.0, **prob), mesh=_rmesh())
    with pytest.raises(NotImplementedError, match="use SketchBackend"):
        api.solve(_port(_dir()), api.Problem.directed(c=1.0, **prob), mesh=mesh1)


# -- resolution and validation -----------------------------------------------


@pytest.mark.parametrize("objective", ["undirected", "at_least_k", "directed"])
def test_resolve_have_mesh_matches_reference(objective):
    """Without a mesh, ``resolve`` is the reference's; with one that spans
    more than one rank, ``'auto'`` picks the mesh and everything else
    resolves as the reference resolves an explicit ``substrate='mesh'``."""
    grid = itertools.product(["exact", "sketch", "pallas", "auto"],
                             ["jit", "mesh", "streaming", "local", "auto"],
                             ["off", "twophase", "geometric", "auto"], [100, 2_000_000])
    k = 3 if objective == "at_least_k" else None
    for backend, substrate, compaction, n in grid:
        kw = dict(objective=objective, k=k, backend=backend, substrate=substrate,
                  compaction=compaction)
        for have_mesh in (False, True):
            ref_kw = dict(kw)
            if have_mesh and substrate == "auto":
                ref_kw["substrate"] = "mesh"
            try:
                want = dataclasses.asdict(ref_api.Problem(**ref_kw).resolve(n))
            except ValueError:
                with pytest.raises(ValueError):
                    api.Problem(**kw).resolve(n, have_mesh=have_mesh)
                continue
            got = dataclasses.asdict(api.Problem(**kw).resolve(n, have_mesh=have_mesh))
            assert got == want, (kw, have_mesh)
    assert api.Problem(substrate="auto").resolve(10, have_mesh=False).substrate == "jit"


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mesh_validation_errors_word_for_word(mesh1):
    edges = _und()
    pe = _port(edges)
    rmesh = _rmesh()
    cases = [
        (dict(substrate="mesh"), None, None),  # a mesh substrate without a mesh
        (dict(substrate="mesh", compaction="geometric"), None, None),
        (dict(substrate="mesh", backend="pallas"), rmesh, mesh1),
        (dict(substrate="local"), rmesh, mesh1),
    ]
    for kw, rm, pm in cases:
        want = _message(lambda: ref_api.Solver().solve(
            edges, ref_api.Problem(**kw), mesh=rm, seed=0 if "local" in kw.values() else None))
        got = _message(lambda: api.solve(pe, api.Problem(**kw), mesh=pm,
                                         seed=0 if "local" in kw.values() else None))
        assert got == want, kw
    want = _message(lambda: ref_api.solve_batch(edges, ref_api.Problem(substrate="mesh"),
                                                eps=[0.5]))
    assert _message(lambda: api.solve_batch(pe, api.Problem(substrate="mesh"),
                                            eps=[0.5])) == want
    with pytest.raises(ValueError, match="edge axis 'model'"):
        api.solve(pe, api.Problem(substrate="mesh", edge_axes=("model",)), mesh=mesh1)
    meta = pe.to("meta")
    with pytest.raises(ValueError, match="mesh spans cpu"):
        api.solve(meta, api.Problem(substrate="mesh"), mesh=mesh1)
    with pytest.raises(RuntimeError, match="reduces over nccl"):
        mapreduce.make_mesh((1,), ("data",), device="cuda")


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------


def _clique_graph(rng):
    """A 40-clique in the first slots (shard 0 of 4) over a sparse
    background: once the background peels away, every surviving edge
    lives on one shard."""
    n = 400
    ks, kd = np.triu_indices(40, k=1)
    bs, bd = rng.integers(40, n, 1200), rng.integers(40, n, 1200)
    keep = bs != bd
    src = np.concatenate([ks, bs[keep]]).astype(np.int32)
    dst = np.concatenate([kd, bd[keep]]).astype(np.int32)
    return src, dst, n


def _ref_graphs():
    from repro.graph.edgelist import from_numpy

    rng = np.random.default_rng(1)
    src, dst, n = _clique_graph(rng)
    perm = rng.permutation(src.size)
    return {
        "uneven": planted_dense_subgraph(500, avg_deg=4, k=25, p_dense=0.8, seed=0)[0],
        "one_shard": from_numpy(src, dst, n),
        "permuted": from_numpy(src[perm], dst[perm], n),
        "directed": _dir(),
        "twophase": planted_dense_subgraph(n=400, avg_deg=4.0, k=40, p_dense=0.6, seed=0)[0],
        "topk": planted_dense_subgraph(n=300, avg_deg=4.0, k=25, p_dense=0.8, seed=7)[0],
    }


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The answers of 4 gloo ranks (tests/torch_mesh_ranks.py), with the
    reference graphs they solved."""
    tmp = str(tmp_path_factory.mktemp("mesh_ranks"))
    graphs = _ref_graphs()
    arrays = {}
    for name, e in graphs.items():
        for f in ("src", "dst", "weight", "mask"):
            arrays[f"{name}.{f}"] = np.asarray(getattr(e, f))
        arrays[f"{name}.n_nodes"] = np.asarray(e.n_nodes)
        arrays[f"{name}.directed"] = np.asarray(e.directed)
    np.savez(os.path.join(tmp, "graphs.npz"), **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    script = os.path.join(os.path.dirname(__file__), "torch_mesh_ranks.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), tmp], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return graphs, out


def _ranks_agree(answers):
    def canon(x):
        if isinstance(x, np.ndarray):
            return (x.dtype.str, x.shape, x.tobytes())
        if isinstance(x, dict):
            return {k: canon(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [canon(v) for v in x]
        return x

    first = canon(answers[0])
    for r, a in enumerate(answers[1:], 1):
        assert canon(a) == first, f"rank {r} differs from rank 0"


def _reference_for(case, graphs):
    """The reference's one-device answer the case must equal."""
    gname, _, _, what, kw = ranks.CASES[case]
    edges = graphs[gname]
    kw = dict(kw)
    if what in ("undirected", "at_least_k", "directed"):
        kw["compaction"] = "off"
        return ref_api.Solver().solve(edges, getattr(ref_api.Problem, what)(
            track_history=True, **kw))
    rmesh = _rmesh()
    sh = ref_mr.shard_edges(edges, rmesh, ("data",))
    args = (sh.src, sh.dst, sh.weight, sh.mask)
    if what == "make_distributed_peel_ladder":
        return ref_api.Solver().solve(edges, ref_api.Problem.undirected(compaction="off", **kw))
    fn = getattr(ref_mr, what)(rmesh, ("data",), n_nodes=edges.n_nodes, **kw)
    if what == "make_distributed_directed_peel":
        s, t, rho, passes = fn(*args, ranks.BUILDER_DIRECTED_C)
        return ref_engine.PeelOutcome(s, t, rho, None, passes, None, None, None, None, None)
    if what == "make_distributed_sketched_peel":
        s, rho, passes = fn(*args)
        return ref_engine.PeelOutcome(s, None, rho, None, passes, None, None, None, None, None)
    return fn(*args)


@pytest.mark.parametrize("case", sorted(ranks.CASES))
def test_four_ranks_match_reference(four_ranks, case):
    """Every rank returns the same answer (ladder reports and collective
    counts included), equal to the reference's on one device."""
    graphs, out = four_ranks
    answers = [o["cases"][case] for o in out]
    _ranks_agree(answers)
    got = answers[0]
    ref = _reference_for(case, graphs)
    what = ranks.CASES[case][3]
    fields = [f for f in OUTCOME if f in got and getattr(ref, f) is not None]
    if what == "make_distributed_peel_twophase":
        fields = ["best_alive", "best_density", "best_size", "alive"]
    elif what == "make_distributed_peel_ladder":
        fields = ["best_alive", "best_density", "best_size", "alive"]
    _same(got, ref, fields=fields, density_ulps=1 if "directed" in what else 0)
    if "extras" in got and "best_c" in got["extras"]:
        assert got["extras"]["best_c"] == ref.extras["best_c"]
        assert got["extras"]["c_passes"] == [int(p) for p in ref.extras["c_passes"]]


@pytest.mark.parametrize("case", sorted(c for c in ranks.CASES if ".geometric" in c))
def test_four_ranks_collective_ladder(four_ranks, case):
    """The collective ladder at 4 ranks: more than one rung, no host round
    trip, the rung passes summing to the run's, and the pinned collective
    counts (uneven survivors end each segment at the same pass on every
    rank, or the counts and reports would differ across ranks)."""
    _, out = four_ranks
    got = out[0]["cases"][case]
    lad = got["extras"]["compaction"]  # the c grid's: the best c's ladder
    assert lad["single_program"] is True and lad["host_round_trips"] == 0
    assert len(lad["segments"]) > 1
    assert sum(s["passes"] for s in lad["segments"]) == got["passes"]
    counts = got["collectives"]
    if "grid" in case:
        return  # one ladder a c: the per-ladder pins hold for each
    assert counts["all_reduce"] == _ladder_reduces(lad)
    assert counts["all_gather"] == 4 * (len(lad["segments"]) - 1)


def test_four_ranks_one_reduction_a_pass(four_ranks):
    """Uncompacted and host-ladder runs: exactly one ``all_reduce`` a pass
    and no gather; the sketch's pass moves t·b + 1 floats, not n."""
    _, out = four_ranks
    cases = out[0]["cases"]
    for case in ("uneven.off", "uneven.twophase", "uneven.off.2x2_data", "directed.c4.off",
                 "uneven.sketch", "builder.peel", "builder.topk", "builder.sketched"):
        got = cases[case]
        assert got["collectives"]["all_reduce"] == got["passes"], case
        assert got["collectives"]["all_gather"] == 0, case
    sk = cases["uneven.sketch"]
    assert sk["collectives"]["all_reduce_bytes"] == sk["passes"] * (5 * 256 + 1) * 4
    off = cases["uneven.off"]
    assert off["collectives"]["all_reduce_bytes"] == off["passes"] * (500 + 1) * 4


def test_four_ranks_sketch_bitwise_against_one_rank(four_ranks, mesh1):
    """The mesh sketch at 4 ranks == at 1 rank == the reference's jit
    sketch: unit-weight counters are exact integers."""
    graphs, out = four_ranks
    edges = graphs["uneven"]
    kw = dict(eps=0.5, backend="sketch", sketch_buckets=256, track_history=True)
    one = api.solve(_port(edges), api.Problem.undirected(substrate="mesh", **kw), mesh=mesh1)
    jit = ref_api.Solver().solve(edges, ref_api.Problem.undirected(**kw))
    _same(one, jit)
    _same(out[0]["cases"]["uneven.sketch"], jit)


@pytest.mark.parametrize("case", sorted(golden.MESH_CASES))
def test_four_ranks_meet_mesh_golden(four_ranks, case):
    """The golden fixture's mesh entries (the reference on 4 devices): the
    port's 4 ranks equal them, ladder report and the bf16 wire included."""
    _, out = four_ranks
    with open(golden.GOLDEN) as f:
        want = json.load(f)["mesh"]["answers"][case]
    for o in out:
        assert o["golden"][case] == want


_TORCHRUN_SCRIPT = """
import os
from repro_torch.core import Problem, make_mesh, solve
from repro_torch.core import mapreduce
from repro_torch.graph.generators import planted_dense_subgraph
import datetime

mapreduce.GROUP_TIMEOUT = datetime.timedelta(seconds=60)
mesh = make_mesh((2,), ("data",), device="cpu")
g, _ = planted_dense_subgraph(500, 4, 25, 0.8, seed=0, device="cpu")
r = solve(g, Problem.undirected(eps=0.2, substrate="auto", track_history=True), mesh=mesh)
print("RESULT", os.environ["RANK"], r.provenance.substrate, r.provenance.compaction, r.passes,
      r.best_density.numpy().tobytes().hex(), r.nodes().tolist())
"""


def test_torchrun_world_and_auto_substrate(tmp_path):
    """Under ``torchrun`` (two CPU ranks), ``make_mesh`` joins the world the
    launcher describes, and ``substrate='auto'`` with a mesh of more than
    one rank runs the mesh: both ranks print the same answer, equal to the
    jit solve."""
    script = tmp_path / "mesh_torchrun.py"
    script.write_text(_TORCHRUN_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         str(script)], env=env, capture_output=True, text=True, timeout=JOIN_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    lines = sorted(ln.split(" ", 2)[2] for ln in proc.stdout.splitlines()
                   if ln.startswith("RESULT "))
    assert len(lines) == 2 and lines[0] == lines[1], lines
    want = api.solve(_port(planted_dense_subgraph(500, avg_deg=4, k=25, p_dense=0.8, seed=0)[0]),
                     api.Problem.undirected(eps=0.2, track_history=True))
    substrate, compaction, passes, rho, nodes = lines[0].split(" ", 4)
    assert (substrate, compaction) == ("mesh", "geometric")
    assert int(passes) == want.passes
    assert rho == want.best_density.numpy().tobytes().hex()
    assert nodes == str(want.nodes().tolist())
