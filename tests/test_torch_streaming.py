"""Port parity: the semi-streaming substrate (``repro_torch.core.streaming``,
the memmap stores and spill ladder of ``repro_torch.graph.edgelist``, the
front door's ``substrate='streaming'``) against ``repro``.

Every test of tests/test_streaming_ooc.py and the three streaming tests of
tests/test_streaming_mapreduce.py, at their sizes, with the port on the
CPU held against the reference run the same way: bitwise on unit weights
(best set, best rho, final alive set, passes, history).  Float weights are
held to rtol 1e-6 on densities (the two packages may add a chunk's f32
weights in another order).  Then the on-disk formats in both directions: a
checkpoint or spill rung written by either package is resumed by the
other to the same answer, and a store or spill written by one opens in
the other with equal arrays and manifest.  Last, the port's fault sites
(``streaming.chunk``, ``streaming.checkpoint_save``/``_load``,
``edgelist.spill_publish``) drive the same recovery paths as the
reference's.
"""

import os

import numpy as np
import pytest
import torch

import repro.core.api as ref_api
import repro.core.streaming as rs
import repro.graph.edgelist as rel
import repro_torch.core.api as api
import repro_torch.core.streaming as ps
import repro_torch.graph.edgelist as pel
from repro.core import densest_subgraph
from repro.graph.generators import erdos_renyi, planted_dense_subgraph
from repro_torch import faults
from repro_torch.faults import FaultPlan, InjectedFault
from repro_torch.graph.edgelist import from_reference
from repro_torch.graph.partition import pow2_bucket

FLOAT_RTOL = 1e-6  # f32 reassociation of a chunk's weights


def _edges_np(edges):
    mask = np.asarray(edges.mask)
    return (
        np.asarray(edges.src)[mask],
        np.asarray(edges.dst)[mask],
        np.asarray(edges.weight)[mask],
    )


def _port_drv(stream, n_nodes, **kw):
    return ps.StreamingDensest(stream, n_nodes=n_nodes, device="cpu", **kw)


def _same_state(got, want, history=True):
    """Bitwise: best set, best rho, final alive set, passes, history."""
    assert got.best_rho == want.best_rho
    np.testing.assert_array_equal(got.best_alive, want.best_alive)
    np.testing.assert_array_equal(got.alive, want.alive)
    assert got.pass_idx == want.pass_idx
    if history:
        assert got.history == want.history


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    assert faults.installed() is None
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def graph():
    edges = erdos_renyi(500, avg_deg=8, seed=3)
    return edges, _edges_np(edges)


# ---------------------------------------------------------------------------
# Exception safety
# ---------------------------------------------------------------------------


def test_failing_chunk_stream_raises_real_error(graph):
    edges, (src, dst, w) = graph
    for mod, mk in ((rs, rs.StreamingDensest), (ps, _port_drv)):
        base = mod.chunked_from_arrays(src, dst, w, chunk=97)

        def bad_stream(base=base):
            for i, c in enumerate(base()):
                if i == 3:
                    raise RuntimeError("chunk 3 exploded")
                yield c

        drv = mk(bad_stream, n_nodes=edges.n_nodes, n_workers=3)
        with pytest.raises(RuntimeError, match="chunk 3 exploded"):
            drv.run(resume=False)


def test_failing_chunk_worker_raises_real_error(graph):
    """A bad payload raises the worker's real exception (TypeError), as in
    the reference, with and without speculation."""
    edges, (src, dst, w) = graph
    base = ps.chunked_from_arrays(src, dst, w, chunk=97)

    def poisoned():
        for i, (s, d, ww) in enumerate(base()):
            if i == 2:
                yield s, d, np.array(["boom"] * len(ww), object)
            else:
                yield s, d, ww

    for speculative in (False, True):
        for mk in (rs.StreamingDensest, _port_drv):
            drv = mk(poisoned, n_nodes=edges.n_nodes, n_workers=3, speculative=speculative)
            with pytest.raises(TypeError):
                drv.run(resume=False)


def test_flaky_chunk_first_success_wins(graph, monkeypatch):
    edges, (src, dst, w) = graph
    ref = rs.StreamingDensest(
        rs.chunked_from_arrays(src, dst, w, chunk=97), n_nodes=edges.n_nodes
    ).run(resume=False)
    orig = ps._chunk_stats
    state = {"failed": False}

    def flaky(s, d, ww, alive):
        if not state["failed"]:
            state["failed"] = True
            raise OSError("transient chunk read error")
        return orig(s, d, ww, alive)

    monkeypatch.setattr(ps, "_chunk_stats", flaky)
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=97), edges.n_nodes,
                    n_workers=3, speculative=True)
    st = drv.run(resume=False)
    assert drv.speculative_reissues >= 1
    _same_state(st, ref)


def test_failed_pass_keeps_previous_checkpoint(graph, tmp_path):
    edges, (src, dst, w) = graph
    states = []
    for name, mk in (("ref", rs.StreamingDensest), ("port", _port_drv)):
        base = ps.chunked_from_arrays(src, dst, w, chunk=200)
        calls = {"n": 0}

        def explode_on_third_pass(base=base, calls=calls):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("pass 3 stream lost")
            yield from base()

        drv = mk(explode_on_third_pass, n_nodes=edges.n_nodes,
                 checkpoint_dir=str(tmp_path / name))
        with pytest.raises(RuntimeError, match="pass 3 stream lost"):
            drv.run(resume=False)
        st = drv._load()
        assert st is not None and st.pass_idx == 2  # both completed passes saved
        states.append(st)
    _same_state(states[1], states[0])


# ---------------------------------------------------------------------------
# Async pipeline: residency bound + bit-identity vs the synchronous path
# ---------------------------------------------------------------------------


def test_prefetch_bounds_resident_chunks(graph):
    edges, (src, dst, w) = graph
    ref = rs.StreamingDensest(
        rs.chunked_from_arrays(src, dst, w, chunk=64), n_nodes=edges.n_nodes
    ).run(resume=False)
    for prefetch in (1, 2, 5):
        drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=64), edges.n_nodes,
                        n_workers=4, prefetch=prefetch)
        _same_state(drv.run(resume=False), ref)
        assert 0 < drv.peak_resident_chunks <= prefetch
        assert drv.peak_resident_edges <= prefetch * 64
        assert drv.bytes_to_device == 0  # the CPU moves nothing


@pytest.mark.parametrize("chunk", [64, 257, 1000])
def test_async_pipeline_bit_identical_to_sync(graph, chunk):
    """The port's async pipeline equals the reference's synchronous one."""
    edges, (src, dst, w) = graph
    sync = rs.StreamingDensest(
        rs.chunked_from_arrays(src, dst, w, chunk=chunk),
        n_nodes=edges.n_nodes, n_workers=1, prefetch=1, speculative=False,
    ).run(resume=False)
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=chunk), edges.n_nodes,
                    n_workers=4, prefetch=6, speculative=True, speculate_tail_frac=0.5)
    _same_state(drv.run(resume=False), sync)


def test_chunk_timings_bounded(graph):
    edges, (src, dst, w) = graph
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=32), edges.n_nodes)
    drv.run(resume=False)
    assert ps._TIMINGS_WINDOW == rs._TIMINGS_WINDOW
    assert drv.chunk_timings.maxlen == ps._TIMINGS_WINDOW
    assert 0 < len(drv.chunk_timings) <= ps._TIMINGS_WINDOW


# ---------------------------------------------------------------------------
# History record: (n_alive, e_alive, rho), not total weight
# ---------------------------------------------------------------------------


def test_history_records_alive_edge_count(tmp_path):
    edges = erdos_renyi(300, avg_deg=6, seed=7)
    src, dst, w = _edges_np(edges)
    w = w * 3.5  # weight != edge count (sums of 3.5 stay exact in f32)
    ref = rs.StreamingDensest(
        rs.chunked_from_arrays(src, dst, w, chunk=128), n_nodes=edges.n_nodes
    ).run(resume=False)
    ck = str(tmp_path / "ck")
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=128), edges.n_nodes,
                    checkpoint_dir=ck)
    st = drv.run(resume=False)
    n0, m0, rho0 = st.history[0]
    assert n0 == edges.n_nodes
    assert m0 == len(src)  # alive edge count, not 3.5x the weight
    assert rho0 == pytest.approx(3.5 * len(src) / edges.n_nodes)
    _same_state(st, ref)
    loaded = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=128), edges.n_nodes,
                       checkpoint_dir=ck)._load()
    assert [tuple(map(float, h)) for h in loaded.history] == [
        tuple(map(float, h)) for h in st.history
    ]


def test_float_weights_within_f32_tolerance():
    """Random float weights: the same sets and passes, densities within
    rtol 1e-6 (a chunk's weights may be added in another order)."""
    edges = erdos_renyi(400, avg_deg=8, seed=9)
    src, dst, _ = _edges_np(edges)
    w = np.random.default_rng(0).random(len(src)).astype(np.float32) + 0.5
    for comp in ("off", "geometric"):
        ref = rs.StreamingDensest(rs.chunked_from_arrays(src, dst, w, chunk=100),
                                  n_nodes=edges.n_nodes, compaction=comp).run(resume=False)
        st = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=100), edges.n_nodes,
                       compaction=comp).run(resume=False)
        assert st.best_rho == pytest.approx(ref.best_rho, rel=FLOAT_RTOL)
        np.testing.assert_array_equal(st.best_alive, ref.best_alive)
        assert st.pass_idx == ref.pass_idx
        for (n1, m1, r1), (n2, m2, r2) in zip(st.history, ref.history):
            assert (n1, m1) == (n2, m2) and r1 == pytest.approx(r2, rel=FLOAT_RTOL)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_chunk_stats_accumulate_float32(dtype):
    """The chunk count accumulates in f32 whatever the weight dtype, as the
    reference's ``_chunk_stats`` (tests/test_api.py) does."""
    src = np.array([0, 1, 2, 0], np.int32)
    dst = np.array([1, 2, 3, 3], np.int32)
    w = np.array([0.1, 0.2, 0.3, 0.4], dtype)
    alive = np.array([True, True, True, False])
    s, d, ww = (torch.from_numpy(a) for a in ps._host_chunk((src, dst, w)))
    deg, total, n_ok = ps._chunk_stats(s, d, ww, torch.from_numpy(alive))
    r_deg, r_total, r_ok = rs._chunk_stats(src, dst, w, alive)
    assert deg.dtype == torch.float32 and total.dtype == torch.float32
    np.testing.assert_array_equal(deg.numpy(), np.asarray(r_deg))
    assert float(total) == float(r_total) and int(n_ok) == int(r_ok) == 2


# ---------------------------------------------------------------------------
# Compaction ladder: rung-trigger accounting + spill
# ---------------------------------------------------------------------------


def test_compact_stream_returns_padded_slot_total(graph):
    edges, (src, dst, w) = graph
    alive_c = np.zeros(edges.n_nodes, bool)
    alive_c[: edges.n_nodes // 3] = True  # kill 2/3 of the nodes
    id_map = np.arange(edges.n_nodes, dtype=np.int64)
    got = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=100), edges.n_nodes,
                    compaction="geometric")._compact_stream(
        ps.chunked_from_arrays(src, dst, w, chunk=100), alive_c, id_map, 1)
    want = rs.StreamingDensest(
        rs.chunked_from_arrays(src, dst, w, chunk=100), n_nodes=edges.n_nodes,
        compaction="geometric")._compact_stream(
        rs.chunked_from_arrays(src, dst, w, chunk=100), alive_c, id_map, 1)
    stream, new_alive, new_id_map, n_slots = got
    rebuilt = list(stream())
    assert n_slots == sum(len(c[0]) for c in rebuilt)  # what a pass streams
    per_chunk_kept = [
        int((alive_c[s] & alive_c[d]).sum())
        for s, d, _ in ps.chunked_from_arrays(src, dst, w, chunk=100)()
    ]
    assert n_slots == sum(pow2_bucket(k, floor=256) for k in per_chunk_kept if k > 0)
    assert n_slots == want[3]
    np.testing.assert_array_equal(new_alive, want[1])
    np.testing.assert_array_equal(new_id_map, want[2])
    for a, b in zip(rebuilt, want[0]()):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _run_geo(mk, stream, n_nodes, eps=0.2, **kw):
    drv = mk(stream, n_nodes=n_nodes, eps=eps, compaction="geometric", **kw)
    return drv.run(resume=False), drv


def test_spill_ladder_bit_identical_and_out_of_core(tmp_path):
    edges, _ = planted_dense_subgraph(800, avg_deg=6, k=40, p_dense=0.8, seed=0)
    src, dst, w = _edges_np(edges)
    store = pel.save_edges_memmap(str(tmp_path / "store"), src, dst, w)
    stream = ps.chunked_from_memmap(store, chunk=512)

    off = rs.StreamingDensest(rs.chunked_from_arrays(src, dst, w, chunk=512),
                              n_nodes=edges.n_nodes, eps=0.2).run(resume=False)
    cap = 600  # the pipeline window (1 x 512) fits; the survivors do not
    with pytest.raises(RuntimeError, match="spill_dir"):
        _run_geo(_port_drv, stream, edges.n_nodes, residency_cap_edges=cap, prefetch=1)
    st, drv = _run_geo(_port_drv, stream, edges.n_nodes, spill_dir=str(tmp_path / "spill"),
                       residency_cap_edges=cap, prefetch=1)
    assert drv.compactions >= 1 and drv.spill_rungs == drv.compactions
    _same_state(st, off)
    assert drv.peak_resident_edges <= cap
    assert drv._cur_rung_dir is not None
    assert pel.open_edge_spill(drv._cur_rung_dir) is not None


def test_residency_cap_without_spill_raises(tmp_path):
    edges, _ = planted_dense_subgraph(800, avg_deg=6, k=40, p_dense=0.8, seed=0)
    src, dst, w = _edges_np(edges)
    for mk, mod in ((rs.StreamingDensest, rs), (_port_drv, ps)):
        stream = mod.chunked_from_arrays(src, dst, w, chunk=512)
        with pytest.raises(RuntimeError, match="spill_dir"):
            _run_geo(mk, stream, edges.n_nodes, residency_cap_edges=64)


@pytest.mark.parametrize("spill", [False, True])
def test_resume_mid_ladder_equivalence(tmp_path, spill):
    edges = erdos_renyi(600, avg_deg=8, seed=1)
    src, dst, w = _edges_np(edges)
    stream = ps.chunked_from_arrays(src, dst, w, chunk=500)
    ref, ref_drv = _run_geo(rs.StreamingDensest, stream, edges.n_nodes)
    assert ref_drv.compactions >= 1  # the scenario really is mid-ladder

    kw = dict(checkpoint_dir=str(tmp_path / "ck"))
    if spill:
        kw["spill_dir"] = str(tmp_path / "spill")
    drv1 = _port_drv(stream, edges.n_nodes, eps=0.2, compaction="geometric", **kw)
    st1 = drv1.run(max_passes=4, resume=False)
    assert st1.pass_idx == 4
    drv2 = _port_drv(stream, edges.n_nodes, eps=0.2, compaction="geometric", **kw)
    _same_state(drv2.run(resume=True), ref)
    if spill:
        assert drv1.spill_rungs >= 1  # the interrupted run spilled


def test_resume_never_adopts_foreign_spill_rung(tmp_path):
    edges = erdos_renyi(600, avg_deg=8, seed=1)
    src, dst, w = _edges_np(edges)
    stream = ps.chunked_from_arrays(src, dst, w, chunk=500)
    kw = dict(checkpoint_dir=str(tmp_path / "ck"), spill_dir=str(tmp_path / "spill"))
    a = _port_drv(stream, edges.n_nodes, eps=0.3, compaction="geometric", **kw)
    a.run(resume=False)
    assert a.spill_rungs >= 1
    ref, _ = _run_geo(rs.StreamingDensest, stream, edges.n_nodes)  # eps=0.2, no spill
    _port_drv(stream, edges.n_nodes, eps=0.2, compaction="geometric", **kw).run(
        max_passes=4, resume=False)
    st = _port_drv(stream, edges.n_nodes, eps=0.2, compaction="geometric", **kw).run(
        resume=True)
    _same_state(st, ref)


# ---------------------------------------------------------------------------
# Memmap edge stores + spill writer primitives, both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_edge_store_roundtrip(tmp_path, writer):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 100, 1000).astype(np.int32)
    dst = rng.integers(0, 100, 1000).astype(np.int32)
    w = rng.random(1000).astype(np.float32)
    save = pel.save_edges_memmap if writer == "port" else rel.save_edges_memmap
    store = save(str(tmp_path / "store"), src, dst, w)
    assert sorted(os.listdir(store)) == ["dst.npy", "src.npy", "weight.npy"]
    for opener in (pel.open_edges_memmap, rel.open_edges_memmap):
        s, d, ww = opener(store)
        np.testing.assert_array_equal(np.asarray(s), src)
        np.testing.assert_array_equal(np.asarray(d), dst)
        np.testing.assert_array_equal(np.asarray(ww), w)
    chunks = list(ps.chunked_from_memmap(store, 300)())
    assert [len(c[0]) for c in chunks] == [300, 300, 300, 100]
    np.testing.assert_array_equal(np.concatenate([c[2] for c in chunks]), w)
    ref_chunks = list(rs.chunked_from_memmap(store, 300)())
    for a, b in zip(chunks, ref_chunks):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("w_dtype", [np.float32, np.float16])
def test_spill_writer_atomic_manifest(tmp_path, writer, w_dtype):
    d = str(tmp_path / "spill")
    cls = pel.EdgeSpillWriter if writer == "port" else rel.EdgeSpillWriter
    wtr = cls(d, w_dtype)
    wtr.append(np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32),
               np.ones(4, w_dtype))
    assert pel.open_edge_spill(d) is None  # unfinalized: invisible
    assert rel.open_edge_spill(d) is None
    wtr.finalize(caps=[4], rung=0, n_pad=8, n_alive=4, n_nodes=9, eps=0.5, pass_idx=1)
    got, want = pel.open_edge_spill(d), rel.open_edge_spill(d)
    src, dst, w, man = got
    assert man["n_slots"] == 4 and man["caps"] == [4] and man["rung"] == 0
    assert man["w_dtype"] == np.dtype(w_dtype).str
    assert man == want[3]
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(src), np.arange(4))


# ---------------------------------------------------------------------------
# Front door: Problem knobs lower onto the driver
# ---------------------------------------------------------------------------


def _port(e):
    return from_reference(np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
                          np.asarray(e.mask), e.n_nodes, e.directed, "cpu")


def _same_result(got, ref, counters=True):
    for f in ("best_alive", "best_t", "best_size", "alive", "t_alive", "best_density",
              "history_n", "history_m", "history_rho"):
        assert getattr(got, f).numpy().tobytes() == np.asarray(getattr(ref, f)).tobytes(), f
    assert got.passes == int(ref.passes)
    assert set(got.extras["streaming"]) == set(ref.extras["streaming"])
    if counters:  # the same counters; speculative re-issues depend on thread timing
        timed = ("speculative_reissues",)
        assert {k: v for k, v in got.extras["streaming"].items() if k not in timed} == {
            k: v for k, v in ref.extras["streaming"].items() if k not in timed}
    assert got.provenance.substrate == ref.provenance.substrate == "streaming"


def test_problem_stream_knobs_lowering(tmp_path):
    edges = erdos_renyi(400, avg_deg=6, seed=5)
    ref = densest_subgraph(edges, eps=0.5)
    prob = dict(eps=0.5, substrate="streaming", compaction="geometric", stream_chunk=257,
                stream_prefetch=2, stream_workers=2, spill_dir=str(tmp_path / "spill"))
    res = api.solve(_port(edges), api.Problem.undirected(**prob))
    assert (res.best_alive.numpy() == np.asarray(ref.best_alive)).all()
    assert float(res.best_density) == pytest.approx(float(ref.best_density), rel=1e-6)
    info = res.extras["streaming"]
    assert 0 < info["peak_resident_chunks"] <= 2
    assert info["compactions"] == info["spill_rungs"]
    _same_result(res, ref_api.Solver().solve(edges, ref_api.Problem.undirected(**prob)))

    with pytest.raises(ValueError, match="stream_prefetch"):
        api.Problem.undirected(stream_prefetch=0)
    with pytest.raises(ValueError, match="residency_cap_edges"):
        api.Problem.undirected(residency_cap_edges=0)
    with pytest.raises(RuntimeError, match="residency_cap_edges"):
        api.solve(_port(edges), api.Problem.undirected(
            eps=0.5, substrate="streaming", compaction="geometric", stream_chunk=257,
            residency_cap_edges=1))
    with pytest.raises(ValueError, match="spill_dir"):
        api.Problem.undirected(substrate="streaming", compaction="off",
                               spill_dir="/x").resolve(100)
    auto_spill = api.Problem.undirected(substrate="streaming", spill_dir="/x").resolve(100)
    assert auto_spill.compaction == "geometric"
    with pytest.raises(ValueError, match="spill_dir"):
        ps.StreamingDensest(lambda: iter(()), n_nodes=4, spill_dir="/x", device="cpu")


@pytest.mark.parametrize("compaction", ["off", "geometric"])
def test_front_door_checkpoint_resume_equals_reference(tmp_path, compaction):
    """``solve(..., checkpoint_dir=, resume=)``: a run stopped after 2 passes
    and resumed through the front door equals the reference's solve."""
    edges = erdos_renyi(600, avg_deg=8, seed=1)
    prob = dict(eps=0.2, substrate="streaming", compaction=compaction, stream_chunk=500,
                track_history=True)
    ref = ref_api.Solver().solve(edges, ref_api.Problem.undirected(**prob))
    ck = str(tmp_path / "ck")
    api.solve(_port(edges), api.Problem.undirected(**prob, max_passes=2), checkpoint_dir=ck)
    got = api.solve(_port(edges), api.Problem.undirected(**prob), checkpoint_dir=ck,
                    resume=True)
    _same_result(got, ref, counters=False)  # a resumed ladder rebuilds anew


@pytest.mark.parametrize("kw", [dict(checkpoint_dir="/x"), dict(resume=True)])
def test_checkpoint_off_streaming_raises(kw):
    edges = erdos_renyi(50, avg_deg=4, seed=0)
    for mod, g in ((ref_api, edges), (api, _port(edges))):
        with pytest.raises(ValueError, match="only apply to substrate='streaming'"):
            mod.Solver().solve(g, mod.Problem.undirected(), **kw)


def test_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ps.StreamingDensest(lambda: iter(()), n_nodes=4)


# ---------------------------------------------------------------------------
# tests/test_streaming_mapreduce.py's streaming tests
# ---------------------------------------------------------------------------


def test_streaming_matches_in_memory():
    edges, _ = planted_dense_subgraph(800, avg_deg=4, k=30, p_dense=0.8, seed=0)
    ref = densest_subgraph(edges, eps=0.5)
    src, dst, w = _edges_np(edges)
    st = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=257), edges.n_nodes,
                   eps=0.5, n_workers=3).run(resume=False)
    assert st.best_rho == pytest.approx(float(ref.best_density), rel=1e-5)
    assert (st.best_alive == np.asarray(ref.best_alive)).all()
    assert st.pass_idx == int(ref.passes)
    _same_state(st, rs.StreamingDensest(rs.chunked_from_arrays(src, dst, w, chunk=257),
                                        n_nodes=edges.n_nodes, eps=0.5,
                                        n_workers=3).run(resume=False))


def test_streaming_checkpoint_restart(tmp_path):
    edges = erdos_renyi(600, avg_deg=8, seed=1)
    src, dst, w = _edges_np(edges)
    ref = densest_subgraph(edges, eps=0.5)
    ckpt = str(tmp_path / "ck")

    def drv():
        return _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=1000), edges.n_nodes,
                         eps=0.5, checkpoint_dir=ckpt, n_workers=2)

    assert drv().run(max_passes=2, resume=False).pass_idx == 2
    st = drv().run(resume=True)
    assert st.best_rho == pytest.approx(float(ref.best_density), rel=1e-5)
    assert (st.best_alive == np.asarray(ref.best_alive)).all()


def test_streaming_speculative_reissue_is_idempotent():
    edges = erdos_renyi(400, avg_deg=6, seed=2)
    src, dst, w = _edges_np(edges)
    ref = densest_subgraph(edges, eps=1.0)
    st = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=64), edges.n_nodes, eps=1.0,
                   n_workers=4, speculative=True, speculate_tail_frac=0.5).run(resume=False)
    assert st.best_rho == pytest.approx(float(ref.best_density), rel=1e-5)


# ---------------------------------------------------------------------------
# Cross-package checkpoints and spill rungs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("compaction", ["off", "geometric"])
def test_checkpoint_resumed_by_the_other_package(tmp_path, writer, compaction):
    """A ``stream_state.npz`` written by one package after 2 passes is
    resumed by the other to the uninterrupted answer, bitwise."""
    edges = erdos_renyi(600, avg_deg=8, seed=1)
    src, dst, w = _edges_np(edges)
    stream = ps.chunked_from_arrays(src, dst, w, chunk=300)
    kw = dict(n_nodes=edges.n_nodes, eps=0.2, compaction=compaction)
    want = rs.StreamingDensest(stream, **kw).run(resume=False)
    ck = str(tmp_path / "ck")
    first, second = ((rs.StreamingDensest, _port_drv) if writer == "ref"
                     else (_port_drv, rs.StreamingDensest))
    assert first(stream, checkpoint_dir=ck, **kw).run(max_passes=2, resume=False).pass_idx == 2
    z = dict(np.load(os.path.join(ck, "stream_state.npz")))
    assert {k: v.dtype.str for k, v in z.items()} == {
        "alive": "|b1", "best_alive": "|b1", "best_rho": "<f8", "pass_idx": "<i8",
        "history": "<f8"}
    _same_state(second(stream, checkpoint_dir=ck, **kw).run(resume=True), want)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_spill_rung_resumed_by_the_other_package(tmp_path, writer):
    """A run with a spill_dir stopped mid-ladder by one package: the other
    re-enters the ladder on its finalized rung and finishes bitwise."""
    edges = erdos_renyi(600, avg_deg=8, seed=1)
    src, dst, w = _edges_np(edges)
    stream = ps.chunked_from_arrays(src, dst, w, chunk=500)
    kw = dict(n_nodes=edges.n_nodes, eps=0.2, compaction="geometric")
    want = rs.StreamingDensest(stream, **kw).run(resume=False)
    dirs = dict(checkpoint_dir=str(tmp_path / "ck"), spill_dir=str(tmp_path / "spill"))
    first, second = ((rs.StreamingDensest, _port_drv) if writer == "ref"
                     else (_port_drv, rs.StreamingDensest))
    d1 = first(stream, **dirs, **kw)
    d1.run(max_passes=4, resume=False)
    assert d1.spill_rungs >= 1
    rung = d1._cur_rung_dir
    man = pel.open_edge_spill(rung)[3]
    assert man == rel.open_edge_spill(rung)[3]
    assert set(man) == {"caps", "n_pad", "n_alive", "n_nodes", "eps", "pass_idx", "rung",
                        "n_slots", "w_dtype"}
    d2 = second(stream, **dirs, **kw)
    _same_state(d2.run(resume=True), want)
    assert d2.compactions >= d1.compactions


# ---------------------------------------------------------------------------
# The port's fault sites
# ---------------------------------------------------------------------------


SITE_CHUNK = "streaming.chunk"


def test_deterministic_chunk_failure_surfaces_after_exactly_one_retry(graph):
    edges, (src, dst, w) = graph
    plan = FaultPlan().fail_nth(SITE_CHUNK, 1, 2, key=2)  # attempt AND retry
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=97), edges.n_nodes, n_workers=3)
    with faults.active(plan):
        with pytest.raises(InjectedFault) as exc:
            drv.run(max_passes=2, resume=False)
    assert exc.value.key == 2
    assert plan.hits_at(SITE_CHUNK, 2) == 2
    assert drv.speculative_reissues == 1


def test_fault_storm_recovers_bit_identically(graph):
    """``fail_nth`` on a few chunk keys plus latency on one: the answer is
    the reference's, with at least one re-issue."""
    edges, (src, dst, w) = graph
    ref = rs.StreamingDensest(rs.chunked_from_arrays(src, dst, w, chunk=97),
                              n_nodes=edges.n_nodes).run(resume=False)
    plan = FaultPlan(seed=0).latency(SITE_CHUNK, 0.05, key=1, nth=(1,))
    for k in (0, 2, 5):
        plan = plan.fail_nth(SITE_CHUNK, 1, key=k)
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=97), edges.n_nodes, n_workers=3)
    with faults.active(plan):
        st = drv.run(resume=False)
    assert drv.speculative_reissues >= 3
    _same_state(st, ref)


def test_checkpoint_load_fault_quarantines_and_save_fault_surfaces(graph, tmp_path):
    edges, (src, dst, w) = graph
    stream = ps.chunked_from_arrays(src, dst, w, chunk=128)
    ck = str(tmp_path / "ck")
    ref = _port_drv(stream, edges.n_nodes).run(max_passes=2, resume=False)
    _port_drv(stream, edges.n_nodes, checkpoint_dir=ck).run(max_passes=2, resume=False)
    plan = FaultPlan().fail_nth("streaming.checkpoint_load", 1)
    with faults.active(plan):
        with pytest.warns(RuntimeWarning, match="quarantined"):
            st = _port_drv(stream, edges.n_nodes, checkpoint_dir=ck).run(
                max_passes=2, resume=True)
    assert os.path.exists(os.path.join(ck, "stream_state.npz.corrupt"))
    _same_state(st, ref)
    with faults.active(FaultPlan().fail_nth("streaming.checkpoint_save", 1)):
        with pytest.raises(InjectedFault):
            _port_drv(stream, edges.n_nodes, checkpoint_dir=str(tmp_path / "ck2")).run(
                max_passes=2, resume=False)


def test_spill_publish_fault_aborts_the_partial_rung(tmp_path):
    edges, _ = planted_dense_subgraph(800, avg_deg=6, k=40, p_dense=0.8, seed=0)
    src, dst, w = _edges_np(edges)
    spill = tmp_path / "spill"
    drv = _port_drv(ps.chunked_from_arrays(src, dst, w, chunk=512), edges.n_nodes, eps=0.2,
                    compaction="geometric", spill_dir=str(spill))
    with faults.active(FaultPlan().fail_nth("edgelist.spill_publish", 1)):
        with pytest.raises(InjectedFault):
            drv.run(resume=False)
    if spill.is_dir():
        for name in os.listdir(spill):
            assert not os.path.exists(spill / name / "manifest.json")
