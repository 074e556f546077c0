"""Port parity: the turnstile runtime (``repro_torch.core.turnstile``) and
its ℓ0 sketch against ``repro.core.turnstile``.

The reference's own tests (tests/test_turnstile.py) are mirrored here on
the port, and wherever the reference is deterministic the two packages are
held equal: the sketch tensors, the recovered edges and level, and the
query results, bit for bit.  The reference's one-compile-per-bucket test
has its counterpart in tests/test_torch_cuda.py (one K3 launch per batch on
the card).  Its serving test and the turnstile-service cases of
tests/test_resilience.py run the port's ``TurnstileDensityService`` beside
the reference's: the same densities, bit for bit, and the same ``stats()``
except ``update_trace_count``, which counts the reference's compiles and
the port's K3 builds (none on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as ref_api
from repro import faults as ref_faults
from repro.core.turnstile import TurnstileDensest as RefDensest
from repro.core.turnstile import TurnstileSketch as RefSketch
from repro.graph.edgelist import apply_updates as ref_apply_updates
from repro.graph.edgelist import from_numpy as ref_from_numpy
from repro.graph.generators import chung_lu_power_law, planted_dense_subgraph
from repro.kernels.l0_sampler import ops as ref_l0
from repro_torch import faults
from repro_torch.core import api
from repro_torch.core.turnstile import TurnstileDensest, TurnstileSketch
from repro_torch.graph.edgelist import apply_updates, from_numpy, from_reference
from repro_torch.kernels.l0_sampler import ops as l0

CPU = "cpu"
FIELDS = ("best_alive", "best_density", "best_size", "alive", "history_n", "history_m",
          "history_rho")


def _live_edges(g):
    m = int(np.asarray(g.mask).sum())
    return np.asarray(g.src)[:m].copy(), np.asarray(g.dst)[:m].copy()


def _edge_keys(u, v, n):
    lo = np.minimum(u, v).astype(np.int64)
    hi = np.maximum(u, v).astype(np.int64)
    return lo * n + hi


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, CPU,
    )


def _bits(x):
    return x.numpy().tobytes() if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()


def _same_tables(port_sketch, ref_sketch):
    np.testing.assert_array_equal(port_sketch.tables.numpy(), np.asarray(ref_sketch.tables))


def _same_result(got, want):
    for f in FIELDS:
        assert _bits(getattr(got, f)) == _bits(getattr(want, f)), f
    assert got.passes == int(want.passes)
    gi, wi = dict(got.extras["turnstile"]), dict(want.extras["turnstile"])
    np.testing.assert_array_equal(gi.pop("sample_nodes", []), wi.pop("sample_nodes", []))
    assert gi == wi
    assert dataclasses.asdict(got.provenance) == dataclasses.asdict(
        dataclasses.replace(want.provenance, cache_hit=False))


def _same_recovery(port_sketch, ref_sketch):
    e1, l1, i1 = port_sketch.recover()
    e2, l2, i2 = ref_sketch.recover()
    np.testing.assert_array_equal(e1, e2)
    assert e1.dtype == np.int32 and l1 == l2 and i1 == i2
    return e1, l1, i1


# -- sketch linearity ---------------------------------------------------------


def test_l0_delta_is_linear_and_equals_reference():
    """delta(A) + delta(B) == delta(A ∪ B) bit for bit, each equal to the
    reference's delta."""
    p = l0.make_l0_params(n_levels=12, n_cells=1 << 8, n_tables=3, seed=2)
    rp = ref_l0.make_l0_params(n_levels=12, n_cells=1 << 8, n_tables=3, seed=2)
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2000, 600).astype(np.int32)
    v = rng.integers(0, 2000, 600).astype(np.int32)
    s = np.where(rng.random(600) < 0.7, 1, -1).astype(np.int32)

    def delta(sl):
        got = l0.l0_delta(*(torch.from_numpy(a[sl]) for a in (u, v, s)), p)
        want = ref_l0.l0_delta(*(jnp.asarray(a[sl]) for a in (u, v, s)), rp, use_pallas=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return got

    dA, dB, dAB = delta(slice(0, 300)), delta(slice(300, None)), delta(slice(None))
    assert torch.equal(l0.add_wrapped(dA, dB), dAB)


def test_sketch_merge_equals_union_and_validates():
    g = chung_lu_power_law(600, seed=9)
    src, dst = _live_edges(g)
    half = len(src) // 2
    sA = TurnstileSketch(600, 1 << 9, seed=5, device=CPU).apply((src[:half], dst[:half]))
    sB = TurnstileSketch(600, 1 << 9, seed=5, device=CPU).apply((src[half:], dst[half:]))
    sAB = TurnstileSketch(600, 1 << 9, seed=5, device=CPU).apply((src, dst))
    sA.merge(sB)
    assert torch.equal(sA.tables, sAB.tables)
    _same_tables(sAB, RefSketch(600, 1 << 9, seed=5).apply((src, dst)))
    assert (sA.batches_applied, sA.updates_applied) == (2, len(src))
    with pytest.raises(ValueError, match="identical geometry"):
        sA.merge(TurnstileSketch(600, 1 << 9, seed=6, device=CPU))
    with pytest.raises(TypeError):
        sA.merge("not a sketch")


def test_insert_then_delete_restores_exact_zeros():
    g = chung_lu_power_law(500, seed=1)
    src, dst = _live_edges(g)
    sk = TurnstileSketch(500, 1 << 9, seed=0, device=CPU)
    sk.apply(insert_edges=(src, dst))
    assert sk.tables.any()
    sk.apply(delete_edges=(dst, src))  # reversed endpoints cancel after canonicalization
    assert not sk.tables.any()
    edges, level, info = sk.recover()
    assert len(edges) == 0 and level == 0 and info["exact"]


def test_same_seed_is_bit_reproducible_and_equals_reference():
    g = chung_lu_power_law(800, seed=3)
    src, dst = _live_edges(g)
    kw = dict(stream_mode="turnstile", sample_edges=1 << 10, sketch_seed=42)
    tds = [TurnstileDensest(800, api.Problem.undirected(**kw), solver=api.Solver(), device=CPU)
           for _ in range(2)]
    ref = RefDensest(800, ref_api.Problem.undirected(**kw), solver=ref_api.Solver())
    for td in (*tds, ref):
        td.apply(insert_edges=(src, dst))
        td.apply(delete_edges=(src[:50], dst[:50]))
    assert torch.equal(tds[0].sketch.tables, tds[1].sketch.tables)
    _same_tables(tds[0].sketch, ref.sketch)
    r0, r1 = tds[0].query(), tds[1].query()
    assert float(r0.best_density) == float(r1.best_density)
    _same_result(r0, ref.query())


def test_batch_padding_and_counters_match_reference():
    """Batches pad into the same pow2 buckets with sign-0 rows; the
    counters the reference keeps beside ``trace_count`` agree."""
    sk = TurnstileSketch(2000, 1 << 9, seed=0, device=CPU)
    ref = RefSketch(2000, 1 << 9, seed=0)
    rng = np.random.default_rng(0)
    for k in (500, 500, 3000):
        e = rng.integers(0, 2000, (k, 2)).astype(np.int32)
        sk.apply(insert_edges=e)
        ref.apply(insert_edges=e)
    _same_tables(sk, ref)
    assert (sk.batches_applied, sk.updates_applied) == (ref.batches_applied, ref.updates_applied)
    assert sk.apply() is sk and sk.batches_applied == 3  # an empty batch is no batch


# -- recovery -----------------------------------------------------------------


def test_exact_recovery_when_graph_fits_budget():
    g = chung_lu_power_law(400, seed=8)
    src, dst = _live_edges(g)
    sk = TurnstileSketch(400, 1 << 11, seed=1, device=CPU).apply((src, dst))
    edges, level, info = _same_recovery(sk, RefSketch(400, 1 << 11, seed=1).apply((src, dst)))
    assert level == 0 and info["exact"] and info["sample_rate"] == 1.0
    got = set(_edge_keys(edges[:, 0], edges[:, 1], 400).tolist())
    assert got == set(_edge_keys(src, dst, 400).tolist())


def test_recovery_never_fabricates_edges_at_tiny_cell_count():
    g = chung_lu_power_law(3000, avg_deg=4.0, seed=6)
    src, dst = _live_edges(g)
    sk = TurnstileSketch(3000, 256, seed=2, device=CPU).apply((src, dst))
    ref = RefSketch(3000, 256, seed=2).apply((src, dst))
    edges, level, info = _same_recovery(sk, ref)
    assert level > 0
    assert set(_edge_keys(edges[:, 0], edges[:, 1], 3000).tolist()) <= set(
        _edge_keys(src, dst, 3000).tolist())
    assert info["sample_edges_recovered"] == len(edges) <= info["level_suffix_count"]
    assert (sk.recovery_failures, sk.recovery_escalations) == (
        ref.recovery_failures, ref.recovery_escalations)


def test_corrupted_stream_degrades_but_never_fabricates():
    sks = [TurnstileSketch(100, 256, seed=0, device=CPU), RefSketch(100, 256, seed=0)]
    for sk in sks:
        sk.apply(insert_edges=np.asarray([[0, 1], [1, 2]]))
        sk.apply(delete_edges=np.asarray([[7, 9], [7, 9], [7, 9]]))  # count -3
    edges, level, info = _same_recovery(*sks)
    assert sks[0].recovery_failures >= 1 and level >= 1
    want = set(_edge_keys(np.asarray([0, 1]), np.asarray([1, 2]), 100).tolist())
    assert set(_edge_keys(edges[:, 0], edges[:, 1], 100).tolist()) <= want


def test_injected_decode_fault_escalates_like_the_reference():
    """``turnstile.decode`` is the port's fault site too: failing level
    l*'s decode climbs one level, in both packages alike."""
    g = chung_lu_power_law(1500, avg_deg=6, seed=4)
    src, dst = _live_edges(g)
    sks = [TurnstileSketch(1500, 1 << 10, seed=3, device=CPU), RefSketch(1500, 1 << 10, seed=3)]
    for sk in sks:
        sk.apply((src, dst))
    l_star = sks[0].recover()[1]
    plan = faults.FaultPlan(seed=0).fail_nth("turnstile.decode", 1, key=l_star)
    ref_plan = ref_faults.FaultPlan(seed=0).fail_nth("turnstile.decode", 1, key=l_star)
    with faults.active(plan) as pl, ref_faults.active(ref_plan):
        edges, level, info = _same_recovery(*sks)
    assert level == l_star + 1 and info["recovery_failures"] == 1
    assert pl.hits_at("turnstile.decode") == 2 and pl.failures_at("turnstile.decode") == 1
    assert faults.installed() is None and "turnstile.decode" in faults.KNOWN_SITES
    assert faults.KNOWN_SITES == ref_faults.KNOWN_SITES


# -- accuracy under churn (the MTVV envelope) ---------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_churn_density_within_envelope(seed):
    """Power-law background + planted block, 30% deletions: the sampled
    peel stays within (1+eps)(2+2eps) of the exact peel of the surviving
    graph (apply_updates), and equals the reference's query bit for bit."""
    n, eps = 4000, 0.3
    g, _ = planted_dense_subgraph(n, 6.0, 120, 0.6, seed=seed)
    src, dst = _live_edges(g)
    m = len(src)
    rng = np.random.default_rng(1000 + seed)
    del_idx = rng.choice(m, size=int(0.3 * m), replace=False)
    deletes = np.stack([src[del_idx], dst[del_idx]], axis=1)
    final, stats = apply_updates(from_numpy(src, dst, n, device=CPU), deletes=deletes)
    assert stats["deleted"] == len(del_idx) and stats["missing_deletes"] == 0

    kw = dict(eps=eps, stream_mode="turnstile", sample_edges=1 << 11, sketch_seed=seed)
    td = TurnstileDensest(n, api.Problem.undirected(**kw), solver=api.Solver(), device=CPU)
    ref = RefDensest(n, ref_api.Problem.undirected(**kw), solver=ref_api.Solver())
    for d in (td, ref):
        d.apply(insert_edges=(src, dst))
        d.apply(delete_edges=(deletes[:, 0], deletes[:, 1]))
    _same_tables(td.sketch, ref.sketch)
    res = td.query()
    _same_result(res, ref.query())
    assert res.extras["turnstile"]["level"] >= 1

    exact = api.solve(final, api.Problem.undirected(eps=eps, compaction="off"))
    envelope = (1 + eps) * (2 + 2 * eps)
    ratio = float(res.best_density) / float(exact.best_density)
    assert 1.0 / envelope <= ratio <= envelope, ratio


# -- front door ---------------------------------------------------------------


def test_problem_validation_matrix():
    with pytest.raises(ValueError, match="stream_mode"):
        api.Problem.undirected(stream_mode="bogus")
    with pytest.raises(ValueError, match="sample_edges"):
        api.Problem.undirected(stream_mode="turnstile", sample_edges=0)
    with pytest.raises(ValueError, match="objective='undirected'"):
        api.Problem.directed(stream_mode="turnstile").resolve(100)
    with pytest.raises(ValueError, match="sketch a sketch"):
        api.Problem.undirected(stream_mode="turnstile", backend="sketch").resolve(100)
    with pytest.raises(ValueError, match="substrate"):
        api.Problem.undirected(stream_mode="turnstile", substrate="mesh").resolve(100)
    p = api.Problem.undirected(stream_mode="turnstile", compaction="geometric").resolve(100)
    assert p.compaction == "off" and p.substrate == "jit" and p.backend == "exact"
    with pytest.raises(ValueError, match="stream_mode='turnstile'"):
        TurnstileDensest(100, api.Problem.undirected(), device=CPU)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
def test_one_shot_solve_matches_insert_mode_and_reference(backend):
    """m <= tau: the front-door turnstile solve recovers the whole graph at
    level 0; its density equals the insert-mode solve, and every field
    equals the reference's one-shot solve."""
    g = chung_lu_power_law(1200, seed=5)
    kw = dict(stream_mode="turnstile", backend=backend, track_history=True)
    r_t = api.solve(_port(g), api.Problem.undirected(**kw))
    r_i = api.solve(_port(g), api.Problem.undirected(compaction="off"))
    assert float(r_t.best_density) == pytest.approx(float(r_i.best_density))
    info = r_t.extras["turnstile"]
    assert info["exact"] and info["level"] == 0
    assert r_t.provenance.substrate == "turnstile" and r_t.provenance.backend == backend
    _same_result(r_t, ref_api.Solver().solve(g, ref_api.Problem.undirected(**kw)))


def test_solve_turnstile_rejects_directed_and_weighted():
    src = np.asarray([0, 1, 2], np.int32)
    dst = np.asarray([1, 2, 0], np.int32)
    d = from_numpy(src, dst, 3, directed=True, device=CPU)
    with pytest.raises(ValueError, match="undirected"):
        api.solve(d, api.Problem.undirected(stream_mode="turnstile"))
    w = from_numpy(src, dst, 3, weight=np.asarray([2.0, 1.0, 1.0], np.float32), device=CPU)
    with pytest.raises(ValueError, match="unweighted"):
        api.solve(w, api.Problem.undirected(stream_mode="turnstile"))


def test_empty_sketch_query_is_well_defined():
    td = TurnstileDensest(50, api.Problem.undirected(stream_mode="turnstile"), device=CPU)
    res = td.query()
    assert float(res.best_density) == 0.0
    assert res.extras["turnstile"]["sample_edges_recovered"] == 0
    _same_result(res, RefDensest(50, ref_api.Problem.undirected(stream_mode="turnstile"),
                                 solver=ref_api.Solver()).query())


def test_sketch_takes_tensor_batches_where_they_lie():
    g = chung_lu_power_law(700, seed=2)
    src, dst = _live_edges(g)
    a = TurnstileSketch(700, 1 << 9, seed=1, device=CPU).apply(
        (torch.from_numpy(src), torch.from_numpy(dst)))
    b = TurnstileSketch(700, 1 << 9, seed=1, device=CPU).apply(np.stack([src, dst], 1))
    assert torch.equal(a.tables, b.tables)
    with pytest.raises(ValueError, match="edge batch"):
        a.apply(insert_edges=np.zeros((3, 3), np.int32))


# -- exact host reference (apply_updates) -------------------------------------


def test_apply_updates_semantics_match_reference():
    args = (np.asarray([0, 1, 2], np.int32), np.asarray([1, 2, 3], np.int32), 5)
    base, ref_base = from_numpy(*args, device=CPU), ref_from_numpy(*args)
    ins = np.asarray([[3, 4], [4, 3]])  # within-batch dup collapses
    dels = np.asarray([[2, 1], [0, 4]])  # one live, one missing
    out, stats = apply_updates(base, inserts=ins, deletes=dels)
    ref_out, ref_stats = ref_apply_updates(ref_base, inserts=ins, deletes=dels)
    assert stats == ref_stats == {
        "dup_inserts": 1, "missing_deletes": 1, "deleted": 1, "inserted": 1,
    }
    for f in ("src", "dst", "weight", "mask"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref_out, f)))
    np.testing.assert_array_equal(out.src.numpy(), [0, 2, 3])
    np.testing.assert_array_equal(out.dst.numpy(), [1, 3, 4])
    assert out.device == torch.device(CPU)
    out2, stats2 = apply_updates(out, inserts=np.asarray([[1, 0]]))
    assert stats2["dup_inserts"] == 1 and stats2["inserted"] == 0
    assert torch.equal(out2.src, out.src)
    with pytest.raises(ValueError, match="must not insert and delete"):
        apply_updates(base, inserts=np.asarray([[0, 1]]), deletes=np.asarray([[1, 0]]))


# -- property: update-linearity on arbitrary stream splits --------------------


@pytest.mark.parametrize("seed,cut", [(0, 1), (1, 37), (2, 80), (3, 50), (4, 99)])
def test_property_split_invariance(seed, cut):
    """Any split of an update stream into batches yields the same sketch,
    equal to the reference's."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 500, (100, 2)).astype(np.int32)
    cut = min(cut, 99)
    one = TurnstileSketch(500, 256, seed=9, device=CPU).apply(insert_edges=e)
    two = (TurnstileSketch(500, 256, seed=9, device=CPU)
           .apply(insert_edges=e[:cut]).apply(insert_edges=e[cut:]))
    assert torch.equal(one.tables, two.tables)
    _same_tables(one, RefSketch(500, 256, seed=9).apply(insert_edges=e))


# -- serving: the density service ----------------------------------------------


def _services(n, serve_stale=True, **kw):
    from repro.serve import TurnstileDensityService as RefService
    from repro_torch.serve import TurnstileDensityService

    prob = dict(stream_mode="turnstile", **kw)
    return (TurnstileDensityService(n, api.Problem.undirected(**prob), serve_stale=serve_stale,
                                    device=CPU),
            RefService(n, ref_api.Problem.undirected(**prob), serve_stale=serve_stale))


def _same_stats(svc, ref):
    got, want = svc.stats(), ref.stats()
    assert sorted(got) == sorted(want)
    assert got.pop("update_trace_count") == 0  # no K3 build on the CPU
    want.pop("update_trace_count")
    assert got == want


def test_serve_service_caches_between_updates():
    from repro.serve import DensestQueryEngine as RefEngine
    from repro_torch.serve import DensestQueryEngine, TurnstileDensityService

    g = chung_lu_power_law(700, seed=2)
    src, dst = _live_edges(g)
    pair = _services(700, sample_edges=1 << 10)
    densities = []
    for svc in pair:
        svc.apply(insert_edges=(src, dst))
        d1, d2 = svc.density(), svc.density()  # no update between: the cache
        assert d1 == d2
        assert svc.stats()["queries_served"] == 2 and svc.stats()["queries_computed"] == 1
        svc.apply(delete_edges=(src[:40], dst[:40]))
        densities.append((d1, svc.density()))
        assert svc.stats()["queries_computed"] == 2
    assert densities[0] == densities[1]
    _same_stats(*pair)
    svc = pair[0]
    eng = DensestQueryEngine(_port(g)).attach_turnstile(svc)
    assert eng.current_density() == svc.density()
    assert svc.stats()["queries_computed"] == 2  # attachment reads the cache
    assert RefEngine(g).attach_turnstile(pair[1]).current_density() == eng.current_density()
    with pytest.raises(ValueError, match="n_nodes"):
        DensestQueryEngine(_port(g)).attach_turnstile(TurnstileDensityService(701, device=CPU))
    with pytest.raises(ValueError, match="attach_turnstile"):
        DensestQueryEngine(_port(g)).current_density()


def test_service_serves_stale_on_recovery_failure():
    rng = np.random.default_rng(0)
    e1 = rng.integers(0, 300, size=(200, 2)).astype(np.int32)
    e1 = e1[e1[:, 0] != e1[:, 1]]
    e2 = np.asarray([[1, 2], [2, 3], [1, 3]], np.int32)
    pair = _services(300, sample_edges=1 << 10)
    for svc, module in zip(pair, (faults, ref_faults)):
        svc.apply(insert_edges=e1)
        d0 = svc.density()
        svc.apply(insert_edges=e2)  # marks the cached answer stale
        with module.active(module.FaultPlan().fail_prob("turnstile.decode", 1.0)):
            assert svc.density() == d0  # recompute fails: the last good answer
        st = svc.stats()
        assert st["stale_results_served"] == 1 and st["queries_failed"] == 1
        assert "recovery failed" in st["last_error"] and "disk_store_errors" in st
        before = svc.queries_computed
        assert np.isfinite(svc.density())  # the dirty flag survived
        assert svc.queries_computed == before + 1
    _same_stats(*pair)
    assert pair[0].density() == pair[1].density()


def test_service_serve_stale_off_raises():
    for svc, module in zip(_services(100, serve_stale=False, sample_edges=1 << 8),
                           (faults, ref_faults)):
        svc.apply(insert_edges=np.asarray([[0, 1], [1, 2]], np.int32))
        svc.density()
        svc.apply(insert_edges=np.asarray([[2, 3]], np.int32))
        with module.active(module.FaultPlan().fail_prob("turnstile.decode", 1.0)):
            with pytest.raises(RuntimeError):
                svc.density()
