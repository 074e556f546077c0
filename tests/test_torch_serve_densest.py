"""Port parity: per-seed serving (``repro_torch.serve.densest`` with
``serve/resilience.py``) against the JAX package's.

Mirrors, case by case, tests/test_serve_densest.py, the serving half of
tests/test_local.py, tests/test_property_serve.py (the fixed corpus and
the hypothesis sweep at the reference's example count) and the serving
half of tests/test_resilience.py.  In each, the port's engine and the
reference's engine answer the same query stream on the same graph (the
reference generator's arrays) under the same injected clock and the same
``FaultPlan`` (each package installs its own copy of the plan), and every
``QueryResult`` field is compared: nodes, density bits, bucket, status,
fallback, error, attempts, latency.  ``stats()`` is compared key by key.

The reference's tests that count program traces
(``test_coalesced_buckets_share_programs``) become bucket checks here:
the port has no programs, and both packages must land the same stream on
the same ``(n_b, m_b)`` buckets and lane counts.  Its disk-cache test
(``test_disk_cache_threads_through_engine``) becomes a check that the
engine's ``cache_dir`` reaches the kernels its solves load
(tests/test_torch_progcache.py holds the cache itself).
"""

import collections
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import repro.core.api as ref_api
from repro import faults as ref_faults
from repro.core import densest_subgraph_brute
from repro.graph.edgelist import from_numpy as ref_from_numpy
from repro.graph.edgelist import to_csr as ref_to_csr
from repro.graph.generators import chung_lu_power_law, planted_dense_subgraph
from repro.serve.densest import DensestQueryEngine as RefEngine
from repro.serve.resilience import CircuitBreaker as RefBreaker
from repro.serve.resilience import ResilienceConfig as RefConfig
from repro_torch import faults, kernels
from repro_torch.core import api
from repro_torch.graph.edgelist import EdgeList, from_numpy, from_reference
from repro_torch.graph.partition import pow2_bucket
from repro_torch.serve import DensestQueryEngine, ResilienceConfig
from repro_torch.serve.resilience import CircuitBreaker

EPS = 0.5
PROB = api.Problem.undirected(eps=EPS, compaction="off")
REF_PROB = ref_api.Problem.undirected(eps=EPS, compaction="off")
RESULT_FIELDS = ("qid", "seed", "nodes", "density", "seed_in_set", "n_ego", "m_ego", "bucket",
                 "latency_s", "status", "fallback", "error", "attempts")
# Shared reference solvers: each (bucket, lanes) shape compiles once per
# solver for the whole module.
_REF_SOLVER = ref_api.Solver()


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    assert faults.installed() is None and ref_faults.installed() is None
    yield
    faults.uninstall()
    ref_faults.uninstall()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _graph(n=800, seed=0, avg_deg=6.0):
    return chung_lu_power_law(n, exponent=2.0, avg_deg=avg_deg, seed=seed)


def _ref_config(cfg):
    return None if cfg is None else RefConfig(**dataclasses.asdict(cfg))


class _Pair:
    """The port's engine and the reference's over the same graph, built
    with the same knobs; each gets its own clock and a log of its backoff
    sleeps, driven alike."""

    def __init__(self, ref_g, problem=PROB, ref_problem=REF_PROB, *, resilience=None, **kw):
        kw.setdefault("max_wait_ms", 0.0)
        self.clock, self.ref_clock = _Clock(), _Clock()
        self.slept, self.ref_slept = [], []
        self.port = DensestQueryEngine(
            _port(ref_g), problem, time_fn=self.clock, resilience=resilience,
            sleep_fn=self.slept.append, **kw)
        self.ref = RefEngine(
            ref_g, ref_problem, solver=_REF_SOLVER, time_fn=self.ref_clock,
            resilience=_ref_config(resilience), sleep_fn=self.ref_slept.append, **kw)

    def advance(self, dt):
        self.clock.t += dt
        self.ref_clock.t += dt

    def both(self, fn, plan=None):
        """``fn(engine)`` on each engine, under ``plan(faults_module)``'s
        plan in each package when given; results compared field by field."""
        got = self._run(fn, self.port, faults, plan)
        want = self._run(fn, self.ref, ref_faults, plan)
        same_results(got, want)
        assert self.port.stats() == self.ref.stats()
        assert self.slept == self.ref_slept
        return got

    @staticmethod
    def _run(fn, eng, module, plan):
        if plan is None:
            return fn(eng)
        with module.active(plan(module)):
            return fn(eng)


def same_results(got, want):
    if not isinstance(got, list):
        got, want = [got], [want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if not hasattr(a, "status"):  # a qid, a count: plain equality
            assert a == b
            continue
        for f in RESULT_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if f == "nodes":
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            elif f == "density":
                assert np.float64(x).tobytes() == np.float64(y).tobytes(), (x, y)
            else:
                assert x == y and type(x) is type(y), (f, x, y)


# ---------------------------------------------------------------------------
# extraction (tests/test_serve_densest.py)
# ---------------------------------------------------------------------------


def _ref_ego(src, dst, w, seed, radius):
    """Set-based BFS + induced subgraph over the raw edge list."""
    adj = collections.defaultdict(set)
    for u, v in zip(src.tolist(), dst.tolist()):
        adj[u].add(v)
        adj[v].add(u)
    members, frontier = {seed}, {seed}
    for _ in range(radius):
        nxt = set()
        for u in frontier:
            nxt |= adj[u]
        frontier = nxt - members
        members |= frontier
        if not frontier:
            break
    nodes = np.asarray(sorted(members), np.int64)
    keep = np.isin(src, nodes) & np.isin(dst, nodes)
    return nodes, np.minimum(src[keep], dst[keep]), np.maximum(src[keep], dst[keep]), w[keep]


def test_ego_extraction_matches_reference_bfs():
    ref_g = _graph(n=600, seed=3)
    pair = _Pair(ref_g, radius=2)
    mask = np.asarray(ref_g.mask)
    src, dst, w = (np.asarray(a)[mask] for a in (ref_g.src, ref_g.dst, ref_g.weight))
    for seed in np.random.default_rng(0).integers(0, 600, 12).tolist():
        padded, nodes = pair.port.extract(seed)
        ref_padded, ref_nodes = pair.ref.extract(seed)
        np.testing.assert_array_equal(nodes, ref_nodes)
        assert padded.n_nodes == ref_padded.n_nodes
        for f in ("src", "dst", "weight", "mask"):
            assert getattr(padded, f).numpy().tobytes() == np.asarray(
                getattr(ref_padded, f)).tobytes(), f
        want_nodes, es, ed, ew = _ref_ego(src, dst, w, seed, 2)
        assert np.array_equal(nodes, want_nodes)
        msk = padded.mask.numpy()
        gs, gd = nodes[padded.src.numpy()[msk]], nodes[padded.dst.numpy()[msk]]
        gw = padded.weight.numpy()[msk]
        lo, hi = np.minimum(gs, gd), np.maximum(gs, gd)
        oe, og = np.lexsort((hi, lo)), np.lexsort((ed, es))
        assert np.array_equal(lo[oe], es[og]) and np.array_equal(hi[oe], ed[og])
        assert np.array_equal(gw[oe], ew[og])


def test_extracted_peel_matches_full_graph_restriction():
    ref_g = _graph(n=500, seed=7)
    pair = _Pair(ref_g, radius=2)
    mask = np.asarray(ref_g.mask)
    src, dst, w = (np.asarray(a)[mask] for a in (ref_g.src, ref_g.dst, ref_g.weight))
    degs = np.diff(ref_to_csr(ref_g)[0])
    for seed in np.nonzero(degs > 0)[0][[0, 7, 42]].tolist():
        padded, nodes = pair.port.extract(seed)
        ref_nodes, es, ed, ew = _ref_ego(src, dst, w, seed, 2)
        relabel = {int(n): i for i, n in enumerate(ref_nodes)}
        rs = np.asarray([relabel[int(u)] for u in es], np.int32)
        rd = np.asarray([relabel[int(v)] for v in ed], np.int32)
        ref = from_numpy(rs, rd, pow2_bucket(len(ref_nodes), pair.port.node_floor),
                         weight=ew, device="cpu").with_padding(padded.n_edges_padded)
        a, b = api.solve(padded, PROB), api.solve(ref, PROB)
        assert float(a.best_density) == float(b.best_density)
        sa, sb = a.nodes(), b.nodes()
        assert np.array_equal(nodes[sa[sa < len(nodes)]], ref_nodes[sb[sb < len(ref_nodes)]])


# ---------------------------------------------------------------------------
# bucket coalescing: bitwise lanes, the reference's buckets
# ---------------------------------------------------------------------------


def test_batched_answers_bit_identical_to_sequential_solve():
    ref_g = _graph(n=900, seed=1)
    pair = _Pair(ref_g, radius=2, max_batch=8)
    seeds = np.random.default_rng(2).integers(0, 900, 24).tolist()
    results = pair.both(lambda e: e.query_many(seeds))
    assert [r.seed for r in results] == seeds
    seq = api.Solver()
    for r in results:
        padded, nodes = pair.port.extract(r.seed)
        ref = seq.solve(padded, PROB)
        assert float(ref.best_density) == r.density
        ba = ref.nodes()
        assert np.array_equal(nodes[ba[ba < len(nodes)]], r.nodes)
        assert r.seed_in_set == bool(np.isin(r.seed, r.nodes))


def test_coalesced_buckets_match_reference():
    """The reference's no-new-programs test: the same stream lands on the
    same (n_b, m_b) buckets with the same lane counts in both packages,
    every bucket and lane count a power of two, and a second pass of the
    stream adds no bucket."""
    ref_g = _graph(n=900, seed=1)
    pair = _Pair(ref_g, radius=1, max_batch=8)
    seeds = np.random.default_rng(5).integers(0, 900, 32).tolist()
    pair.both(lambda e: e.query_many(seeds))
    first = dict(pair.port.bucket_histogram)
    assert first == pair.ref.bucket_histogram
    pair.both(lambda e: e.query_many(seeds))
    assert set(pair.port.bucket_histogram) == set(first)
    assert pair.port.bucket_histogram == pair.ref.bucket_histogram
    assert pair.port.lanes_solved >= len(seeds)
    for (n_b, m_b), lanes in pair.port.bucket_histogram.items():
        assert n_b == pow2_bucket(n_b) and m_b == pow2_bucket(m_b)


def test_group_moves_to_the_device_once_per_leaf(monkeypatch):
    """A bucket group crosses to the engine's device as one stacked
    EdgeList (one copy per leaf) and solves as ONE stacked solve_batch;
    best_alive and best_density come back in one copy."""
    from repro_torch import hostsync

    ref_g = _graph(n=300)
    eng = DensestQueryEngine(_port(ref_g), PROB, radius=1, max_batch=8, max_wait_ms=0.0)
    calls = []
    real = eng.solver.solve_batch

    def spy(graph, problem, **kw):
        calls.append((graph.src.shape, graph.src.device))
        return real(graph, problem, **kw)

    monkeypatch.setattr(eng.solver, "solve_batch", spy)
    moved = []
    real_to = EdgeList.to
    monkeypatch.setattr(EdgeList, "to", lambda self, dev: moved.append(dev) or real_to(self, dev))
    fetched = []
    real_fetch = hostsync.fetch
    monkeypatch.setattr(hostsync, "fetch", lambda x: fetched.append(x.shape) or real_fetch(x))
    out = eng.query_many([1, 2, 3])
    groups = {r.bucket for r in out}
    assert len(calls) == len(moved) == len(fetched) == len(groups)
    assert sorted(tuple(shape) for shape, _ in calls) == sorted((l, m) for _, m, l in groups)
    assert all(dev == eng.device for _, dev in calls)


# ---------------------------------------------------------------------------
# micro-batching mechanics
# ---------------------------------------------------------------------------


def test_deadline_flush_under_injected_clock():
    pair = _Pair(_graph(n=300), max_batch=8, max_wait_ms=10.0)
    pair.both(lambda e: e.submit(3))
    assert pair.both(lambda e: e.step()) == []  # not full, not old
    assert pair.port.pending() == pair.ref.pending() == 1
    pair.advance(0.009)
    assert pair.both(lambda e: e.step()) == []  # 9ms < 10ms
    pair.advance(0.002)
    out = pair.both(lambda e: e.step())  # oldest aged past the deadline
    assert len(out) == 1 and out[0].seed == 3
    assert out[0].latency_s == pytest.approx(0.011)
    assert pair.port.pending() == 0


def test_full_batch_flushes_without_deadline():
    pair = _Pair(_graph(n=300), max_batch=4, max_wait_ms=1e9)
    for s in range(3):
        pair.both(lambda e: e.submit(s))
    assert pair.both(lambda e: e.step()) == []
    pair.both(lambda e: e.submit(3))
    out = pair.both(lambda e: e.step())
    assert [r.seed for r in out] == [0, 1, 2, 3]
    assert pair.port.batches_flushed == 1


def test_queue_is_a_deque_and_fifo():
    pair = _Pair(_graph(n=300), max_batch=2)
    assert isinstance(pair.port._queue, collections.deque)
    qids = [pair.port.submit(s) for s in (5, 6, 7)]
    [pair.ref.submit(s) for s in (5, 6, 7)]
    out = pair.both(lambda e: e.flush())
    assert [r.qid for r in out] == qids
    assert pair.port.batches_flushed == 2


def test_lane_padding_is_pow2():
    pair = _Pair(_graph(n=300), radius=1, max_batch=8)
    pair.both(lambda e: e.query_many([1, 2, 3]))
    assert pair.port.lanes_solved == sum(pair.port.bucket_histogram.values())
    for lanes in pair.port.bucket_histogram.values():
        assert lanes == pow2_bucket(lanes)


# ---------------------------------------------------------------------------
# edge cases + validation
# ---------------------------------------------------------------------------


def test_isolated_seed():
    pair = _Pair(ref_from_numpy(np.asarray([0, 1]), np.asarray([1, 2]), 5))
    r = pair.both(lambda e: e.query(4))
    assert r.n_ego == 1 and r.m_ego == 0 and r.density == 0.0
    assert np.array_equal(r.nodes, [4])


def test_radius_covers_whole_component():
    pair = _Pair(ref_from_numpy(np.asarray([0, 1, 2]), np.asarray([1, 2, 3]), 4), radius=3)
    padded, nodes = pair.port.extract(0)
    assert np.array_equal(nodes, [0, 1, 2, 3])
    assert int(padded.mask.sum()) == 3
    pair.both(lambda e: e.query(0))


def test_max_ego_nodes_truncates_deterministically():
    ref_g = _graph(n=600, seed=3)
    pair = _Pair(ref_g, radius=2, max_ego_nodes=20)
    seed = int(np.argmax(np.diff(ref_to_csr(ref_g)[0])))
    _, nodes = pair.port.extract(seed)
    assert len(nodes) <= 20
    np.testing.assert_array_equal(nodes, pair.port.extract(seed)[1])
    np.testing.assert_array_equal(nodes, pair.ref.extract(seed)[1])
    pair.both(lambda e: e.query(seed))


def test_scratch_membership_resets_between_queries():
    eng = DensestQueryEngine(_port(_graph(n=400, seed=2)), PROB, radius=2, max_wait_ms=0.0)
    _, n1 = eng.extract(7)
    assert not eng._member.any()
    np.testing.assert_array_equal(n1, eng.extract(7)[1])


def test_validation():
    g = _port(_graph(n=300))
    directed = EdgeList(src=g.src, dst=g.dst, weight=g.weight, mask=g.mask,
                        n_nodes=g.n_nodes, directed=True)
    with pytest.raises(ValueError, match="undirected"):
        DensestQueryEngine(directed, PROB)
    with pytest.raises(ValueError, match="substrate"):
        DensestQueryEngine(g, api.Problem.undirected(substrate="streaming"))
    with pytest.raises(ValueError, match="directed"):
        DensestQueryEngine(g, api.Problem.directed())
    with pytest.raises(ValueError, match="backend"):
        DensestQueryEngine(g, api.Problem.undirected(backend="pallas"))
    with pytest.raises(ValueError, match="radius"):
        DensestQueryEngine(g, PROB, radius=0)
    with pytest.raises(ValueError, match="max_batch"):
        DensestQueryEngine(g, PROB, max_batch=0)
    with pytest.raises(ValueError, match="max_wait_ms"):
        DensestQueryEngine(g, PROB, max_wait_ms=-1.0)
    with pytest.raises(ValueError, match="seed"):
        DensestQueryEngine(g, PROB).submit(300)
    with pytest.raises(ValueError, match="seed"):
        DensestQueryEngine(g, PROB).extract(-1)


def test_submit_rejects_bad_seeds_eagerly():
    eng = DensestQueryEngine(_port(_graph(n=300)), PROB, max_wait_ms=0.0)
    for bad in (2.5, np.float64(2.0), True, np.bool_(False), "5", None):
        with pytest.raises(TypeError, match="seed"):
            eng.submit(bad)
    for bad in (-1, 300, np.int64(10_000)):
        with pytest.raises(ValueError, match="seed"):
            eng.submit(bad)
    qid = eng.submit(np.int64(5))
    (res,) = eng.flush()
    assert res.qid == qid and res.status == "ok" and type(res.seed) is int


def test_per_query_knob_validation():
    eng = DensestQueryEngine(_port(_graph(n=300)), PROB, max_wait_ms=0.0)
    with pytest.raises(ValueError, match="radius"):
        eng.submit(5, 0)
    with pytest.raises(TypeError, match="radius"):
        eng.submit(5, 1.5)
    with pytest.raises(ValueError, match="budget"):
        eng.submit(5, budget=16)


def test_works_with_at_least_k_objective():
    ref_g = _graph(n=400, seed=4)
    prob = api.Problem.at_least_k(k=4, eps=EPS, compaction="off")
    pair = _Pair(ref_g, prob, ref_api.Problem.at_least_k(k=4, eps=EPS, compaction="off"))
    r = pair.both(lambda e: e.query(10))
    padded, _ = pair.port.extract(10)
    assert float(api.solve(padded, prob).best_density) == r.density


def test_cache_dir_threads_through_engine(tmp_path):
    """The engine's ``cache_dir`` is its Solver's: the kernels its solves
    load are looked up and published there (a stub build stands in for
    nvcc), and a second engine on the same directory builds nothing."""
    import _ctypes

    d = str(tmp_path / "cache")
    g = _port(_graph(n=400, seed=6))
    source = tmp_path / "k.cu"
    source.write_text("// a kernel source\n")

    def stub(src, out, flags):
        shutil.copyfile(_ctypes.__file__, out)
        return ""

    e1 = DensestQueryEngine(g, PROB, cache_dir=d, max_wait_ms=0.0)
    r1 = e1.query(11)
    assert e1.solver.cache_dir == d
    with e1.solver.kernel_cache(e1.problem):
        kernels.load_library(source, build=stub)
    assert e1.solver.disk_misses == 1
    e2 = DensestQueryEngine(g, PROB, cache_dir=d, max_wait_ms=0.0)
    with e2.solver.kernel_cache(e2.problem):
        kernels.load_library(source, build=lambda *a: pytest.fail("built again"))
    assert e2.solver.disk_hits == 1 and e2.solver.disk_misses == 0
    r2 = e2.query(11)
    assert r1.density == r2.density and np.array_equal(r1.nodes, r2.nodes)


# ---------------------------------------------------------------------------
# extraction='local' (the serving half of tests/test_local.py)
# ---------------------------------------------------------------------------

PROB_LOCAL = dataclasses.replace(api.Problem.undirected(eps=EPS), substrate="local")
REF_PROB_LOCAL = dataclasses.replace(ref_api.Problem.undirected(eps=EPS), substrate="local")


def _planted():
    return planted_dense_subgraph(400, 4.0, 30, 0.6, seed=7)


def test_engine_local_matches_api_bitwise():
    ref_g, planted = _planted()
    pair = _Pair(ref_g, api.Problem.undirected(eps=EPS), ref_api.Problem.undirected(eps=EPS),
                 extraction="local")
    solver = api.Solver()
    for s in [int(planted[0]), 0, 17]:
        r = pair.both(lambda e: e.query(s))
        assert r.status == "ok"
        front = solver.solve(_port(ref_g), PROB_LOCAL, seed=s)
        assert r.density == float(front.best_density)
        np.testing.assert_array_equal(r.nodes, front.nodes())
    st = pair.port.stats()
    assert st["local_nodes_touched"] > 0 and st["local_edges_scanned"] > 0


def test_engine_accepts_local_substrate_problem():
    ref_g, planted = _planted()
    prob = dataclasses.replace(PROB_LOCAL, local_budget=128)
    pair = _Pair(ref_g, prob, dataclasses.replace(REF_PROB_LOCAL, local_budget=128))
    assert pair.port.extraction == "local" and pair.port.local_budget == 128
    assert pair.port.problem.substrate == "jit"
    r = pair.both(lambda e: e.query(int(planted[0])))
    assert r.status == "ok"
    want = api.Solver().solve(_port(ref_g), prob, seed=int(planted[0]))
    assert r.density == float(want.best_density)


def test_engine_knob_validation():
    g = _port(_planted()[0])
    bfs = DensestQueryEngine(g, PROB, max_wait_ms=0.0)
    loc = DensestQueryEngine(g, PROB, extraction="local", max_wait_ms=0.0)
    with pytest.raises(ValueError, match="radius"):
        loc.query(3, 2)
    with pytest.raises(ValueError, match="budget"):
        bfs.query(3, budget=16)
    with pytest.raises(ValueError, match="extraction"):
        DensestQueryEngine(g, PROB, extraction="dfs")
    with pytest.raises(ValueError):
        DensestQueryEngine(g, api.Problem.directed(), extraction="local")
    with pytest.raises(ValueError, match="local_alpha"):
        DensestQueryEngine(g, PROB, extraction="local", local_alpha=-1.0)


def test_engine_budget_override_and_degrade_rung():
    ref_g, planted = _planted()
    s = int(planted[0])
    cfg = ResilienceConfig(max_retries=0, degrade_turnstile=False, degrade_last_good=False)
    pair = _Pair(ref_g, extraction="local", resilience=cfg)
    r = pair.both(lambda e: e.query(s, budget=128))
    assert r.status == "ok" and r.n_ego <= 128
    padded, _ = pair.port.extract(s, budget=pair.port.local_budget)
    pair.ref.extract(s, budget=pair.ref.local_budget)  # the same work counted
    gkey = (padded.n_nodes, padded.n_edges_padded)
    res = pair.both(lambda e: e.query(s),
                    plan=lambda m: m.FaultPlan().fail_prob("serve.solve", 1.0, key=gkey))
    assert res.status == "degraded" and res.fallback == "budget:256"
    small, _ = pair.port.extract(s, budget=256)
    assert pair.ref.extract(s, budget=256)[0].n_nodes == small.n_nodes
    assert pair.port.stats() == pair.ref.stats()
    assert res.density == float(api.Solver().solve(small, PROB.resolve(small.n_nodes)).best_density)


# ---------------------------------------------------------------------------
# the cross-substrate property contract (tests/test_property_serve.py)
# ---------------------------------------------------------------------------

MODES = ("bfs", "local")


def _random_graph(rng):
    n = int(rng.integers(4, 13))
    m = int(rng.integers(3, 31))
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    if keep.sum() == 0:
        src, dst, keep = np.asarray([0]), np.asarray([1]), np.asarray([True])
    return ref_from_numpy(src[keep], dst[keep], n)


def _induced(ref_g, nodes):
    member = np.zeros(ref_g.n_nodes, bool)
    member[nodes] = True
    local = np.zeros(ref_g.n_nodes, np.int64)
    local[nodes] = np.arange(len(nodes))
    mask = np.asarray(ref_g.mask)
    src, dst, w = (np.asarray(a)[mask] for a in (ref_g.src, ref_g.dst, ref_g.weight))
    keep = member[src] & member[dst]
    return ref_from_numpy(local[src[keep]], local[dst[keep]], len(nodes), weight=w[keep])


def _check_contract(ref_g, seed, mode):
    pair = _Pair(ref_g, extraction=mode)
    r1 = pair.both(lambda e: e.query(seed))
    r2 = DensestQueryEngine(_port(ref_g), PROB, extraction=mode, max_wait_ms=0.0).query(seed)
    assert r1.status == "ok"
    e1 = pair.port
    _, cand = e1.extract(seed, budget=e1.local_budget) if mode == "local" else e1.extract(
        seed, e1.radius)
    cand_set = set(cand.tolist())
    assert seed in cand_set and set(r1.nodes.tolist()) <= cand_set
    assert r1.seed_in_set == (seed in set(r1.nodes.tolist()))
    _, rho_star = densest_subgraph_brute(ref_g)
    assert r1.density <= rho_star + 1e-4
    sub = _induced(ref_g, cand)
    if int(np.asarray(sub.mask).sum()) > 0:
        _, rho_local = densest_subgraph_brute(sub)
        assert r1.density >= rho_local / (2 * (1 + EPS)) - 1e-4
    else:
        assert r1.density == 0.0
    assert r1.density == r2.density
    np.testing.assert_array_equal(r1.nodes, r2.nodes)
    if mode == "local":
        front = api.Solver().solve(_port(ref_g), dataclasses.replace(PROB, substrate="local"),
                                   seed=seed)
        assert r1.density == float(front.best_density)
        np.testing.assert_array_equal(r1.nodes, front.nodes())


@pytest.mark.parametrize("mode", MODES)
def test_contract_fixed_corpus(mode):
    rng = np.random.default_rng(1234)
    for _ in range(6):
        g = _random_graph(rng)
        for seed in {0, int(rng.integers(0, g.n_nodes))}:
            _check_contract(g, seed, mode)


try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - exercised where hypothesis is absent

    @pytest.mark.skip(reason="hypothesis not installed; property sweep skipped")
    def test_property_serve_contract():
        raise AssertionError("unreachable")

else:

    @st.composite
    def graph_and_seed(draw):
        n = draw(st.integers(4, 12))
        m = draw(st.integers(3, 30))
        src = np.asarray(draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m)))
        dst = np.asarray(draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m)))
        keep = src != dst
        if keep.sum() == 0:
            src, dst, keep = np.asarray([0]), np.asarray([1]), np.asarray([True])
        return ref_from_numpy(src[keep], dst[keep], n), draw(st.integers(0, n - 1))

    @given(graph_and_seed(), st.sampled_from(MODES))
    @settings(max_examples=8, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    def test_property_serve_contract(gs, mode):
        g, seed = gs
        _check_contract(g, seed, mode)


# ---------------------------------------------------------------------------
# resilience (the serving half of tests/test_resilience.py)
# ---------------------------------------------------------------------------


def _serve_graph():
    return chung_lu_power_law(500, exponent=2.0, avg_deg=6.0, seed=2)


def test_serving_bit_identical_without_plan_and_with_empty_plan():
    ref_g = chung_lu_power_law(400, exponent=2.0, avg_deg=6.0, seed=0)
    seeds = [1, 7, 19, 42, 97]
    ref = _Pair(ref_g, radius=2).both(lambda e: e.query_many(seeds))
    with_cfg = _Pair(ref_g, radius=2, resilience=ResilienceConfig(
        max_retries=2, deadline_ms=50.0)).both(lambda e: e.query_many(seeds))
    with_empty = _Pair(ref_g, radius=2).both(lambda e: e.query_many(seeds),
                                             plan=lambda m: m.FaultPlan())
    for res in (with_cfg, with_empty):
        for a, b in zip(ref, res):
            assert b.status == "ok" and b.fallback is None
            assert b.error is None and b.attempts == 1
            assert a.density == b.density
            np.testing.assert_array_equal(a.nodes, b.nodes)
            assert a.bucket == b.bucket


def _two_bucket_seeds(eng, want=3):
    by_key = {}
    for s in range(eng.n_nodes):
        padded, _ = eng.extract(s)
        by_key.setdefault((padded.n_nodes, padded.n_edges_padded), []).append(s)
        if len(by_key) >= 2 and sorted(len(v) for v in by_key.values())[-2] >= want:
            big = sorted(by_key, key=lambda k: -len(by_key[k]))[:2]
            if all(len(by_key[k]) >= want for k in big):
                return {k: by_key[k][:want] for k in big}
    raise AssertionError("graph has only one bucket shape")


def test_group_failure_poisons_only_its_own_lanes_without_config():
    ref_g = _serve_graph()
    pair = _Pair(ref_g, radius=1, node_floor=8, edge_floor=32)
    (bad_key, bad_seeds), (_, ok_seeds) = _two_bucket_seeds(pair.port).items()
    ok_ref = _Pair(ref_g, radius=1, node_floor=8, edge_floor=32).both(
        lambda e: e.query_many(ok_seeds))
    ref_by_seed = {r.seed: r for r in ok_ref}
    out = pair.both(lambda e: e.query_many(bad_seeds + ok_seeds),
                    plan=lambda m: m.FaultPlan().fail_nth("serve.solve", 1, key=bad_key))
    by_seed = {r.seed: r for r in out}
    assert len(out) == len(bad_seeds) + len(ok_seeds)
    for s in bad_seeds:
        r = by_seed[s]
        assert r.status == "failed" and not r.answered and "InjectedFault" in r.error
        assert np.isnan(r.density) and r.size == 0 and r.attempts == 1
    for s in ok_seeds:
        r = by_seed[s]
        assert r.status == "ok" and r.density == ref_by_seed[s].density
        np.testing.assert_array_equal(r.nodes, ref_by_seed[s].nodes)
    assert pair.port.queries_failed == len(bad_seeds)


def test_retry_recovers_with_deterministic_backoff():
    cfg = ResilienceConfig(max_retries=2, backoff_base_ms=4.0, jitter_seed=9)
    ref_g = _serve_graph()
    pair = _Pair(ref_g, radius=1, resilience=cfg)
    padded, _ = pair.port.extract(5)
    gkey = (padded.n_nodes, padded.n_edges_padded)
    res = pair.both(lambda e: e.query(5),
                    plan=lambda m: m.FaultPlan().fail_nth("serve.solve", 1, key=gkey))
    want = _Pair(ref_g, radius=1).both(lambda e: e.query(5))
    assert res.status == "ok" and res.attempts == 2
    assert res.density == want.density
    np.testing.assert_array_equal(res.nodes, want.nodes)
    assert pair.port.solve_retries == 1
    assert pair.slept == [cfg.backoff_s(1, key=gkey)]
    step = cfg.backoff_base_ms / 1000.0
    assert step * (1 - cfg.backoff_jitter) <= pair.slept[0] <= step


def test_degrade_to_smaller_radius():
    cfg = ResilienceConfig(max_retries=0, degrade_turnstile=False, degrade_last_good=False)
    pair = _Pair(_serve_graph(), radius=2, resilience=cfg)
    padded, _ = pair.port.extract(5, 2)
    gkey = (padded.n_nodes, padded.n_edges_padded)
    res = pair.both(lambda e: e.query(5),
                    plan=lambda m: m.FaultPlan().fail_prob("serve.solve", 1.0, key=gkey))
    assert res.status == "degraded" and res.degraded and res.answered
    assert res.fallback == "radius:1" and "InjectedFault" in res.error
    small, nodes = pair.port.extract(5, 1)
    want = api.Solver().solve(small, PROB)
    assert res.density == float(want.best_density)
    alive = want.nodes()
    np.testing.assert_array_equal(res.nodes, nodes[alive[alive < len(nodes)]])
    assert pair.port.queries_degraded == 1


class _StubTurnstile:
    """Duck-typed TurnstileDensityService: a pinned density reading."""

    def __init__(self, n_nodes, rho):
        self.n_nodes = n_nodes
        self.rho = rho

    def density(self):
        return self.rho

    def apply(self, *a, **kw):
        return self


def test_degrade_to_turnstile_density_then_last_good():
    cfg = ResilienceConfig(max_retries=0, degrade_radius=False)
    ref_g = _serve_graph()
    pair = _Pair(ref_g, radius=1, resilience=cfg)
    for eng in (pair.port, pair.ref):
        eng.attach_turnstile(_StubTurnstile(ref_g.n_nodes, rho=3.25))
    good = pair.both(lambda e: e.query(5))
    assert good.status == "ok"
    storm = lambda m: m.FaultPlan().fail_prob("serve.solve", 1.0)  # noqa: E731
    res = pair.both(lambda e: e.query(5), plan=storm)
    assert res.status == "degraded" and res.fallback == "turnstile_density"
    assert res.density == 3.25 and res.size == 0
    pair.port._turnstile = pair.ref._turnstile = None
    res2 = pair.both(lambda e: e.query(5), plan=storm)
    assert res2.status == "degraded" and res2.fallback == "last_good"
    assert res2.density == good.density
    np.testing.assert_array_equal(res2.nodes, good.nodes)
    assert res2.qid != good.qid and "InjectedFault" in res2.error


def test_failed_when_ladder_exhausted_but_flush_survives():
    pair = _Pair(_serve_graph(), radius=1, resilience=ResilienceConfig(max_retries=0))
    res = pair.both(lambda e: e.query(5),
                    plan=lambda m: m.FaultPlan().fail_prob("serve.solve", 1.0))
    assert res.status == "failed" and not res.answered
    assert np.isnan(res.density) and "InjectedFault" in res.error
    assert pair.both(lambda e: e.query(5)).status == "ok"


def test_bounded_queue_sheds_with_explicit_rejected_outcome():
    pair = _Pair(_serve_graph(), radius=1, resilience=ResilienceConfig(max_queue=2))
    qids = [pair.port.submit(s) for s in (1, 2, 3, 4)]
    assert [pair.ref.submit(s) for s in (1, 2, 3, 4)] == qids
    assert pair.port.pending() == 2
    out = pair.both(lambda e: e.flush())
    assert sorted(r.qid for r in out) == sorted(qids)
    by_qid = {r.qid: r for r in out}
    assert [by_qid[q].status for q in qids] == ["ok", "ok", "rejected", "rejected"]
    for q in qids[2:]:
        r = by_qid[q]
        assert r.attempts == 0 and "queue full" in r.error and not r.answered
    assert pair.port.queries_rejected == 2


def test_circuit_breaker_opens_cools_down_and_probes():
    cfg = ResilienceConfig(max_retries=0, breaker_threshold=2, breaker_cooldown_s=30.0)
    pair = _Pair(_serve_graph(), radius=1, resilience=cfg)
    padded, _ = pair.port.extract(5)
    gkey = (padded.n_nodes, padded.n_edges_padded)
    plans = {m: m.FaultPlan().fail_prob("serve.solve", 1.0, key=gkey) for m in (faults, ref_faults)}
    storm = lambda m: plans[m]  # noqa: E731
    pair.both(lambda e: [e.query(5), e.query(5)], plan=storm)
    assert pair.port._breaker.state(gkey) == pair.ref._breaker.state(gkey) == "open"
    hits = plans[faults].hits_at("serve.solve", gkey)
    r = pair.both(lambda e: e.query(5), plan=storm)
    assert plans[faults].hits_at("serve.solve", gkey) == hits
    assert r.status == "failed" and "CircuitOpen" in r.error and r.attempts == 0
    assert pair.port.breaker_open_skips == 1
    pair.advance(31.0)
    pair.both(lambda e: e.query(5), plan=storm)
    assert plans[faults].hits_at("serve.solve", gkey) == hits + 1
    assert pair.port._breaker.state(gkey) == "open"
    pair.advance(31.0)
    assert pair.both(lambda e: e.query(5)).status == "ok"
    assert pair.port._breaker.state(gkey) == "closed"
    assert pair.port._breaker.opened == pair.ref._breaker.opened >= 2


def test_deadline_budget_stops_retries():
    cfg = ResilienceConfig(max_retries=5, deadline_ms=5.0, backoff_base_ms=10.0)
    pair = _Pair(_serve_graph(), radius=1, resilience=cfg)
    # Backoff sleeps advance each engine's own clock.
    pair.port._sleep = lambda s: setattr(pair.clock, "t", pair.clock.t + s)
    pair.ref._sleep = lambda s: setattr(pair.ref_clock, "t", pair.ref_clock.t + s)
    res = pair.both(lambda e: e.query(5),
                    plan=lambda m: m.FaultPlan().fail_prob("serve.solve", 1.0))
    assert res.attempts == 2 and res.status == "failed"
    assert pair.port.deadline_stops == 1 and pair.port.solve_retries == 1


def test_circuit_breaker_unit_semantics():
    for breaker_cls in (CircuitBreaker, RefBreaker):
        clk = _Clock()
        br = breaker_cls(threshold=2, cooldown_s=10.0, time_fn=clk)
        assert br.state("k") == "closed" and br.allow("k")
        br.record_failure("k")
        assert br.state("k") == "closed"
        br.record_failure("k")
        assert br.state("k") == "open" and not br.allow("k")
        clk.t += 10.0
        assert br.state("k") == "half_open" and br.allow("k")
        br.record_failure("k")
        assert br.state("k") == "open" and br.opened == 2
        clk.t += 10.0
        br.record_success("k")
        assert br.state("k") == "closed" and br.opened == 2
        assert br.state("other") == "closed"
        with pytest.raises(ValueError):
            breaker_cls(threshold=0, cooldown_s=1.0)


@pytest.mark.parametrize("kw,match", [
    (dict(deadline_ms=0.0), "deadline_ms"), (dict(max_retries=-1), "max_retries"),
    (dict(backoff_mult=0.5), "backoff_mult"), (dict(max_queue=0), "max_queue"),
    (dict(backoff_jitter=1.5), "backoff_jitter"), (dict(breaker_threshold=0), "breaker"),
])
def test_resilience_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        RefConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ResilienceConfig(**kw)


def test_resilience_config_backoff_matches_reference():
    cfg = ResilienceConfig(backoff_base_ms=2.0, backoff_mult=3.0)
    ref = RefConfig(backoff_base_ms=2.0, backoff_mult=3.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    with pytest.raises(ValueError):
        cfg.backoff_s(0)
    for retry in (1, 2, 3):
        for key in ("k", (64, 256), ("fallback", 3, 1)):
            assert cfg.backoff_s(retry, key) == ref.backoff_s(retry, key)
        step = 2.0 * 3.0 ** (retry - 1) / 1000.0
        assert step * 0.5 <= cfg.backoff_s(retry, "k") <= step


def test_engine_solves_on_the_graphs_device():
    """The engine's device is the graph's; the answers are host data."""
    g = _port(_graph(n=300))
    eng = DensestQueryEngine(g, PROB, max_wait_ms=0.0)
    assert eng.device == g.device == torch.device("cpu")
    r = eng.query(3)
    assert isinstance(r.nodes, np.ndarray) and isinstance(r.density, float)
