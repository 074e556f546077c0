"""Seed-batched densest-subgraph query engine, the serving front line
(counterpart of ``repro.serve.densest``).

Production traffic is per-seed queries — "give me the dense community
around THIS node" — not whole-graph solves.  This engine makes a query's
cost depend on the seed's NEIGHBORHOOD, not on n, and makes a fleet of
concurrent queries share a handful of bucket shapes:

  * **Host-resident CSR adjacency**, built once from the edge list
    (:func:`repro_torch.graph.edgelist.to_csr`, one copy of a device graph
    to the host): O(1) neighbor lookups, no device round-trip during
    extraction.
  * **Bounded-radius ego-net extraction**: BFS out to ``radius`` hops
    (optionally truncated at ``max_ego_nodes``), then the induced subgraph
    is relabeled into a compact id space — O(vol(ego)) host work per query.
  * **Power-of-two bucketing**: each extracted subgraph is padded into a
    pow2 node bucket and pow2 edge bucket
    (:func:`repro_torch.graph.partition.pow2_bucket`, the compaction
    ladder's bucket rule), and batches are padded to pow2 LANE counts, as
    in the reference (where each shape is one compiled program), so the
    two packages land on the same buckets for the same stream.  Pad nodes
    are isolated: the peel removes them in pass 1 (degree 0 is always ≤
    the removal threshold), so the (2+2eps) approximation guarantee holds
    on the padded buffer.
  * **Micro-batching with a deadline**: queries queue (FIFO deque) until
    ``max_batch`` are waiting or the oldest has waited ``max_wait_ms``;
    a flush coalesces same-bucket queries and solves each bucket group as
    ONE stacked ``solve_batch`` (one ``index_add_`` over all lanes a pass,
    one host sync a pass for all lanes).  The group is stacked on the host
    and crosses to the engine's device (``graph.device``) in one copy per
    leaf; ``best_alive`` and ``best_density`` come back in one copy.  Each
    lane is bit-identical to a standalone ``solve()`` of the same padded
    subgraph for integer-valued weights (the engine's correctness
    contract, held by tests/test_torch_serve_densest.py; float weights are
    summed in another order by the card's atomics).
  * **Persistent warmth**: give the engine (or its Solver) a ``cache_dir``
    and a fresh replica loads the kernels it uses from the cache of built
    kernels instead of running ``nvcc`` (``core/progcache.py``).
  * **Two extraction modes** behind one knob: ``extraction='bfs'`` (the
    radius-hop ego-net above) or ``extraction='local'`` — Andersen's
    pruned-frontier exploration (``core/local.py``, arXiv cs/0702078),
    whose per-query work is bounded by ``local_budget`` instead of the
    neighborhood volume, so it stays flat as the graph grows
    (``chip_smoke.py`` logs the per-query work at two scales).  Both modes land in
    the same buckets, batches, and resilience ladder; the shrink degrade
    rung re-extracts at smaller radius (BFS) or halved budget (local).
    A ``Problem(substrate='local')`` selects the local mode and supplies
    its exploration knobs; the solves lower onto jit lanes either way.

Extraction stays host numpy, as in the reference; buffers are CPU tensors
over those arrays until a group (or a degrade rung's single solve) moves
them to the device.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import constants, faults, hostsync
from repro_torch.core.api import Problem, Solver
from repro_torch.core.local import (
    LocalExplorer,
    adjacency_rows,
    check_count,
    check_seed,
    induced_padded,
)
from repro_torch.graph.edgelist import EdgeList, to_csr
from repro_torch.graph.partition import pow2_bucket
from repro_torch.serve.resilience import CircuitBreaker, ResilienceConfig

__all__ = ["DensestQueryEngine", "QueryResult"]

# Bucket floors (aliased from the one constants surface,
# repro_torch.constants): the reference's, so both packages pad alike.
_NODE_FLOOR = constants.SERVE_NODE_FLOOR
_EDGE_FLOOR = constants.SERVE_EDGE_FLOOR
# Local-extraction budget floor: the shrink degrade rung halves a query's
# budget down to (not past) this.
_LOCAL_BUDGET_FLOOR = constants.LOCAL_BUDGET_FLOOR


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One answered seed query.

    ``nodes`` are ORIGINAL graph ids (bucket pad nodes are filtered out);
    ``density`` is the peel's best density on the padded ego-net buffer —
    a (2+2eps)-approximation of the ego-net's densest subgraph.

    Failure provenance (the reference's resilience contract):
    ``status`` is ``'ok'`` (the full exact-path answer), ``'degraded'``
    (a real but weaker answer; ``fallback`` names its source —
    ``'radius:<r>'``/``'budget:<b>'`` per extraction mode,
    ``'turnstile_density'`` or ``'last_good'``),
    ``'rejected'`` (shed at admission by a full bounded queue) or
    ``'failed'`` (every fallback exhausted).  ``error`` carries the
    original solve error for every non-``'ok'`` status and ``attempts``
    counts solve attempts (retries included).  A degraded answer is
    never fabricated — it is always genuinely computed data.
    """

    qid: int
    seed: int
    nodes: np.ndarray  # original-id members of the best set
    density: float
    seed_in_set: bool
    n_ego: int  # extracted subgraph size: nodes (ego-net or candidate set)
    m_ego: int  # extracted subgraph size: edges
    bucket: Tuple[int, int, int]  # (node bucket, edge bucket, batch lanes)
    latency_s: float  # submit -> answer (engine clock)
    status: str = "ok"  # ok | degraded | rejected | failed
    fallback: Optional[str] = None  # provenance of a degraded answer
    error: Optional[str] = None  # original error for non-ok statuses
    attempts: int = 1  # solve attempts spent (0: never reached a solve)

    @property
    def size(self) -> int:
        return int(len(self.nodes))

    @property
    def degraded(self) -> bool:
        return self.status == "degraded"

    @property
    def answered(self) -> bool:
        """True when the query got a real answer (exact or degraded)."""
        return self.status in ("ok", "degraded")


@dataclasses.dataclass
class _Pending:
    qid: int
    seed: int
    radius: int  # BFS extraction (0 under extraction='local')
    budget: int  # local extraction (0 under extraction='bfs')
    submitted_at: float


class DensestQueryEngine:
    """Answers per-seed densest-subgraph queries over one graph, solving on
    the graph's device (``graph.device``: the card unless the graph lies on
    the CPU).

    Synchronous pump (the style of :class:`repro_torch.serve.engine.ServeEngine`):
    ``submit()`` enqueues, ``step()`` flushes a batch when one is due
    (``max_batch`` reached or the oldest query older than ``max_wait_ms``),
    ``flush()`` forces everything out, and ``query()`` / ``query_many()``
    are the one-call conveniences.  ``time_fn`` is injectable so deadline
    behavior is testable without sleeping.

    Undirected graphs only; the Problem must lower onto the jit
    substrate (``Problem(substrate='local')`` is accepted and selects the
    local extraction — its solves still run as jit lanes) and — for
    stacked lanes — a graph-independent backend.

    ``extraction`` picks how a query's subgraph is carved out:
    ``'bfs'`` (default) is the radius-hop ego-net; ``'local'`` is the
    Andersen pruned-frontier exploration (``core/local.py``) whose
    per-query work is capped by ``local_budget`` — the per-query override
    is ``budget=`` (``radius=`` in BFS mode).  Both modes share the
    buckets, the batching, the resilience ladder, and the QueryResult
    contract; each lane stays bit-identical to a standalone ``solve()``
    of the same padded buffer (for the local mode that standalone is
    ``solve(graph, Problem(substrate='local'), seed=...)``).
    """

    def __init__(
        self,
        graph: EdgeList,
        problem: Optional[Problem] = None,
        *,
        solver: Optional[Solver] = None,
        cache_dir: Optional[str] = None,
        radius: int = 2,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        max_ego_nodes: Optional[int] = None,
        node_floor: int = _NODE_FLOOR,
        edge_floor: int = _EDGE_FLOOR,
        time_fn: Callable[[], float] = time.monotonic,
        resilience: Optional[ResilienceConfig] = None,
        sleep_fn: Callable[[float], None] = time.sleep,
        extraction: Optional[str] = None,
        local_budget: Optional[int] = None,
        local_rounds: Optional[int] = None,
        local_alpha: Optional[float] = None,
    ):
        if graph.directed:
            raise ValueError(
                "DensestQueryEngine serves undirected host graphs "
                "(both extraction modes are undirected)"
            )
        problem = problem if problem is not None else Problem.undirected()
        if problem.substrate == "local":
            # Problem(substrate='local') IS the local serving spec: apply
            # its validation (undirected objective, exact backend,
            # compaction off), inherit its exploration knobs, and lower
            # the lane solves onto the jit substrate.
            resolved = problem.resolve(graph.n_nodes)
            extraction = "local" if extraction is None else extraction
            if local_budget is None:
                local_budget = resolved.local_budget
            if local_rounds is None:
                local_rounds = resolved.local_rounds
            if local_alpha is None:
                local_alpha = resolved.local_alpha
            problem = dataclasses.replace(resolved, substrate="jit")
        if problem.substrate not in ("jit", "auto"):
            raise ValueError(
                "per-seed serving batches extracted subgraphs on the jit "
                f"substrate; substrate={problem.substrate!r} does not apply"
            )
        if problem.backend == "pallas":
            raise ValueError(
                "stacked-lane sweeps need a graph-independent backend "
                "(tile bucketing is per-graph); use backend='exact'"
            )
        if problem.objective == "directed":
            raise ValueError(
                "per-seed extraction is undirected; directed objectives "
                "have no serving cell"
            )
        extraction = "bfs" if extraction is None else extraction
        if extraction not in ("bfs", "local"):
            raise ValueError(
                f"extraction={extraction!r} not in ('bfs', 'local')"
            )
        if extraction == "local" and problem.objective != "undirected":
            raise ValueError(
                "extraction='local' prunes its frontier against the "
                "undirected density; use objective='undirected'"
            )
        if radius < 1:
            raise ValueError(f"radius={radius} must be >= 1")
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms={max_wait_ms} must be >= 0")
        self.problem = problem
        self.solver = solver if solver is not None else Solver(cache_dir=cache_dir)
        self.extraction = extraction
        self.local_budget = check_count(
            problem.local_budget if local_budget is None else local_budget,
            "local_budget",
        )
        self.local_rounds = check_count(
            problem.local_rounds if local_rounds is None else local_rounds,
            "local_rounds",
        )
        self.local_alpha = float(
            problem.local_alpha if local_alpha is None else local_alpha
        )
        if self.local_alpha < 0:
            raise ValueError(f"local_alpha={self.local_alpha} must be >= 0")
        self.radius = int(radius)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_ego_nodes = max_ego_nodes
        self.node_floor = int(node_floor)
        self.edge_floor = int(edge_floor)
        self._time = time_fn
        self.n_nodes = graph.n_nodes
        self.device = graph.device  # where every group is solved
        # Host-resident weighted CSR, built once; every query reads it.
        self._indptr, self._indices, self._csr_w = to_csr(
            graph, return_weights=True
        )
        self._member = np.zeros(graph.n_nodes, bool)  # reusable scratch
        self._local_id = np.zeros(graph.n_nodes, np.int32)  # relabel scratch
        # Local-mode explorer over the SAME CSR arrays (no copy); its own
        # scratch keeps the BFS path's `_member` usage independent.
        self._explorer: Optional[LocalExplorer] = (
            LocalExplorer(
                self._indptr, self._indices, self._csr_w,
                n_nodes=graph.n_nodes,
            )
            if extraction == "local"
            else None
        )
        # Local-extraction work counters (chip_smoke.py's scaling evidence).
        self.local_nodes_touched = 0
        self.local_edges_scanned = 0
        # FIFO admission queue (deque: O(1) popleft, arbitrarily deep).
        self._queue: Deque[_Pending] = collections.deque()
        self._next_qid = 0
        # Observability: queries answered, batches flushed, lanes solved
        # (incl. pad lanes), and the bucket -> lane-count histogram.
        self.queries_answered = 0
        self.batches_flushed = 0
        self.lanes_solved = 0
        self.pad_lanes = 0
        self.bucket_histogram: Dict[Tuple[int, int], int] = {}
        # Optional whole-graph turnstile sidecar (attach_turnstile).
        self._turnstile = None
        # Resilience policy (None: legacy behavior except group-failure
        # isolation, which always holds — see _process).
        self.resilience = resilience
        self._sleep = sleep_fn
        self._breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(
                resilience.breaker_threshold,
                resilience.breaker_cooldown_s,
                time_fn=time_fn,
            )
            if resilience is not None
            else None
        )
        # Rejected-at-admission results waiting to be drained by the next
        # step()/flush(), and the last-good per-seed answer cache (bounded
        # by the number of distinct seeds; only kept when the last_good
        # degrade rung is enabled).
        self._shed: List[QueryResult] = []
        self._last_good: Dict[int, QueryResult] = {}
        self.queries_rejected = 0
        self.queries_degraded = 0
        self.queries_failed = 0
        self.solve_retries = 0
        self.breaker_open_skips = 0
        self.deadline_stops = 0

    # -- turnstile attachment -----------------------------------------------
    def attach_turnstile(self, service) -> "DensestQueryEngine":
        """Attaches a live :class:`repro_torch.serve.turnstile.TurnstileDensityService`
        so this engine can also answer whole-graph "current density" probes
        between its per-seed batches.  The sidecar tracks the DYNAMIC graph
        (its own ±edge stream); the engine's host CSR stays the static
        snapshot it was built from — the two views are independent by design.
        """
        if not (hasattr(service, "density") and hasattr(service, "apply")):
            raise ValueError(
                "attach_turnstile expects a TurnstileDensityService-like "
                "object with apply()/density()"
            )
        if service.n_nodes != self.n_nodes:
            raise ValueError(
                f"turnstile service tracks n_nodes={service.n_nodes}, "
                f"engine serves n_nodes={self.n_nodes}"
            )
        self._turnstile = service
        return self

    def current_density(self) -> float:
        """The attached turnstile sidecar's current approximate maximum
        density (cached between update batches)."""
        if self._turnstile is None:
            raise ValueError(
                "no turnstile service attached; call attach_turnstile() first"
            )
        return self._turnstile.density()

    # -- extraction ---------------------------------------------------------
    def _ego_nodes(self, seed: int, radius: int) -> np.ndarray:
        """Sorted ids of the radius-hop ego-net around ``seed``; leaves
        ``self._member`` SET for those ids (the caller resets it)."""
        member = self._member
        member[seed] = True
        layers = [np.asarray([seed], np.int64)]
        frontier = layers[0]
        n_total = 1
        for _ in range(radius):
            slot_idx, _ = adjacency_rows(self._indptr, frontier)
            nb = np.unique(self._indices[slot_idx].astype(np.int64))
            nb = nb[~member[nb]]
            if nb.size == 0:
                break
            if (
                self.max_ego_nodes is not None
                and n_total + nb.size > self.max_ego_nodes
            ):
                # Deterministic truncation: keep the lowest ids of the
                # overflowing layer (documented extraction contract).
                nb = nb[: max(self.max_ego_nodes - n_total, 0)]
                if nb.size == 0:
                    break
            member[nb] = True
            layers.append(nb)
            frontier = nb
            n_total += nb.size
        return np.sort(np.concatenate(layers))

    def extract(
        self,
        seed: int,
        radius: Optional[int] = None,
        *,
        budget: Optional[int] = None,
    ) -> Tuple[EdgeList, np.ndarray]:
        """The extracted subgraph of ``seed`` — radius-hop ego-net (BFS
        mode) or pruned-frontier candidate set (local mode) — as a
        bucket-padded EdgeList plus the sorted original ids its compact
        ids map to (local id i ↔ ``nodes[i]``; ids >= ``len(nodes)`` are
        isolated pad nodes).  The padding body is
        :func:`repro_torch.core.local.induced_padded`, shared with the
        ``substrate='local'`` front door, so every path solves a
        bit-identical buffer.

        This is THE extraction the engine serves — the sequential baseline
        and the bit-identity tests call it so both sides solve the same
        padded buffer.
        """
        seed = check_seed(seed, self.n_nodes)
        if self.extraction == "local":
            if radius is not None:
                raise ValueError(
                    "extraction='local' has no radius; the per-query "
                    "knob is budget="
                )
            b = (
                self.local_budget
                if budget is None
                else check_count(budget, "budget")
            )
            ex = self._explorer.explore(
                seed, budget=b, max_rounds=self.local_rounds,
                alpha=self.local_alpha,
            )
            nodes = ex.candidates
            self.local_nodes_touched += ex.nodes_touched
            self.local_edges_scanned += ex.edges_scanned
        else:
            if budget is not None:
                raise ValueError(
                    "budget= only applies to extraction='local'; the "
                    "BFS per-query knob is radius="
                )
            r = (
                self.radius
                if radius is None
                else check_count(radius, "radius")
            )
            nodes = self._ego_nodes(seed, r)
            self._member[nodes] = False  # reset the BFS scratch
        # Buffers stay on the host (CPU tensors over numpy): the device
        # transfer happens at solve time — once per call for a sequential
        # solve(), once per STACKED BATCH on the engine's coalesced path
        # (the transfer is amortized across the whole bucket group; see
        # _process).
        padded = induced_padded(
            self._indptr, self._indices, self._csr_w, nodes,
            self._member, self._local_id,
            node_floor=self.node_floor, edge_floor=self.edge_floor,
        )
        return padded, nodes

    # -- queueing -----------------------------------------------------------
    def submit(
        self,
        seed: int,
        radius: Optional[int] = None,
        *,
        budget: Optional[int] = None,
    ) -> int:
        """Enqueues a seed query; returns its qid.  Nothing runs until a
        batch is due (``step``) or forced (``flush``).

        Validation happens HERE, at admission (the serving contract): the
        seed must be a real integer node id in range (bools and floats
        are rejected — a float used to slip past the range check and
        silently truncate inside the queue), and the per-query override —
        ``radius=`` in BFS mode, ``budget=`` in local mode — must be a
        positive integer matching the engine's extraction mode.

        With ``resilience.max_queue`` set, a full admission queue SHEDS the
        query instead of growing without bound: the qid is still returned,
        and the next drain yields a ``status='rejected'`` result for it."""
        seed = check_seed(seed, self.n_nodes)
        if self.extraction == "local":
            if radius is not None:
                raise ValueError(
                    "extraction='local' has no radius; the per-query "
                    "knob is budget="
                )
            q_radius = 0
            q_budget = (
                self.local_budget
                if budget is None
                else check_count(budget, "budget")
            )
        else:
            if budget is not None:
                raise ValueError(
                    "budget= only applies to extraction='local'; the "
                    "BFS per-query knob is radius="
                )
            q_radius = (
                self.radius
                if radius is None
                else check_count(radius, "radius")
            )
            q_budget = 0
        qid = self._next_qid
        self._next_qid += 1
        cfg = self.resilience
        if (
            cfg is not None
            and cfg.max_queue is not None
            and len(self._queue) >= cfg.max_queue
        ):
            self.queries_rejected += 1
            self._shed.append(
                QueryResult(
                    qid=qid,
                    seed=int(seed),
                    nodes=np.empty(0, np.int64),
                    density=float("nan"),
                    seed_in_set=False,
                    n_ego=0,
                    m_ego=0,
                    bucket=(0, 0, 0),
                    latency_s=0.0,
                    status="rejected",
                    error=f"queue full (max_queue={cfg.max_queue})",
                    attempts=0,
                )
            )
            return qid
        self._queue.append(
            _Pending(
                qid=qid, seed=seed, radius=q_radius, budget=q_budget,
                submitted_at=self._time(),
            )
        )
        return qid

    def pending(self) -> int:
        return len(self._queue)

    def batch_due(self, now: Optional[float] = None) -> bool:
        """The flush condition: a full batch is waiting, or the OLDEST
        query has aged past the ``max_wait_ms`` deadline (the latency
        bound a queued query is guaranteed under a live pump)."""
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        now = self._time() if now is None else now
        return (now - self._queue[0].submitted_at) * 1000.0 >= self.max_wait_ms

    def _drain_shed(self) -> List[QueryResult]:
        out, self._shed = self._shed, []
        return out

    def step(self, now: Optional[float] = None) -> List[QueryResult]:
        """Flushes ONE batch if due (at most ``max_batch`` queries, FIFO);
        returns its results (plus any shed ``rejected`` results), or []
        when nothing is due yet."""
        if not self.batch_due(now):
            return self._drain_shed()
        take = min(self.max_batch, len(self._queue))
        out = self._drain_shed()
        out.extend(self._process([self._queue.popleft() for _ in range(take)]))
        return out

    def flush(self) -> List[QueryResult]:
        """Drains the whole queue now, deadline or not, in FIFO batches of
        ``max_batch``."""
        out: List[QueryResult] = self._drain_shed()
        while self._queue:
            take = min(self.max_batch, len(self._queue))
            out.extend(
                self._process([self._queue.popleft() for _ in range(take)])
            )
        return out

    def query(
        self,
        seed: int,
        radius: Optional[int] = None,
        *,
        budget: Optional[int] = None,
    ) -> QueryResult:
        """One synchronous query (submit + flush)."""
        qid = self.submit(seed, radius, budget=budget)
        for res in self.flush():
            if res.qid == qid:
                return res
        raise RuntimeError(f"query {qid} lost in flush")  # pragma: no cover

    def query_many(
        self,
        seeds: Sequence[int],
        radius: Optional[int] = None,
        *,
        budget: Optional[int] = None,
    ) -> List[QueryResult]:
        """Answers many seeds through the batched path; results in seed
        order."""
        qids = [self.submit(s, radius, budget=budget) for s in seeds]
        by_qid = {r.qid: r for r in self.flush()}
        return [by_qid[q] for q in qids]

    # -- the batched solve --------------------------------------------------
    @staticmethod
    def _members(nodes: np.ndarray, alive_row: np.ndarray) -> np.ndarray:
        """Original-id members of one lane's best set (pad nodes dropped)."""
        local = np.nonzero(alive_row)[0]
        local = local[local < len(nodes)]  # drop isolated pad nodes
        return nodes[local]

    @staticmethod
    def _seed_in(member_nodes: np.ndarray, seed: int) -> bool:
        pos = np.searchsorted(member_nodes, seed)
        return bool(pos < len(member_nodes) and member_nodes[pos] == seed)

    def _solve_group(
        self,
        gkey: Tuple[int, int],
        stacked: EdgeList,
        oldest_submitted_at: float,
    ):
        """Solves one stacked bucket group under the resilience policy:
        breaker gate, bounded retry with deterministic backoff, deadline
        cut-off.  Returns ``(result_or_None, error_or_None, attempts)`` —
        it never raises, so a failed group can only poison its own lanes."""
        cfg = self.resilience
        breaker = self._breaker
        if breaker is not None and not breaker.allow(gkey):
            self.breaker_open_skips += 1
            return None, f"CircuitOpen: breaker open for bucket {gkey}", 0
        max_retries = cfg.max_retries if cfg is not None else 0
        attempts = 0
        while True:
            attempts += 1
            try:
                faults.fire("serve.solve", key=gkey)
                res = self.solver.solve_batch(stacked, self.problem)
            except Exception as e:  # noqa: BLE001 — isolate, degrade, report
                err = f"{type(e).__name__}: {e}"
                if breaker is not None:
                    breaker.record_failure(gkey)
                retry = attempts  # 1-based number of the NEXT retry
                if retry > max_retries:
                    return None, err, attempts
                if cfg is not None and cfg.deadline_ms is not None:
                    # The first attempt always ran; further retries are
                    # granted only while the group's oldest query still
                    # has deadline budget.
                    waited_ms = (self._time() - oldest_submitted_at) * 1000.0
                    if waited_ms >= cfg.deadline_ms:
                        self.deadline_stops += 1
                        return None, err, attempts
                self.solve_retries += 1
                if cfg is not None:
                    delay = cfg.backoff_s(retry, key=gkey)
                    if delay > 0:
                        self._sleep(delay)
                continue
            if breaker is not None:
                breaker.record_success(gkey)
            return res, None, attempts

    def _extract_pending(self, q: _Pending) -> Tuple[EdgeList, np.ndarray]:
        if self.extraction == "local":
            return self.extract(q.seed, budget=q.budget)
        return self.extract(q.seed, q.radius)

    def _shrink_rungs(self, q: _Pending) -> List[Tuple[str, int]]:
        """The shrink ladder for one query: decreasing radii (BFS mode) or
        halving budgets down to the floor (local mode)."""
        if self.extraction == "local":
            rungs = []
            b = q.budget // 2
            while b >= _LOCAL_BUDGET_FLOOR:
                rungs.append(("budget", b))
                b //= 2
            return rungs
        return [("radius", r) for r in range(q.radius - 1, 0, -1)]

    def _shrink_fallback(
        self, q: _Pending, err: str, attempts: int
    ) -> Optional[QueryResult]:
        """The first degrade rung: re-extract a SMALLER subgraph —
        shrinking radius under BFS extraction, halving budget (down to the
        LOCAL_BUDGET_FLOOR) under local extraction — and solve each as a
        single (unbatched) solve.  Real data or None."""
        for kind, v in self._shrink_rungs(q):
            try:
                if kind == "budget":
                    padded, nodes = self.extract(q.seed, budget=v)
                else:
                    padded, nodes = self.extract(q.seed, v)
                faults.fire("serve.solve", key=("fallback", q.qid, v))
                res = self.solver.solve(padded.to(self.device), self.problem)
            except Exception:  # noqa: BLE001 — try the next rung down
                attempts += 1
                continue
            attempts += 1
            member_nodes = self._members(nodes, hostsync.fetch(res.best_alive))
            return QueryResult(
                qid=q.qid,
                seed=q.seed,
                nodes=member_nodes,
                density=float(hostsync.read(res.best_density)),
                seed_in_set=self._seed_in(member_nodes, q.seed),
                n_ego=int(len(nodes)),
                m_ego=int(padded.mask.sum()),
                bucket=(int(padded.n_nodes), int(padded.n_edges_padded), 1),
                latency_s=float(self._time() - q.submitted_at),
                status="degraded",
                fallback=f"{kind}:{v}",
                error=err,
                attempts=attempts,
            )
        return None

    def _fallback(
        self,
        q: _Pending,
        n_ego: int,
        m_ego: int,
        bucket: Tuple[int, int, int],
        err: str,
        attempts: int,
    ) -> QueryResult:
        """The degradation ladder for one poisoned lane: smaller-radius
        ego-net -> cached turnstile density -> last-good cached answer ->
        explicit failure.  Every rung returns REAL data; nothing is ever
        fabricated."""
        cfg = self.resilience
        if cfg is not None:
            can_shrink = (
                q.budget > _LOCAL_BUDGET_FLOOR
                if self.extraction == "local"
                else q.radius > 1
            )
            if cfg.degrade_radius and can_shrink:
                res = self._shrink_fallback(q, err, attempts)
                if res is not None:
                    self.queries_degraded += 1
                    return res
            if cfg.degrade_turnstile and self._turnstile is not None:
                try:
                    rho = float(self._turnstile.density())
                except Exception:  # noqa: BLE001 — rung down
                    pass
                else:
                    self.queries_degraded += 1
                    return QueryResult(
                        qid=q.qid,
                        seed=q.seed,
                        nodes=np.empty(0, np.int64),
                        density=rho,
                        seed_in_set=False,
                        n_ego=n_ego,
                        m_ego=m_ego,
                        bucket=bucket,
                        latency_s=float(self._time() - q.submitted_at),
                        status="degraded",
                        fallback="turnstile_density",
                        error=err,
                        attempts=attempts,
                    )
            if cfg.degrade_last_good:
                prev = self._last_good.get(q.seed)
                if prev is not None:
                    self.queries_degraded += 1
                    return dataclasses.replace(
                        prev,
                        qid=q.qid,
                        latency_s=float(self._time() - q.submitted_at),
                        status="degraded",
                        fallback="last_good",
                        error=err,
                        attempts=attempts,
                    )
        self.queries_failed += 1
        return QueryResult(
            qid=q.qid,
            seed=q.seed,
            nodes=np.empty(0, np.int64),
            density=float("nan"),
            seed_in_set=False,
            n_ego=n_ego,
            m_ego=m_ego,
            bucket=bucket,
            latency_s=float(self._time() - q.submitted_at),
            status="failed",
            error=err,
            attempts=attempts,
        )

    def _process(self, batch: List[_Pending]) -> List[QueryResult]:
        """Extract + coalesce + solve one batch: same-bucket queries become
        lanes of ONE stacked solve_batch per (node, edge) bucket.

        Group isolation (the resilience contract, held with OR without a
        ResilienceConfig): a bucket group whose solve fails poisons only
        its own lanes — each gets a deterministic per-lane outcome through
        the degradation ladder — while sibling groups answer normally."""
        groups: Dict[Tuple[int, int], List[Tuple[_Pending, EdgeList, np.ndarray]]]
        groups = {}
        for q in batch:
            padded, nodes = self._extract_pending(q)
            key = (padded.n_nodes, padded.n_edges_padded)
            groups.setdefault(key, []).append((q, padded, nodes))
        results: List[QueryResult] = []
        cfg = self.resilience
        keep_last_good = cfg is not None and cfg.degrade_last_good
        for (n_b, m_b), items in groups.items():
            lanes = pow2_bucket(len(items))
            # One stacked (lanes, m_b) buffer per leaf, built HOST-side:
            # the whole bucket group crosses to the device as a single
            # transfer per leaf instead of one per lane.
            src_s = np.zeros((lanes, m_b), np.int32)
            dst_s = np.zeros((lanes, m_b), np.int32)
            w_s = np.zeros((lanes, m_b), np.float32)
            msk_s = np.zeros((lanes, m_b), bool)
            for j, (_, g, _) in enumerate(items):
                src_s[j] = g.src.numpy()
                dst_s[j] = g.dst.numpy()
                w_s[j] = g.weight.numpy()
                msk_s[j] = g.mask.numpy()
            stacked = EdgeList(
                src=torch.from_numpy(src_s), dst=torch.from_numpy(dst_s),
                weight=torch.from_numpy(w_s), mask=torch.from_numpy(msk_s),
                n_nodes=int(n_b),
            ).to(self.device)
            res, err, attempts = self._solve_group(
                (int(n_b), int(m_b)),
                stacked,
                min(q.submitted_at for q, _, _ in items),
            )
            if res is None:
                bucket = (int(n_b), int(m_b), int(lanes))
                for q, padded, nodes in items:
                    results.append(
                        self._fallback(
                            q,
                            int(len(nodes)),
                            int(padded.mask.sum()),
                            bucket,
                            err,
                            attempts,
                        )
                    )
                continue
            best_alive, best_rho = self._fetch_group(res)
            done_at = self._time()
            self.lanes_solved += lanes
            self.pad_lanes += lanes - len(items)
            self.bucket_histogram[(n_b, m_b)] = (
                self.bucket_histogram.get((n_b, m_b), 0) + lanes
            )
            for j, (q, padded, nodes) in enumerate(items):
                member_nodes = self._members(nodes, best_alive[j])
                result = QueryResult(
                    qid=q.qid,
                    seed=q.seed,
                    nodes=member_nodes,
                    density=float(best_rho[j]),
                    seed_in_set=self._seed_in(member_nodes, q.seed),
                    n_ego=int(len(nodes)),
                    m_ego=int(padded.mask.sum()),
                    bucket=(int(n_b), int(m_b), int(lanes)),
                    latency_s=float(done_at - q.submitted_at),
                    attempts=attempts,
                )
                if keep_last_good:
                    self._last_good[q.seed] = result
                results.append(result)
        self.queries_answered += len(batch)
        self.batches_flushed += 1
        results.sort(key=lambda r: r.qid)
        return results

    @staticmethod
    def _fetch_group(res) -> Tuple[np.ndarray, np.ndarray]:
        """A group's ``best_alive`` [lanes, n_b] and ``best_density``
        [lanes] on the host, in one device-to-host copy (both packed as
        bytes; the density keeps its float32 bits)."""
        alive, rho = res.best_alive, res.best_density
        packed = torch.cat([alive.reshape(-1).view(torch.uint8),
                            rho.reshape(-1).view(torch.uint8)])
        host = hostsync.fetch(packed)
        cut = alive.numel()
        return (host[:cut].view(bool).reshape(alive.shape),
                host[cut:].view(np.float32))

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Engine counters in one dict (resilience outcomes included)."""
        return {
            "queries_answered": self.queries_answered,
            "batches_flushed": self.batches_flushed,
            "lanes_solved": self.lanes_solved,
            "pad_lanes": self.pad_lanes,
            "queries_rejected": self.queries_rejected,
            "queries_degraded": self.queries_degraded,
            "queries_failed": self.queries_failed,
            "solve_retries": self.solve_retries,
            "local_nodes_touched": self.local_nodes_touched,
            "local_edges_scanned": self.local_edges_scanned,
            "breaker_open_skips": self.breaker_open_skips,
            "deadline_stops": self.deadline_stops,
            "breaker_opened": (
                self._breaker.opened if self._breaker is not None else 0
            ),
        }
