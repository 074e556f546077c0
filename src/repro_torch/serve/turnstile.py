"""Serving hook for the turnstile runtime: one live sketch, cheap "current
density" answers between update batches (counterpart of
``repro.serve.turnstile``).

:class:`TurnstileDensityService` owns a
:class:`~repro_torch.core.turnstile.TurnstileDensest` and adds the serving
concern the core runtime deliberately doesn't have: query-result CACHING
keyed on a dirty flag.  Updates are absorbed immediately (the sketch lives
on the device and is update-linear; an ``apply`` launches K3 once on the
card), but the sampled peel only reruns when an update actually landed
since the last query — repeated density reads between batches are O(1)
host lookups.  Under ``Problem.undirected(stream_mode='turnstile',
backend='pallas')`` that peel runs K1 once a pass.

A :class:`~repro_torch.serve.densest.DensestQueryEngine` can
:meth:`~repro_torch.serve.densest.DensestQueryEngine.attach_turnstile` one
of these, answering whole-graph "how dense is the graph RIGHT NOW" probes
from the same process that serves per-seed queries.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch import kernels
from repro_torch.core.api import DenseSubgraphResult, Problem, Solver
from repro_torch.core.turnstile import EdgeBatch, TurnstileDensest
from repro_torch.graph.edgelist import Device

__all__ = ["TurnstileDensityService"]


class TurnstileDensityService:
    """A live turnstile runtime with dirty-flag query caching, on ``device``
    (default: the card).

    ``apply()`` feeds ±edge batches to the sketch and marks the cached
    answer stale; ``result()`` / ``density()`` re-query ONLY when stale.
    Counters: ``updates_applied`` / ``batches_applied`` mirror the
    sketch's, ``queries_served`` counts reads, ``queries_computed`` counts
    actual sampled peels (the difference is cache traffic).

    Resilience: with ``serve_stale=True`` (default) a recompute that FAILS
    — sketch recovery exhausted its level escalation, or an injected fault
    — serves the last-good cached answer instead of raising, stamps
    ``last_error`` and counts ``stale_results_served``.  The stale answer
    is real previously computed data, never fabricated; with no cached
    answer yet the error propagates (there is nothing true to serve).
    """

    def __init__(
        self,
        n_nodes: int,
        problem: Optional[Problem] = None,
        *,
        solver: Optional[Solver] = None,
        cache_dir: Optional[str] = None,
        serve_stale: bool = True,
        device: Device = None,
        **driver_kw,
    ):
        if problem is None:
            problem = Problem.undirected(stream_mode="turnstile")
        if solver is None:
            solver = Solver(cache_dir=cache_dir)
        self.driver = TurnstileDensest(
            n_nodes, problem, solver=solver, device=device, **driver_kw
        )
        self.solver = solver
        self.serve_stale = bool(serve_stale)
        self._cached: Optional[DenseSubgraphResult] = None
        self._dirty = True  # an empty graph is still a valid first query
        self.queries_served = 0
        self.queries_computed = 0
        self.queries_failed = 0
        self.stale_results_served = 0
        self.last_error: Optional[str] = None

    @property
    def n_nodes(self) -> int:
        return self.driver.n_nodes

    @property
    def updates_applied(self) -> int:
        return self.driver.sketch.updates_applied

    @property
    def batches_applied(self) -> int:
        return self.driver.sketch.batches_applied

    def apply(
        self, insert_edges: EdgeBatch = None, delete_edges: EdgeBatch = None
    ) -> "TurnstileDensityService":
        """Absorbs one ±edge batch and marks the cached answer stale."""
        before = self.driver.sketch.batches_applied
        self.driver.apply(insert_edges, delete_edges)
        if self.driver.sketch.batches_applied != before:  # empty batch: no-op
            self._dirty = True
        return self

    def result(self) -> DenseSubgraphResult:
        """The current densest-subgraph answer (recomputed only if an
        update arrived since the last query)."""
        self.queries_served += 1
        if self._dirty or self._cached is None:
            try:
                self._cached = self.driver.query()
            except Exception as e:  # noqa: BLE001 — serve stale, never fake
                self.queries_failed += 1
                self.last_error = f"{type(e).__name__}: {e}"
                if self.serve_stale and self._cached is not None:
                    # Last-good answer; _dirty stays True so the next read
                    # retries the recompute.
                    self.stale_results_served += 1
                    return self._cached
                raise
            self.queries_computed += 1
            self._dirty = False
        return self._cached

    def density(self) -> float:
        """Current (1+eps)·(2+2eps)-approximate maximum density."""
        return float(self.result().best_density)

    def stats(self) -> Dict[str, Any]:
        """Serving + sketch + solver counters in one dict, so degraded
        operation (escalations, stale serves, failed kernel-cache stores)
        is observable from the service alone.  ``update_trace_count`` is
        the reference's count of update compilations; nothing compiles
        here, so it counts the K3 library builds this process made
        (``kernels.BUILD_LOG``): 0 once the cache of built kernels is
        warm, as the reference's is with a warm program cache."""
        from repro_torch.kernels.l0_sampler import ops as l0_ops

        return {
            "updates_applied": self.updates_applied,
            "batches_applied": self.batches_applied,
            "queries_served": self.queries_served,
            "queries_computed": self.queries_computed,
            "queries_failed": self.queries_failed,
            "stale_results_served": self.stale_results_served,
            "last_error": self.last_error,
            "recovery_failures": self.driver.sketch.recovery_failures,
            "recovery_escalations": self.driver.sketch.recovery_escalations,
            "update_trace_count": int(l0_ops.SOURCE.name in kernels.BUILD_LOG),
            "disk_store_errors": self.solver.disk_store_errors,
        }
