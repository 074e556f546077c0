"""Deadline / retry / degrade policy layer for the serving runtime
(counterpart of ``repro.serve.resilience``, copied: pure host policy).

This module is the FAILURE half of serving.  It deliberately contains no
solving code — just the policy objects
:class:`repro_torch.serve.densest.DensestQueryEngine` consults on its solve
path:

  * :class:`ResilienceConfig` — per-query deadline budgets, a bounded
    retry schedule with exponential backoff and DETERMINISTIC jitter
    (seeded via :func:`repro_torch.faults.deterministic_uniform`, so a replayed
    fault storm replays its exact timing), circuit-breaker and
    load-shedding knobs, and the graceful-degradation ladder toggles
    (smaller-radius ego-net → cached turnstile density → last-good
    cached answer);
  * :class:`CircuitBreaker` — a per-bucket consecutive-failure breaker
    with a cooldown half-open probe, clock-injectable for tests.

The degradation contract (the reference's): a degraded answer is
always REAL data — a genuinely solved smaller ego-net, a genuinely
computed whole-graph density, or a previously verified answer — flagged
``degraded=True`` with ``fallback`` naming its provenance.  Nothing is
ever fabricated; when the ladder is exhausted the query returns
``status='failed'`` with the real error attached.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.faults import deterministic_uniform

__all__ = ["CircuitBreaker", "ResilienceConfig"]

# QueryResult.status values (serve/densest.py attaches them).
STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_REJECTED = "rejected"
STATUS_FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Per-engine resilience policy.

    ``deadline_ms`` is the per-query latency budget measured from
    ``submit()``: the FIRST solve attempt always runs (an answer beats a
    breach by microseconds), but retries are granted only while the
    group's oldest query still has budget; past it, failure goes straight
    to the degradation ladder.  ``max_retries`` bounds re-solves of a
    failed bucket group; retry ``i`` waits
    ``backoff_base_ms * backoff_mult**(i-1)`` scaled by a deterministic
    jitter in ``[1 - backoff_jitter, 1)``.  ``breaker_threshold``
    consecutive failures of one bucket open its circuit for
    ``breaker_cooldown_s`` (then one half-open probe).  ``max_queue``
    bounds the admission queue — the excess is shed at submit time with
    an explicit ``rejected`` outcome instead of unbounded queueing.
    """

    deadline_ms: Optional[float] = None
    max_retries: int = 2
    backoff_base_ms: float = 1.0
    backoff_mult: float = 2.0
    backoff_jitter: float = 0.5
    jitter_seed: int = 0
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 30.0
    max_queue: Optional[int] = None
    degrade_radius: bool = True
    degrade_turnstile: bool = True
    degrade_last_good: bool = True

    def __post_init__(self):
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms={self.deadline_ms} must be > 0")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")
        if self.backoff_base_ms < 0:
            raise ValueError(
                f"backoff_base_ms={self.backoff_base_ms} must be >= 0"
            )
        if self.backoff_mult < 1.0:
            raise ValueError(
                f"backoff_mult={self.backoff_mult} must be >= 1"
            )
        if not (0.0 <= self.backoff_jitter <= 1.0):
            raise ValueError(
                f"backoff_jitter={self.backoff_jitter} not in [0, 1]"
            )
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold={self.breaker_threshold} must be >= 1"
            )
        if self.breaker_cooldown_s < 0:
            raise ValueError(
                f"breaker_cooldown_s={self.breaker_cooldown_s} must be >= 0"
            )
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")

    def backoff_s(self, retry: int, key: Any = None) -> float:
        """Seconds to wait before retry number ``retry`` (1-based) of the
        work item identified by ``key``.  Exponential in ``retry`` with a
        deterministic jitter: two processes with the same config and key
        back off identically (replayable chaos tests), while distinct
        keys decorrelate (no synchronized thundering-herd retries)."""
        if retry < 1:
            raise ValueError(f"retry={retry} must be >= 1 (1-based)")
        step = self.backoff_base_ms * self.backoff_mult ** (retry - 1)
        u = deterministic_uniform(self.jitter_seed, key, retry)
        return step * (1.0 - self.backoff_jitter * u) / 1000.0


class CircuitBreaker:
    """Per-key consecutive-failure circuit breaker.

    ``record_failure`` increments a key's consecutive-failure count and
    opens the circuit (stamps the cooldown clock) at ``threshold``;
    ``record_success`` resets it.  ``allow`` answers "may this key
    attempt real work right now?" — True while closed, False while open,
    and True again once the cooldown elapses (the half-open probe; a
    probe failure re-opens with a fresh cooldown).  Keys are independent:
    one poisoned bucket shape cannot trip the whole engine.
    """

    def __init__(
        self,
        threshold: int,
        cooldown_s: float,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"threshold={threshold} must be >= 1")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s={cooldown_s} must be >= 0")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._time = time_fn
        self._consecutive: Dict[Any, int] = {}
        self._opened_at: Dict[Any, float] = {}
        self.opened = 0  # times any key's circuit opened (incl. re-opens)

    def state(self, key: Any) -> str:
        if self._consecutive.get(key, 0) < self.threshold:
            return "closed"
        if self._time() - self._opened_at[key] >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow(self, key: Any) -> bool:
        return self.state(key) != "open"

    def record_success(self, key: Any) -> None:
        self._consecutive.pop(key, None)
        self._opened_at.pop(key, None)

    def record_failure(self, key: Any) -> None:
        n = self._consecutive.get(key, 0) + 1
        self._consecutive[key] = n
        if n >= self.threshold:
            # Opening (or re-opening after a failed half-open probe)
            # restarts the cooldown window.
            self._opened_at[key] = self._time()
            self.opened += 1
