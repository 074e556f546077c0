"""Seeded, deterministic fault injection (counterpart of ``repro.faults``,
copied: that module imports no JAX, but the port imports nothing of the
JAX package).

Instrumented sites call :func:`fire` with a stable site name and, where it
matters, a per-item key.  In the port the streaming driver fires
(``streaming.chunk``, keyed by the chunk index, and the checkpoint sites,
in ``core/streaming.py``), the spill ladder's publish
(``edgelist.spill_publish``, in ``graph/edgelist.py``), the turnstile
decode (``turnstile.decode``, keyed by the level, in
``core/turnstile.py``), the cache of built kernels
(``progcache.load``/``progcache.store``, keyed by the entry path, in
``core/progcache.py``) and the query engine (``serve.solve``, keyed by the
bucket or the fallback tag, in ``serve/densest.py``).  :data:`KNOWN_SITES`
is the reference's tuple, so a plan written for one package names the same
sites in the other.  With no plan installed the hook is a module-global
``None`` check: no cost and no change of behavior.

With a :class:`FaultPlan` installed, each ``fire`` consults the plan's
rules and may inject latency (a real sleep) and/or raise
:class:`InjectedFault`, deterministically:

  * ``fail_nth`` fails specific 1-based hit indices of a ``(site, key)``
    pair;
  * ``fail_prob`` fails each hit with probability ``p`` under a counter
    PRNG keyed on ``(plan seed, site, key, hit index)``: the same plan
    seed reproduces the same fault storm bit for bit, in any process;
  * ``latency_s`` sleeps before the (possible) failure; ``latency_nth``
    restricts the sleep to specific hits (default: every matching hit).

The plan records per-site/per-key hit and failure counters.

Sites (the fault-site table in docs/resilience.md):

=========================== ===================== =========================
site                        key                   effect of a failure
=========================== ===================== =========================
``streaming.chunk``         chunk index           chunk-worker retry path
``streaming.checkpoint_save``                     checkpoint write fails
``streaming.checkpoint_load``                     quarantine + fresh start
``progcache.load``          entry path            fail-open rebuild
``progcache.store``         entry path            best-effort store skipped
``edgelist.spill_publish``                        spill abort, rung dropped
``turnstile.decode``        level                 escalate a level sparser
``serve.solve``             bucket / fallback tag retry -> degrade chain
=========================== ===================== =========================
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "KNOWN_SITES",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "active",
    "deterministic_uniform",
    "fire",
    "install",
    "installed",
    "uninstall",
]

# The fault-site registry, the reference's tuple: every
# ``faults.fire(site, ...)`` call in the port names a site listed here.
# (FaultPlan rules stay permissive at runtime so tests can exercise the
# plan machinery with toy site names.)
KNOWN_SITES = (
    "streaming.chunk",
    "streaming.checkpoint_save",
    "streaming.checkpoint_load",
    "progcache.load",
    "progcache.store",
    "edgelist.spill_publish",
    "turnstile.decode",
    "serve.solve",
)


class InjectedFault(RuntimeError):
    """The error :func:`fire` raises at a scheduled failure.  A plain
    ``RuntimeError`` subclass so every real error-handling path (retry,
    fail-open, escalation, degradation) treats it like a genuine fault."""

    def __init__(self, site: str, key: Any, hit: int):
        super().__init__(
            f"injected fault at site={site!r} key={key!r} hit={hit}"
        )
        self.site = site
        self.key = key
        self.hit = hit


def deterministic_uniform(*parts: Any) -> float:
    """A uniform float in [0, 1) that is a pure function of ``parts``
    (hashed via their ``repr``): the counter PRNG behind ``fail_prob``
    schedules and the resilience layer's deterministic backoff jitter.
    Stable across processes and platforms (no ``hash()`` randomization)."""
    digest = hashlib.blake2b(
        "\x1f".join(repr(p) for p in parts).encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One failure schedule for one site.

    ``key=None`` matches every key fired at the site; a non-None ``key``
    matches only that key.  Hit indices are 1-based and counted per
    ``(site, key)`` pair (a keyed rule therefore counts each item's own
    attempts — attempt, speculative duplicate, retry — separately from
    its siblings').
    """

    site: str
    key: Any = None
    fail_nth: Tuple[int, ...] = ()
    fail_prob: float = 0.0
    max_fails: Optional[int] = None  # cap on fail_prob-triggered failures
    latency_s: float = 0.0
    latency_nth: Tuple[int, ...] = ()  # empty: latency on every hit

    def __post_init__(self):
        if not (0.0 <= self.fail_prob <= 1.0):
            raise ValueError(f"fail_prob={self.fail_prob} not in [0, 1]")
        if self.latency_s < 0:
            raise ValueError(f"latency_s={self.latency_s} must be >= 0")
        if self.max_fails is not None and self.max_fails < 0:
            raise ValueError(f"max_fails={self.max_fails} must be >= 0")

    def matches(self, key: Any) -> bool:
        return self.key is None or self.key == key


class FaultPlan:
    """A seeded set of :class:`FaultRule` schedules plus hit/failure
    accounting.  Build with the fluent helpers::

        plan = (FaultPlan(seed=7)
                .fail_nth("streaming.chunk", 1, 2, key=3)
                .fail_prob("serve.solve", 0.2)
                .latency("streaming.chunk", 0.5, nth=(1,), key=5))
        with faults.active(plan):
            ...

    Counters (all per plan, thread-safe): ``hits_at(site, key)`` /
    ``failures_at(site, key)`` aggregate over keys when ``key`` is left
    at its ``...`` sentinel.  ``sleep_fn`` is injectable so latency
    rules are testable without real sleeping.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        self.seed = int(seed)
        self.rules: list[FaultRule] = []
        self._sleep = sleep_fn
        self._lock = threading.Lock()
        self._hits: Dict[Tuple[str, Any], int] = {}
        self._failures: Dict[Tuple[str, Any], int] = {}
        self._prob_fails: Dict[int, int] = {}  # rule index -> fails so far

    # -- fluent rule builders ------------------------------------------------
    def add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def fail_nth(self, site: str, *nth: int, key: Any = None) -> "FaultPlan":
        return self.add(FaultRule(site=site, key=key, fail_nth=tuple(nth)))

    def fail_prob(
        self,
        site: str,
        p: float,
        *,
        key: Any = None,
        max_fails: Optional[int] = None,
    ) -> "FaultPlan":
        return self.add(
            FaultRule(site=site, key=key, fail_prob=p, max_fails=max_fails)
        )

    def latency(
        self,
        site: str,
        seconds: float,
        *,
        key: Any = None,
        nth: Tuple[int, ...] = (),
    ) -> "FaultPlan":
        return self.add(
            FaultRule(
                site=site, key=key, latency_s=seconds, latency_nth=tuple(nth)
            )
        )

    # -- accounting ----------------------------------------------------------
    def hits_at(self, site: str, key: Any = ...) -> int:
        with self._lock:
            if key is ...:
                return sum(
                    n for (s, _), n in self._hits.items() if s == site
                )
            return self._hits.get((site, key), 0)

    def failures_at(self, site: str, key: Any = ...) -> int:
        with self._lock:
            if key is ...:
                return sum(
                    n for (s, _), n in self._failures.items() if s == site
                )
            return self._failures.get((site, key), 0)

    # -- the hook ------------------------------------------------------------
    def fire(self, site: str, key: Any = None) -> None:
        with self._lock:
            hit = self._hits.get((site, key), 0) + 1
            self._hits[(site, key)] = hit
            delay = 0.0
            fail = False
            for i, rule in enumerate(self.rules):
                if rule.site != site or not rule.matches(key):
                    continue
                if rule.latency_s > 0 and (
                    not rule.latency_nth or hit in rule.latency_nth
                ):
                    delay = max(delay, rule.latency_s)
                if hit in rule.fail_nth:
                    fail = True
                elif rule.fail_prob > 0:
                    budget_ok = (
                        rule.max_fails is None
                        or self._prob_fails.get(i, 0) < rule.max_fails
                    )
                    if budget_ok and (
                        deterministic_uniform(self.seed, site, key, hit)
                        < rule.fail_prob
                    ):
                        self._prob_fails[i] = self._prob_fails.get(i, 0) + 1
                        fail = True
            if fail:
                self._failures[(site, key)] = (
                    self._failures.get((site, key), 0) + 1
                )
        # Sleep OUTSIDE the lock: concurrent sites (chunk workers) must not
        # serialize on an injected straggler.
        if delay > 0:
            self._sleep(delay)
        if fail:
            raise InjectedFault(site, key, hit)


# -- module-level installation ----------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Installs ``plan`` as the process-wide active plan (replacing any
    previous one) and returns it."""
    global _ACTIVE
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"install expects a FaultPlan, got {type(plan).__name__}")
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    """Removes the active plan; every ``fire`` is a no-op again."""
    global _ACTIVE
    _ACTIVE = None


def installed() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def active(plan: FaultPlan):
    """Context manager: install ``plan`` for the block, restore the
    previous plan (usually None) on exit — exception or not."""
    global _ACTIVE
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        _ACTIVE = prev


def fire(site: str, key: Any = None) -> None:
    """The injection hook instrumented sites call.  No plan installed —
    the common production case — is one global read and a ``None`` check;
    the site's behavior and outputs are untouched."""
    plan = _ACTIVE
    if plan is None:
        return
    plan.fire(site, key)
