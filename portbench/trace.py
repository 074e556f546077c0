"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics and the ``breakdown`` read.

The traced window runs from the start of the first ``portbench.query``
span to the end of the last one.  Device time is the union of every
operation on the card (kernels, copies, sets) inside it, so overlapping
streams count once; busy and window come from the same trace.  An idle gap
is a stretch of the window with nothing on the card, named by the host
operation that covers most of it (the innermost on a tie).

Spans are not work: a ``record_function`` span, the harness's or the
program's, also shows on the device's timeline (kind
``gpu_user_annotation``) over its whole range, and events of the
annotation kinds never count as busy time or as a device operation.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPAN = "portbench.query"
SPAN_PREFIX = "portbench."
# Kineto's activity types of spans, on the host and on the device's timeline.
ANNOTATION_KINDS = frozenset({"user_annotation", "gpu_user_annotation"})


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    kind: str = ""  # kineto's activity type ("kernel", "gpu_user_annotation", ...)

    @property
    def is_device_work(self) -> bool:
        return self.on_device and self.kind not in ANNOTATION_KINDS


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    queries: int
    device_s_by_name: Dict[str, float]
    gaps: List[Tuple[str, float]]  # (host op, seconds), longest first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_s(self, patterns: Sequence[str]) -> float:
        """Seconds of the device operations whose name holds a pattern."""
        return sum(s for name, s in self.device_s_by_name.items()
                   if any(p in name for p in patterns))


def events_from_profiler(prof) -> List[Event]:
    """The kineto events of a finished ``torch.profiler.profile``."""
    return events_from_kineto(prof.profiler.kineto_results.events())


def events_from_kineto(raw) -> List[Event]:
    """Kineto events as :class:`Event`, each with its activity type.

    Where the installed torch does not report the type
    (``activity_type``), a span is told by ``is_user_annotation``, or
    failing that by its name: a span on the device's timeline bears the
    name of a host-side event, which no kernel or copy does."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    raw = list(raw)
    out = []
    for ev in raw:
        start = ev.start_ns()
        on_device = ev.device_type() != cpu
        if hasattr(ev, "activity_type"):
            kind = ev.activity_type()
        elif hasattr(ev, "is_user_annotation"):
            kind = ("gpu_user_annotation" if on_device else "user_annotation") \
                if ev.is_user_annotation() else ""
        else:
            kind = None
        out.append(Event(ev.name(), on_device, start, start + ev.duration_ns(), kind))
    if any(e.kind is None for e in out):
        host_names = {e.name for e in out if not e.on_device}
        out = [dataclasses.replace(e, kind="gpu_user_annotation" if e.on_device
                                   and e.name in host_names else "") for e in out]
    return out


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted disjoint intervals covering the same points."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _clip(iv: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def _name_gap(a: int, b: int, host: List[Event], starts: List[int]) -> str:
    """The host op covering most of ``[a, b)``; the shortest on a tie."""
    best, best_key = None, None
    # Host ops are short next to the window; look back a bounded stretch.
    i = bisect.bisect_right(starts, b)
    j = i
    while j > 0 and starts[j - 1] > a - 2_000_000_000:
        j -= 1
    for ev in host[j:i]:
        cover = min(ev.end_ns, b) - max(ev.start_ns, a)
        if cover <= 0:
            continue
        key = (cover, -(ev.end_ns - ev.start_ns))
        if best_key is None or key > best_key:
            best, best_key = ev, key
    return best.name if best is not None else "host (no op recorded)"


def summarize(events: Sequence[Event], span: str = SPAN, top_gaps: int = 10) -> Optional[Summary]:
    """The window's summary, or None when no span or no device op is in it."""
    spans = [e for e in events if not e.on_device and e.name == span]
    if not spans:
        return None
    lo = min(e.start_ns for e in spans)
    hi = max(e.end_ns for e in spans)
    dev = [e for e in events if e.is_device_work and e.end_ns > lo and e.start_ns < hi]
    if not dev:
        return None
    by_name: Dict[str, float] = {}
    for e in dev:
        a, b = max(e.start_ns, lo), min(e.end_ns, hi)
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e9
    busy = union(_clip(((e.start_ns, e.end_ns) for e in dev), lo, hi))
    busy_ns = sum(b - a for a, b in busy)
    holes = []
    prev = lo
    for a, b in busy:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        holes.append((prev, hi))
    holes.sort(key=lambda h: h[1] - h[0], reverse=True)
    host = sorted((e for e in events if not e.on_device and not e.name.startswith(SPAN_PREFIX)),
                  key=lambda e: e.start_ns)
    starts = [e.start_ns for e in host]
    gaps = [(_name_gap(a, b, host, starts), (b - a) / 1e9) for a, b in holes[:top_gaps]]
    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, queries=len(spans),
                   device_s_by_name=by_name, gaps=gaps)


def breakdown(summary: Summary, top: int = 10, width: int = 160) -> Dict[str, list]:
    """The ``breakdown`` of the result line: the device operations that took
    most time and the longest idle gaps, each at most ``top``."""
    ops = sorted(summary.device_s_by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {
        "device_ops": [[name[:width], s] for name, s in ops],
        "idle_gaps": [[name[:width], s] for name, s in summary.gaps[:top]],
    }
