"""The port's own spans (``repro_torch.*``, from ``repro_torch.hostsync.span``)
in a profiled window, and a tool that prints them for one traced run:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell once as ``run.py --trace 1`` does and prints its lines and
result line, then a ``[trace.spans]`` line (a query, by span name and rung
by rung: the count, the host ms, the device's busy ms and its idle ms) and
the readings of :func:`readings` as JSON.

A span's busy time is the union of the device work launched inside one of
its host ranges, the work of the spans inside it included: the launch is
the CUDA runtime call on the host that shares the device op's correlation
ids.  (A span's device-side mirror is not read: on torch 2.11 it covers
only what the span launched as the innermost span open.)  Each idle
instant of the window is put down to the innermost program span open on
the host at that instant, else to the harness's query span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):  # run as a script: this folder shadows the standard library
    _root = Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _root / "portbench"]
    sys.path.insert(0, str(_root))

from portbench import roofline, trace  # noqa: E402

PROGRAM_PREFIX = "repro_torch."
RUNG_PREFIX = "repro_torch.rung."
PASS = ("repro_torch.pass", "repro_torch.degrees")
DEGREES = "repro_torch.degrees"
COMPACT = "repro_torch.compact"
TILING = "repro_torch.tiling"


@dataclasses.dataclass(frozen=True)
class Event(trace.Event):
    # Kineto's correlation ids, 0 where the trace gives none: a device op and
    # the runtime call on the host that launched it share both.
    corr: int = 0
    linked: int = 0


@dataclasses.dataclass
class Spans:
    queries: int
    window_s: float
    busy_s: float
    # By name, the device's busy seconds of the work launched inside the
    # span (inner spans' included), and the idle seconds whose innermost
    # span it is (under the query span where none is open); rung by rung,
    # [rung span or "", span, count, host s, busy s, idle s].
    span_busy_s: Dict[str, float]
    idle_s_by_span: Dict[str, float]
    span_rows: List[list]


def events_from_kineto(raw) -> List[Event]:
    """``trace.events_from_kineto``'s events with their correlation ids."""
    raw = list(raw)
    return [Event(**dataclasses.asdict(e),
                  corr=ev.correlation_id() if hasattr(ev, "correlation_id") else 0,
                  linked=ev.linked_correlation_id() if hasattr(ev, "linked_correlation_id")
                  else 0)
            for e, ev in zip(trace.events_from_kineto(raw), raw)]


def events_from_profiler(prof) -> List[Event]:
    return events_from_kineto(prof.profiler.kineto_results.events())


def _nest(spans: List[Event]) -> List[Event]:
    """Spans in the order a stack takes them: by start, the outer first."""
    return sorted(spans, key=lambda e: (e.start_ns, -e.end_ns))


def _open_at(spans: List[Event], instants: Sequence[int]) -> List[List[Event]]:
    """For each instant (sorted), the spans open there, outermost first;
    ``spans`` as :func:`_nest` orders them."""
    out, stack, i = [], [], 0
    for t in instants:
        while i < len(spans) and spans[i].start_ns <= t:
            stack.append(spans[i])
            i += 1
        stack = [e for e in stack if e.end_ns > t]
        out.append(list(stack))
    return out


def _rung(stack: Sequence[Event]) -> str:
    """The rung span open around the innermost of ``stack``, or itself."""
    return next((e.name for e in reversed(stack) if e.name.startswith(RUNG_PREFIX)), "")


def _idle_by_innermost(holes: List[Tuple[int, int]], spans: List[Event],
                       default: str) -> Dict[Tuple[str, str], int]:
    """Each idle instant of ``holes`` (sorted, disjoint) put down to the
    innermost span open there, as ``(rung, span) -> ns``; ``default``
    where none is.  ``spans`` as :func:`_nest` orders them."""
    out: Dict[Tuple[str, str], int] = {}
    stack: List[Event] = []
    i = 0
    for a, b in holes:
        t = a
        while t < b:
            while i < len(spans) and spans[i].start_ns <= t:
                stack.append(spans[i])
                i += 1
            stack = [e for e in stack if e.end_ns > t]
            nxt = min([b] + [e.end_ns for e in stack])
            if i < len(spans):
                nxt = min(nxt, spans[i].start_ns)
            key = (_rung(stack), stack[-1].name if stack else default)
            out[key] = out.get(key, 0) + (nxt - t)
            t = nxt
    return out


def _busy_by_launch(events: Sequence[Event], dev: List[Event], spans: List[Event], lo: int,
                    hi: int) -> Tuple[Dict[Tuple[str, str], int], Dict[str, int]]:
    """Device work put down to every program span open on the host when it
    was launched, inside the window: busy ns by ``(rung, span)`` and by span
    name.  The launch is the CUDA runtime call (``cu*``) that shares the
    device op's correlation ids."""
    launch_ns = {(e.corr, e.linked): e.start_ns for e in events
                 if e.corr and not e.on_device and e.name.startswith("cu")}
    launched = sorted((launch_ns[(d.corr, d.linked)], max(d.start_ns, lo), min(d.end_ns, hi))
                      for d in dev if d.corr and (d.corr, d.linked) in launch_ns)
    by_row: Dict[Tuple[str, str], list] = {}
    by_name: Dict[str, list] = {}
    for (_, a, b), stack in zip(launched, _open_at(spans, [t for t, _, _ in launched])):
        rung = ""  # a span's rung is the one open around it, or itself
        for e in stack:
            if e.name.startswith(RUNG_PREFIX):
                rung = e.name
            by_row.setdefault((rung, e.name), []).append((a, b))
            by_name.setdefault(e.name, []).append((a, b))
    return ({k: sum(b - a for a, b in trace.union(v)) for k, v in by_row.items()},
            {k: sum(b - a for a, b in trace.union(v)) for k, v in by_name.items()})


def summarize(events: Sequence[Event], span: str = trace.SPAN) -> Optional[Spans]:
    """The program's spans in the window of ``span`` (as ``trace.summarize``
    takes it), or None when the window, its device work or its program
    spans are missing."""
    queries = [e for e in events if not e.on_device and e.name == span]
    if not queries:
        return None
    lo, hi = min(e.start_ns for e in queries), max(e.end_ns for e in queries)
    dev = [e for e in events if e.is_device_work and e.end_ns > lo and e.start_ns < hi]
    spans = _nest([e for e in events if not e.on_device and e.name.startswith(PROGRAM_PREFIX)
                   and lo <= e.start_ns < hi])
    if not dev or not spans:
        return None
    busy = trace.union((max(e.start_ns, lo), min(e.end_ns, hi)) for e in dev)
    holes, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    rows: Dict[Tuple[str, str], list] = {}  # (rung, span) -> [count, host, busy, idle] ns
    for e, stack in zip(spans, _open_at(spans, [e.start_ns for e in spans])):
        # Spans that start with e and sit inside it are open too: cut them.
        row = rows.setdefault((_rung(stack[:stack.index(e) + 1]), e.name), [0, 0, 0, 0])
        row[0] += 1
        row[1] += e.end_ns - e.start_ns
    busy_by_row, busy_by_name = _busy_by_launch(events, dev, spans, lo, hi)
    for key, row in rows.items():
        row[2] = busy_by_row.get(key, 0)
    idle_ns: Dict[str, int] = {}
    for (rung, name), ns in _idle_by_innermost(holes, spans, span).items():
        idle_ns[name] = idle_ns.get(name, 0) + ns
        rows.setdefault((rung, name), [0, 0, 0, 0])[3] += ns
    return Spans(
        queries=len(queries), window_s=(hi - lo) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        span_busy_s={name: busy_by_name.get(name, 0) / 1e9 for _, name in rows},
        idle_s_by_span={k: v / 1e9 for k, v in idle_ns.items()},
        span_rows=[[rung, name, r[0], r[1] / 1e9, r[2] / 1e9, r[3] / 1e9]
                   for (rung, name), r in sorted(rows.items())])


def readings(s: Optional[Spans], work) -> Dict[str, Optional[float]]:
    """A query's figures from the spans, each None where its span is not in
    the trace: ``pass_idle_ms``, the device's idle ms whose innermost span
    is ``pass`` or ``degrees`` (the host's launch pace inside the peel loop,
    outside its reads); ``compact_busy_ms`` and ``tiling_busy_ms``, the
    busy ms under ``compact`` and ``tiling``; ``degree_step_roofline_pct``,
    ``degree_roofline_pct``'s need (``work``, the reference's replay) over
    the busy time under ``degrees``: the whole degree step, whatever kernels
    implement it."""
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("pass_idle_ms", "compact_busy_ms", "tiling_busy_ms", "degree_step_roofline_pct"))
    if s is None or not s.queries:
        return out
    q = s.queries
    if any(n in s.span_busy_s for n in PASS):
        out["pass_idle_ms"] = sum(s.idle_s_by_span.get(n, 0.0) for n in PASS) / q * 1e3
    for key, name in (("compact_busy_ms", COMPACT), ("tiling_busy_ms", TILING)):
        if name in s.span_busy_s:
            out[key] = s.span_busy_s[name] / q * 1e3
    if s.span_busy_s.get(DEGREES, 0.0) > 0:
        out["degree_step_roofline_pct"] = roofline.share_pct(
            roofline.degree_need_bytes(work) * q, s.span_busy_s[DEGREES])
    return out


def _short(name: str) -> str:
    return name.replace(PROGRAM_PREFIX, "")


def span_line(s: Optional[Spans]) -> str:
    """The ``[trace.spans]`` line: a query, count/host ms/busy ms/idle ms,
    by span name, then rung by rung (rows outside any rung first)."""
    if s is None:
        return "[trace.spans] no program span in the trace"
    q = max(s.queries, 1)

    def cell(count, host_s, busy_s, idle_s):
        return f"{count / q:.3f}/{host_s / q * 1e3:.6f}/{busy_s / q * 1e3:.6f}/{idle_s / q * 1e3:.6f}"

    count: Dict[str, int] = {}
    host_s: Dict[str, float] = {}
    for _, name, n, seconds, _, _ in s.span_rows:
        count[name] = count.get(name, 0) + n
        host_s[name] = host_s.get(name, 0.0) + seconds
    by_name = [f"{_short(n)} " + cell(count[n], host_s[n], s.span_busy_s[n],
                                      s.idle_s_by_span.get(n, 0.0)) for n in sorted(s.span_busy_s)]
    rungs = sorted(s.span_rows, key=lambda r: (int(r[0].rsplit(".", 1)[1]) if r[0] else -1, r[1]))
    by_rung = [f"{_short(r[0]) or '-'}:{_short(r[1])} " + cell(*r[2:]) for r in rungs]
    return ("[trace.spans] a query, count/host_ms/busy_ms/idle_ms (busy: launched inside, inner "
            f"spans included; idle: innermost span) by span: {'; '.join(by_name)} "
            f"|| by rung: {'; '.join(by_rung)}")


@contextlib.contextmanager
def _kept(module, name: str, fn, into: list):
    """``module.name`` replaced, for the block's length, by ``fn`` with each
    of its results appended to ``into``."""
    orig = getattr(module, name)

    def kept(*a, **k):
        into.append(fn(*a, **k))
        return into[-1]

    setattr(module, name, kept)
    try:
        yield
    finally:
        setattr(module, name, orig)


def main(argv=None) -> int:
    from portbench import run

    cores = run.prepare_process()
    args = run.parse_args(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"])
    from portbench import reference, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 3
    print(f"[setup] pinned_cores={cores}", flush=True)
    # run.py's own traced run, keeping its events (with their correlation
    # ids) and the reference's replay.
    events, replays = [], []
    with _kept(trace, "events_from_profiler", events_from_profiler, events), \
            _kept(reference, "replay", reference.replay, replays):
        line = run.run_cell(cell, args.seed, args.seconds, True, "cuda",
                            log=lambda s: print(s, flush=True))
    s = summarize(events[-1])
    print(span_line(s), flush=True)
    print(json.dumps({"correct": line["correct"], "metrics": line["metrics"],
                      "spans": readings(s, replays[-1].work)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
