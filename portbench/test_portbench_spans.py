"""The program's spans in a synthetic trace (``portbench/spans.py``) and the
reader of ``sync_wait_ms`` on a synthetic run."""

import time
import types

import pytest

from portbench import roofline, spans, trace
from portbench.spans import Event

MS = 1_000_000  # ns
P = "repro_torch."


def _program_events(mirrors=True):
    """One query, [0, 10) ms, with the program's spans on the host, the
    host ops that launch the device work (by correlation id) and, with
    ``mirrors``, each leaf span's mirror on the device's timeline (which the
    reduction does not read).  A device op and the CUDA API call that
    launched it share their correlation ids.

    host:   solve [0.5, 9.5) > rung.0 [1, 9) > tiling [1, 1.5), pass [2, 5)
            > degrees [2, 3); rung.0 > sync.pass_test [5, 7), compact [7, 8.5)
    device: sort [1.2, 1.8), index_add [3, 4), copy [6, 6.5), cumsum [7.5, 8)
    A warm-up before the window has a span and a kernel of its own."""
    ev = [
        Event(trace.SPAN, False, 0, 10 * MS, "user_annotation"),
        Event("portbench.warmup", False, -6 * MS, -1 * MS, "user_annotation"),
        Event(P + "degrees", False, -5 * MS, -4 * MS, "user_annotation"),
        Event("aten::index_add_", False, -5 * MS, -4 * MS, "cpu_op", corr=9),
        Event("cudaLaunchKernel", False, -5 * MS, -4 * MS, "cuda_runtime", corr=109, linked=9),
        Event("indexFuncLargeIndex", True, -4 * MS, -3 * MS, "kernel", corr=109, linked=9),
        Event(P + "solve", False, MS // 2, 9 * MS + MS // 2, "user_annotation"),
        Event(P + "rung.0", False, 1 * MS, 9 * MS, "user_annotation"),
        Event(P + "tiling", False, 1 * MS, 1 * MS + MS // 2, "user_annotation"),
        Event("aten::sort", False, 1100_000, 1300_000, "cpu_op", corr=10),
        Event("cudaLaunchKernel", False, 1150_000, 1160_000, "cuda_runtime", corr=110, linked=10),
        Event("DeviceRadixSortOnesweepKernel", True, 1200_000, 1800_000, "kernel", corr=110,
              linked=10),
        Event(P + "pass", False, 2 * MS, 5 * MS, "user_annotation"),
        Event(P + "degrees", False, 2 * MS, 3 * MS, "user_annotation"),
        Event("aten::index_add_", False, 2200_000, 2500_000, "cpu_op", corr=11),
        # A collision: an op elsewhere bears the launch's correlation id.
        Event("aten::zeros", False, 8600_000, 8700_000, "cpu_op", corr=111),
        Event("cudaLaunchKernel", False, 2300_000, 2310_000, "cuda_runtime", corr=111, linked=11),
        Event("indexFuncLargeIndex", True, 3 * MS, 4 * MS, "kernel", corr=111, linked=11),
        Event(P + "sync.pass_test", False, 5 * MS, 7 * MS, "user_annotation"),
        Event("aten::_local_scalar_dense", False, 5100_000, 6900_000, "cpu_op", corr=13),
        Event("cudaMemcpyAsync", False, 5200_000, 6900_000, "cuda_runtime", corr=113, linked=13),
        Event("Memcpy DtoH", True, 6 * MS, 6 * MS + MS // 2, "gpu_memcpy", corr=113, linked=13),
        Event(P + "compact", False, 7 * MS, 8 * MS + MS // 2, "user_annotation"),
        Event("aten::cumsum", False, 7100_000, 7200_000, "cpu_op", corr=12),
        # A kernel launched outside any torch op (a hand kernel): linked 0.
        Event("cudaLaunchKernel", False, 7300_000, 7310_000, "cuda_runtime", corr=112),
        Event("DeviceScanKernel", True, 7 * MS + MS // 2, 8 * MS, "kernel", corr=112),
    ]
    if mirrors:
        ev += [Event(P + "degrees", True, -4 * MS, -3 * MS, "gpu_user_annotation"),
               Event(P + "tiling", True, 1200_000, 1800_000, "gpu_user_annotation"),
               Event(P + "degrees", True, 3 * MS, 4 * MS, "gpu_user_annotation"),
               Event(P + "sync.pass_test", True, 6 * MS, 6 * MS + MS // 2, "gpu_user_annotation"),
               Event(P + "compact", True, 7 * MS + MS // 2, 8 * MS, "gpu_user_annotation")]
    return ev


# Idle a span is the innermost open over, by hand from the layout above.
IDLE_MS = {trace.SPAN: 1.0, P + "solve": 1.0, P + "tiling": 0.2, P + "rung.0": 0.7,
           P + "degrees": 1.0, P + "pass": 1.0, P + "sync.pass_test": 1.5, P + "compact": 1.0}


@pytest.mark.parametrize("mirrors", [True, False], ids=["mirrors", "by_launch"])
def test_span_busy_counts_only_device_work_under_the_span(mirrors):
    # Busy is counted by launch, whether the trace holds the spans' mirrors
    # on the device's timeline or not.
    s = spans.summarize(_program_events(mirrors))
    assert s.busy_s == pytest.approx(0.0026)
    got = {k: v * 1e3 for k, v in s.span_busy_s.items()}
    assert got[P + "degrees"] == pytest.approx(1.0)  # the warm-up's kernel is out
    assert got[P + "tiling"] == pytest.approx(0.6)
    assert got[P + "compact"] == pytest.approx(0.5)
    assert got[P + "sync.pass_test"] == pytest.approx(0.5)
    # Outer spans: the work launched inside their host ranges, inner spans'
    # included.
    assert got[P + "pass"] == pytest.approx(1.0)
    assert got[P + "solve"] == pytest.approx(2.6)
    rows = {(r[0], r[1]): r[2:] for r in s.span_rows}
    assert rows[(P + "rung.0", P + "degrees")][:2] == [1, pytest.approx(0.001)]  # warm-up's out
    assert rows[(P + "rung.0", P + "rung.0")][:2] == [1, pytest.approx(0.008)]


def test_idle_goes_to_the_innermost_span_and_sums_to_the_window():
    s = spans.summarize(_program_events())
    assert {k: v * 1e3 for k, v in s.idle_s_by_span.items()} == pytest.approx(IDLE_MS)
    holes = 5  # [0, 1.2), [1.8, 3), [4, 6), [6.5, 7.5), [8, 10) ms
    idle = sum(s.idle_s_by_span.values())
    assert abs(idle - (s.window_s - s.busy_s)) <= holes * 1e-9
    base = trace.summarize(_program_events())
    assert (s.window_s, s.busy_s, s.queries) == (base.window_s, base.busy_s, base.queries)


def test_span_rows_go_rung_by_rung():
    s = spans.summarize(_program_events())
    rows = {(r[0], r[1]): r[2:] for r in s.span_rows}
    rung = P + "rung.0"
    assert rows[(rung, P + "degrees")] == pytest.approx([1, 0.001, 0.001, 0.001])
    assert rows[(rung, P + "compact")] == pytest.approx([1, 0.0015, 0.0005, 0.001])
    assert rows[(rung, rung)] == pytest.approx([1, 0.008, 0.0026, 0.0007])
    assert rows[("", P + "solve")] == pytest.approx([1, 0.009, 0.0026, 0.001])
    assert rows[("", trace.SPAN)] == pytest.approx([0, 0, 0, 0.001])
    line = spans.span_line(s)
    assert "; compact 1.000/1.500000/0.500000/1.000000;" in line
    assert line.index("-:solve") < line.index("rung.0:compact")  # outside any rung first


def test_program_spans_leave_busy_and_device_ops_as_they_were():
    # The same trace without the program's spans or their mirrors: the
    # benchmark's own reduction reads the same busy time, device ops and
    # idle gaps' lengths (a gap may now be named by a program span).
    full = _program_events()
    bare = [e for e in full if not e.name.startswith(P)]
    s, base = trace.summarize(full), trace.summarize(bare)
    assert s.busy_s == base.busy_s and s.window_s == base.window_s
    assert s.device_s_by_name == base.device_s_by_name
    assert [g[1] for g in s.gaps] == [g[1] for g in base.gaps]
    assert spans.summarize(bare) is None
    assert spans.span_line(None) == "[trace.spans] no program span in the trace"


def test_span_readings_on_a_synthetic_trace():
    work = [[(1_000_000, 50_000)]]
    got = spans.readings(spans.summarize(_program_events()), work)
    assert got["pass_idle_ms"] == pytest.approx(2.0)  # pass 1.0 + degrees 1.0
    assert got["compact_busy_ms"] == pytest.approx(0.5)
    assert got["tiling_busy_ms"] == pytest.approx(0.6)
    need = roofline.degree_need_bytes(work)
    assert got["degree_step_roofline_pct"] == pytest.approx(100 * need / 3.35e12 / 0.001)


@pytest.mark.parametrize("name", ["pass_idle_ms", "compact_busy_ms", "tiling_busy_ms",
                                  "degree_step_roofline_pct"])
def test_span_readings_are_none_without_a_trace_or_a_span(name):
    work = [[(10, 5)]]
    assert spans.readings(None, work)[name] is None
    # A trace without the span: nothing, and never a share of nothing.
    drop = {"pass_idle_ms": (P + "pass", P + "degrees"), "compact_busy_ms": (P + "compact",),
            "tiling_busy_ms": (P + "tiling",), "degree_step_roofline_pct": (P + "degrees",)}[name]
    s = spans.summarize([e for e in _program_events() if e.name not in drop])
    assert spans.readings(s, work)[name] is None
    if name == "degree_step_roofline_pct":  # the span launched no device work
        s = spans.summarize([e for e in _program_events() if e.name != "indexFuncLargeIndex"])
        assert spans.readings(s, work)[name] is None


class _Kineto:
    """A kineto event with its correlation ids (none on an older torch)."""

    def __init__(self, name, on_device, start, end, kind, corr=None):
        import torch

        self._n, self._s, self._d, self._k = name, start, end - start, kind
        self._t = torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU
        if corr is not None:
            self.correlation_id = lambda: corr[0]
            self.linked_correlation_id = lambda: corr[1]

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k


def _fields(e):
    return (e.name, e.on_device, e.start_ns, e.end_ns, e.kind)


@pytest.mark.parametrize("with_ids", [True, False])
def test_events_keep_their_correlation_ids(with_ids):
    ids = (lambda c: c) if with_ids else (lambda c: None)
    raw = [_Kineto(trace.SPAN, False, 0, 10 * MS, "user_annotation", ids((1, 0))),
           _Kineto(P + "degrees", False, 1 * MS, 5 * MS, "user_annotation", ids((2, 0))),
           _Kineto("cudaLaunchKernel", False, 2 * MS, 3 * MS, "cuda_runtime", ids((7, 6))),
           _Kineto("add_kernel", True, 3 * MS, 4 * MS, "kernel", ids((7, 6)))]
    got = spans.events_from_kineto(raw)
    assert [_fields(e) for e in got] == [_fields(e) for e in trace.events_from_kineto(raw)]
    assert [(e.corr, e.linked) for e in got] == (
        [(1, 0), (2, 0), (7, 6), (7, 6)] if with_ids else [(0, 0)] * 4)
    s = spans.summarize(got)
    assert s.span_busy_s[P + "degrees"] == (pytest.approx(0.001) if with_ids else 0)


# ---------------------------------------------------------------------------
# sync_wait_ms: the program's timed reads over the window
# ---------------------------------------------------------------------------


def _sync_wait():
    from portbench import spec

    m = [m for m in spec.load_benchmark()["per_layer"] if m["name"] == "sync_wait_ms"][0]
    return spec.Metric(m["name"], m["unit"], m["better"], m["source"], "per_layer", m).reader()


def test_sync_wait_sums_the_windows_reads(monkeypatch):
    import collections

    from repro_torch import hostsync

    # Two reads before the window (the warm-up), then three in it over two
    # queries: only the last three count.
    waits = collections.deque([("pass_test", 9.0), ("other", 9.0), ("pass_test", 0.002),
                               ("rung_scalars", 0.001), ("pass_test", 0.003)], maxlen=8)
    monkeypatch.setattr(hostsync.read, "waits", waits)
    run = types.SimpleNamespace(walls=[0.010, 0.010], host_syncs=3)
    assert _sync_wait()(run) == pytest.approx(3.0)  # 6 ms over two queries
    run.host_syncs = 0
    assert _sync_wait()(run) == 0.0


def test_sync_wait_reads_nothing_it_cannot_see(monkeypatch):
    import collections

    from repro_torch import hostsync

    monkeypatch.setattr(hostsync.read, "waits", collections.deque([("other", 0.001)] * 4, maxlen=4))
    assert _sync_wait()(types.SimpleNamespace(walls=[0.01], host_syncs=5)) is None  # past the log
    assert _sync_wait()(types.SimpleNamespace(walls=[], host_syncs=0)) is None  # no query
    monkeypatch.delattr(hostsync.read, "waits")  # a program that does not time its reads
    assert _sync_wait()(types.SimpleNamespace(walls=[0.01], host_syncs=1)) is None


@pytest.mark.cuda
def test_a_host_sleep_inside_a_span_lands_under_it_on_the_card():
    # Spans and kernels share the trace's one clock: a 5 ms host sleep in a
    # program span between two kernels makes an idle gap of the device, and
    # at least 90% of that gap lands under the span.
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device's timeline exists only on the card")
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import hostsync

    name = P + "test.sleep"
    x = torch.ones(1 << 24, device="cuda")

    def step(sleep):
        y = x * 2
        torch.cuda.synchronize()
        with hostsync.span(name):
            time.sleep(0.005 if sleep else 0)
        (y + 1).sum()
        torch.cuda.synchronize()

    step(False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(False)  # the profiler's first launches, before the window
        with record_function(trace.SPAN):
            step(True)
    events = spans.events_from_profiler(prof)
    s = spans.summarize(events)
    (sleep,) = [e for e in events if e.name == name and not e.on_device
                and e.end_ns - e.start_ns >= 5_000_000]
    dev = [e for e in events if e.is_device_work]
    gap = (min(e.start_ns for e in dev if e.start_ns >= sleep.start_ns)
           - max(e.end_ns for e in dev if e.end_ns <= sleep.start_ns)) / 1e9
    assert gap >= 0.005
    assert s.idle_s_by_span[name] >= 0.9 * gap
    assert abs(sum(s.idle_s_by_span.values()) - (s.window_s - s.busy_s)) <= 0.01 * s.window_s
