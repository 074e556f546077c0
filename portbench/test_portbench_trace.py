"""The trace reduction and the roofline arithmetic on a synthetic trace."""

import types

import pytest

from portbench import roofline, trace
from portbench.trace import Event

MS = 1_000_000  # ns


def _events():
    # Two queries: [0, 10) ms and [10, 20) ms.  On the device: a kernel at
    # [1, 4) and a copy at [3, 6) on another stream (overlapping), a degree
    # kernel at [12, 15); a user annotation spanning the query is no work.
    return [
        Event(trace.SPAN, False, 0, 10 * MS),
        Event(trace.SPAN, False, 10 * MS, 20 * MS),
        Event("portbench.warmup", False, -30 * MS, -1 * MS),
        Event("gemm_kernel", True, -20 * MS, -10 * MS),  # before the window
        Event("gemm_kernel", True, 1 * MS, 4 * MS),
        Event("Memcpy DtoH", True, 3 * MS, 6 * MS),
        Event("tiled_degree_kernel", True, 12 * MS, 15 * MS),
        Event(trace.SPAN, True, 0, 10 * MS, "gpu_user_annotation"),
        Event("aten::_local_scalar_dense", False, 6 * MS, 12 * MS),
        Event("aten::item", False, 5 * MS, 12 * MS),
        Event("aten::sort", False, 15 * MS, 19 * MS),
    ]


def test_union_merges_overlaps_once():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_window_busy_idle_and_names():
    s = trace.summarize(_events())
    assert s.queries == 2
    assert s.window_s == pytest.approx(0.020)
    assert s.busy_s == pytest.approx(0.008)  # [1, 6) and [12, 15)
    assert s.idle_share == pytest.approx(0.6)
    assert s.device_s(["degree"]) == pytest.approx(0.003)
    assert s.device_s(["gemm"]) == pytest.approx(0.003)  # the run before the window is out
    # Longest gap [6, 12): covered fully by both host ops; the shorter wins.
    assert s.gaps[0] == ("aten::_local_scalar_dense", pytest.approx(0.006))
    assert s.gaps[1] == ("aten::sort", pytest.approx(0.005))  # [15, 20)
    assert s.gaps[2] == ("host (no op recorded)", pytest.approx(0.001))  # [0, 1)


def test_program_spans_on_the_device_are_not_work():
    # A span the program adds shows on the device's timeline over its whole
    # range; whatever its name, it adds no busy time, no device op and no
    # degree time, and the idle gaps stay as they were.
    base = trace.summarize(_events())
    spans = [Event("solver.rung0.degrees", True, 5 * MS, 13 * MS, "gpu_user_annotation"),
             Event("solver.rung0.degrees", False, 5 * MS, 13 * MS, "user_annotation")]
    s = trace.summarize(_events() + spans)
    assert s.busy_s == pytest.approx(base.busy_s)
    assert s.device_s_by_name == base.device_s_by_name
    assert s.device_s(["degree"]) == pytest.approx(0.003)
    assert [g[1] for g in s.gaps] == pytest.approx([g[1] for g in base.gaps])


def test_breakdown_is_bounded_and_sorted():
    s = trace.summarize(_events())
    b = trace.breakdown(s, top=2)
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2
    assert b["device_ops"][0][1] >= b["device_ops"][1][1]


def test_no_span_or_no_device_op_reads_nothing():
    assert trace.summarize([Event("x", True, 0, 5)]) is None
    assert trace.summarize([Event(trace.SPAN, False, 0, 5)]) is None


def test_degree_need_and_share():
    work = [[(100, 10), (40, 6)], [(100, 10)]]  # two lanes
    need = roofline.degree_need_bytes(work)
    assert need == 12 * 240 + 4 * 26
    # The need moved at the full bandwidth takes need / 3.35e12 s: 100%.
    assert roofline.share_pct(need, need / 3.35e12) == pytest.approx(100.0)


def test_metric_readers_on_a_synthetic_run():
    from portbench import spec

    s = trace.summarize(_events())
    run = types.SimpleNamespace(
        walls=[0.010, 0.010], window_s=0.020, setup_s=9.5, peak_bytes=3 * 2**20,
        host_syncs=30, trace=s, work=[[(1_000_000, 50_000)]],
        traffic={"problem": {"backend": "pallas"}})
    bench = spec.load_benchmark()
    got = {}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            got[m["name"]] = spec.Metric(m["name"], m["unit"], m["better"], m["source"],
                                         kind, m).reader()(run)
    assert got["query_ms"] == pytest.approx(10.0)
    assert got["query_p95_ms"] == pytest.approx(10.0)
    assert got["peak_device_mb"] == pytest.approx(3.0)
    assert got["setup_s"] == 9.5
    assert got["device_idle_pct"] == pytest.approx(60.0)
    assert got["device_busy_ms"] == pytest.approx(4.0)  # 8 ms busy over two queries
    assert got["host_syncs_per_query"] == pytest.approx(15.0)
    need = 2 * (12 * 1_000_000 + 4 * 50_000)
    assert got["degree_roofline_pct"] == pytest.approx(100 * need / 3.35e12 / 0.003)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
def test_degree_roofline_raises_without_its_kernels(backend):
    # A trace with device work but no kernel of the cell's degree backend
    # (say, one renamed by the program) is an error, not a silent None.
    from portbench import spec

    events = [Event(trace.SPAN, False, 0, 10 * MS), Event("some_new_kernel", True, 1 * MS, 4 * MS)]
    run = types.SimpleNamespace(trace=trace.summarize(events), work=[[(10, 5)]],
                                traffic={"problem": {"backend": backend}})
    m = [m for m in spec.load_benchmark()["per_layer"] if m["name"] == "degree_roofline_pct"][0]
    reader = spec.Metric(m["name"], m["unit"], m["better"], m["source"], "per_layer", m).reader()
    with pytest.raises(LookupError, match="KERNELS"):
        reader(run)
    run.trace = None
    assert reader(run) is None


class _Kineto:
    """A kineto event as an older torch gives it: no activity type."""

    def __init__(self, name, on_device, start, end, annotation=None):
        import torch

        self._n, self._s, self._d = name, start, end - start
        self._t = torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU
        if annotation is not None:
            self.is_user_annotation = lambda: annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


@pytest.mark.parametrize("with_flag", [False, True])
def test_spans_are_told_without_an_activity_type(with_flag):
    flag = (lambda a: a) if with_flag else (lambda a: None)
    raw = [_Kineto(trace.SPAN, False, 0, 10 * MS, flag(True)),
           _Kineto(trace.SPAN, True, 0, 10 * MS, flag(True)),
           _Kineto("solver.pass", False, 2 * MS, 8 * MS, flag(True)),
           _Kineto("solver.pass", True, 2 * MS, 8 * MS, flag(True)),
           _Kineto("aten::add", False, 1 * MS, 2 * MS, flag(False)),
           _Kineto("add_kernel", True, 3 * MS, 4 * MS, flag(False))]
    s = trace.summarize(trace.events_from_kineto(raw))
    assert s.busy_s == pytest.approx(0.001)
    assert set(s.device_s_by_name) == {"add_kernel"}
