"""The port's spans and counted host reads (``repro_torch.hostsync``).

A ladder solve under ``torch.profiler`` records one span a pass, one a
rung, one a host read, the degree step inside each pass and everything
inside the solve; with no profiler no ``record_function`` is entered and
the answer is bitwise the same.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import hostsync
from repro_torch.core.api import Problem, Solver
from repro_torch.graph.generators import chung_lu_power_law


@pytest.fixture(scope="module")
def graph():
    return chung_lu_power_law(3000, 2.2, 8.0, seed=1, device="cpu")


def _problem(backend):
    return Problem.undirected(eps=0.1, compaction="geometric", backend=backend)


def _spans(prof):
    """The program's spans of a finished profile: ``(name, start, end)``."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro_torch.")]


def _inside(inner, outers):
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


def _answer(res):
    return (res.best_alive.numpy().copy(), res.best_density.numpy().copy(), int(res.best_size),
            res.passes, res.extras["compaction"])


@pytest.mark.parametrize("backend", ["exact", "pallas"])
def test_a_ladder_solve_records_its_spans_under_the_profiler(graph, backend, monkeypatch):
    solver = Solver()
    solver.solve(graph, _problem(backend))  # first-call work out of the trace
    before = hostsync.read.count
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = solver.solve(graph, _problem(backend))
    syncs = hostsync.read.count - before
    spans = _spans(prof)
    count = collections.Counter(name for name, _, _ in spans)
    segments = traced.extras["compaction"]["segments"]
    assert len(segments) >= 2 and traced.passes >= 3

    assert count["repro_torch.solve"] == 1
    assert count["repro_torch.pass"] == traced.passes
    rungs = sorted(n for n in count if n.startswith("repro_torch.rung."))
    assert rungs == sorted(f"repro_torch.rung.{i}" for i in range(len(segments)))
    assert all(count[n] == 1 for n in rungs)
    assert sum(c for n, c in count.items() if n.startswith("repro_torch.sync.")) == syncs
    assert count["repro_torch.sync.pass_test"] >= traced.passes
    assert count["repro_torch.sync.rung_scalars"] == len(segments)
    # Compacted segments filter twice a pass, the last segment once.
    assert traced.passes <= count["repro_torch.degrees"] <= 2 * traced.passes
    assert count["repro_torch.compact"] >= 1
    assert count["repro_torch.tiling"] == (len(segments) if backend == "pallas" else 0)

    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s[0]].append(s)
    rung_spans = [s for n in rungs for s in by_name[n]]
    assert all(_inside(d, by_name["repro_torch.pass"]) for d in by_name["repro_torch.degrees"])
    for name in ("repro_torch.pass", "repro_torch.compact", "repro_torch.tiling"):
        assert all(_inside(s, rung_spans) for s in by_name[name])
    assert all(_inside(s, by_name["repro_torch.solve"]) for s in spans)

    # The same solve with no profiler enters no record_function at all.
    def entered(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    plain = solver.solve(graph, _problem(backend))
    got, want = _answer(plain), _answer(traced)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()
    assert got[2:] == want[2:]


def test_a_span_is_one_shared_no_op_without_a_profiler():
    assert hostsync.span("repro_torch.a") is hostsync.span("repro_torch.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert hostsync.span("repro_torch.a") is not hostsync.span("repro_torch.b")
    assert hostsync.span("repro_torch.a") is hostsync.span("repro_torch.b")


def test_reads_are_counted_and_timed_by_site(monkeypatch):
    # Counted and timed always, newest last; a span of their site while a
    # profiler records.
    monkeypatch.setattr(hostsync.read, "count", 0)
    monkeypatch.setattr(hostsync.read, "waits", collections.deque(maxlen=2))
    assert hostsync.read(torch.tensor(3)) == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert hostsync.read(torch.tensor([1, 2]), site="pass_test") == [1, 2]
        np.testing.assert_array_equal(hostsync.fetch(torch.arange(3), site="rung_scalars"),
                                      [0, 1, 2])
    assert hostsync.read.count == 3
    assert [site for site, _ in hostsync.read.waits] == ["pass_test", "rung_scalars"]
    assert all(0 <= seconds < 1 for _, seconds in hostsync.read.waits)
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == ["repro_torch.sync.pass_test",
                                        "repro_torch.sync.rung_scalars"]
    assert all(end >= start for _, start, end in spans)


def test_the_read_log_keeps_the_last_reads():
    assert hostsync.read.waits.maxlen == hostsync.WAITS
    before = hostsync.read.count
    hostsync.read(torch.tensor(1.0), site="rung_scalars")
    assert hostsync.read.count == before + 1
    assert hostsync.read.waits[-1][0] == "rung_scalars"


def test_each_read_is_a_span_of_its_site():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hostsync.read(torch.tensor(1.0), site="rung_scalars")
        hostsync.fetch(torch.zeros(2))
    names = [n for n, _, _ in _spans(prof)]
    assert names == ["repro_torch.sync.rung_scalars", "repro_torch.sync.other"]
