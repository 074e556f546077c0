"""Device-to-host reads of the port, counted, and the port's spans.

Every scalar the host loop needs from the device (the peel loop's
continuation test, the ladder's survivor counts, a rung's chunk count)
goes through :func:`read` (an array through :func:`fetch`), so
``read.count`` is the number of host syncs a solve made.  ``chip_smoke.py``
resets and reports it; the benchmark (``portbench/``) reads it over its
window.  ``read.waits`` holds the call site and the host's seconds inside
the copy of each of the last ``WAITS`` reads, newest last: whoever knows
how many reads a stretch made (``read.count``'s delta) sums the last of
them, as the benchmark's ``sync_wait_ms`` does.  Always on: two clock
reads a sync.

:func:`span` marks a layer boundary of the solve path as a
``torch.profiler.record_function`` range, only while a profiler records:
the range then lands in the profiler's own trace, mirrored on the device's
timeline over the work it launched, so spans and kernels share one clock.
Each read is a span ``repro_torch.sync.<site>``, named by its call site
(``site=``): under a profiler, its host range is the time blocked in the
copy.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
WAITS = 1 << 16


def span(name: str):
    """``record_function(name)`` while a profiler records, else one shared
    no-op context: a flag check, where an unrecorded ``record_function``
    costs microseconds a call.  Spans nest; the span open around another
    is its cause."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def _counted(site: str, copy):
    read.count += 1
    with span(f"repro_torch.sync.{site}"):
        t = time.perf_counter()
        try:
            return copy()
        finally:  # one entry a count, a failed copy too
            read.waits.append((site, time.perf_counter() - t))


def read(x: torch.Tensor, *, site: str = "other"):
    """``x.tolist()`` (a Python scalar for a 0-dim tensor): one
    device-to-host sync when ``x`` is on the card."""
    return _counted(site, x.tolist)


read.count = 0
read.waits = collections.deque(maxlen=WAITS)


def fetch(x: torch.Tensor, *, site: str = "other"):
    """``x`` as a numpy array on the host, counted like
    :func:`read` (one device-to-host copy when ``x`` is on the card)."""
    return _counted(site, lambda: x.cpu().numpy())
