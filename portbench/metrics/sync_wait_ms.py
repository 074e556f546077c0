"""sync_wait_ms: the host's time a query, in ms, blocked inside the port's
device-to-host reads over the window (every call site).

The program times each read on the host's clock around the copy and keeps
the last of them (``repro_torch.hostsync.read.waits``); the window's reads
are the last ``run.host_syncs`` of them, since nothing reads through the
port between the window's end and this reader.  Read in the traced run, so
the profiler's own cost per recorded op is in it.  None for a program that
does not time its reads, or when the window made more reads than it
keeps."""

import itertools

from repro_torch import hostsync


def read(run):
    waits = getattr(hostsync.read, "waits", None)
    n = run.host_syncs
    if waits is None or not run.walls or n > len(waits):
        return None
    window = itertools.islice(waits, len(waits) - n, None)
    return sum(seconds for _, seconds in window) / len(run.walls) * 1e3
