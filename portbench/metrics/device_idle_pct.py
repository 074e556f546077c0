"""device_idle_pct: the share of the traced window with no kernel, copy or
set on the card (the union of the device's intervals; busy time and
window from the same trace)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.idle_share
