"""device_busy_ms: the device's busy time a query, in ms: the union of
every operation on the card inside the traced window over the queries in
it.  A steadier reading of the device's work than the host clock's
query_ms, which also carries the host's pace."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.trace.queries:
        return None
    return run.trace.busy_s / run.trace.queries * 1e3
