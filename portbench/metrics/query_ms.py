"""query_ms: the window's wall over the queries it completed (host clock;
the window ends with the last answer on the host)."""


def read(run):
    if not run.walls:
        return None
    return run.window_s / len(run.walls) * 1e3
