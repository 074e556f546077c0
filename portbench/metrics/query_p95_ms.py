"""query_p95_ms: the 95th percentile of every query's wall in the window
(host clock), by nearest rank: the ceil(0.95 n)-th smallest."""

import math


def read(run):
    if not run.walls:
        return None
    walls = sorted(run.walls)
    return walls[math.ceil(0.95 * len(walls)) - 1] * 1e3
