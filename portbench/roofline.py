"""H100 constants and the degree count's need, the yardstick of
``degree_roofline_pct``.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 80 GB of
HBM3 at 3.35 TB/s.  A degree count over the alive set S must read, for
each edge of E(S), its two endpoints and its weight (int32, int32,
float32: 12 bytes) and write each alive node's degree (float32: 4 bytes),
once per pass and lane.  That need is a property of the query, taken from
the reference's replay, whatever implements the count.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
EDGE_BYTES = 12  # src, dst, weight
NODE_BYTES = 4  # the degree written


def degree_need_bytes(work: Sequence[List[Tuple[int, int]]]) -> int:
    """Bytes a query's degree counts need: ``work`` is one list of
    ``(|E(S)|, |S|)`` a lane, one pair a pass."""
    return sum(EDGE_BYTES * e + NODE_BYTES * n for lane in work for e, n in lane)


def share_pct(need_bytes: float, seconds: float) -> float:
    """The need's least time over the time taken, in percent."""
    return 100.0 * need_bytes / HBM_BYTES_PER_S / seconds
