"""The rule the rung tiling's counting sort (``csrc/tile_bucket.cu``)
follows for each slot, in plain PyTorch: :func:`slot_fields`, its target,
source and edge index.  The CPU tests hold it to ``graph/partition.py``'s
plain ``bucket_edges_by_sort`` (a stable sort of the slots by tile), which
is also the kernels' plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch


def slot_fields(
    src: torch.Tensor, dst: torch.Tensor, slots: torch.Tensor, directed: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(target, source, edge_index)``, int32, of each slot id in ``slots``:
    for an undirected edge array of E edges, slot ``s < E`` is ``(dst[s],
    src[s], s)`` and slot ``s >= E`` is ``(src[s-E], dst[s-E], s-E)``; for a
    directed one, slot ``s`` is ``(dst[s], src[s], s)``."""
    e = src.shape[0]
    slots = slots.to(torch.int64)
    second = slots >= e
    edge = torch.where(second, slots - e, slots)
    s, d = src.to(torch.int32)[edge], dst.to(torch.int32)[edge]
    if directed:
        return d, s, edge.to(torch.int32)
    return torch.where(second, s, d), torch.where(second, d, s), edge.to(torch.int32)
