"""Plain PyTorch version of the tiled-degree kernel, over the ragged layout.

Used on CPU tensors by the wrapper, by the CPU tests, and by
``chip_smoke.py`` as the kernel's comparator on the card.
:func:`fold_runs` is the plain version of the rule by which the kernel
folds runs of equal targets before it adds them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph.partition import TiledEdges


def tiled_degrees_ref(tiling: TiledEdges, w_alive: torch.Tensor) -> torch.Tensor:
    """[n_tiles * tile_size] in ``w_alive``'s dtype: ``deg[tile*tile_size +
    tl[s]] += w_alive[edge_index[s]]`` over every slot; a slot with a
    negative ``edge_index`` or a ``target_local`` outside the tile adds
    nothing.  (The kernel takes float32; a float64 ``w_alive`` gives the
    comparator for float weights, whose f32 sums depend on the order.)"""
    ts = tiling.tile_size
    tl = tiling.target_local.to(torch.int64)
    ei = tiling.edge_index.to(torch.int64)
    live = (ei >= 0) & (tl >= 0) & (tl < ts)
    w = torch.where(live, w_alive[ei.clamp(min=0)], 0.0)
    pos = tiling.tile_of_slot() * ts + torch.where(live, tl, 0)
    deg = torch.zeros(tiling.n_tiles * ts, dtype=w_alive.dtype, device=w_alive.device)
    return deg.index_add_(0, pos, w)


def degrees_from_tiled(deg_tiles: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[n_tiles * tile_size] -> [n_nodes] (drops the last tile's padding)."""
    return deg_tiles.reshape(-1)[:n_nodes]


# Slots a warp of K1 takes in one step: 4 a lane, in groups of 4 slots that
# start at a multiple of 4.
STEP_GROUPS = 32


def fold_runs(tiling: TiledEdges, w_alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(bin, Σw)`` stream K1 adds into its shared histograms: each
    chunk of the plan (``chunk_slots`` slots of one tile, or the whole
    tile) is cut into steps of ``STEP_GROUPS`` groups of 4 slots, counted
    from the group that holds the chunk's first slot; each maximal run of
    equal targets inside a step folds into one ``(tile*tile_size + target,
    sum of its weights)``, and a run whose sum is 0, or of slots that add
    nothing, is dropped.  ``bin`` is int64, the sums are taken in float64
    and cast to ``w_alive``'s dtype.  ``index_add_`` of this stream gives
    ``tiled_degrees_ref``, bitwise where every partial sum is an integer
    ≤ 2^24, and ``len(bin)`` is the kernel's add count."""
    ts, cs = tiling.tile_size, tiling.chunk_slots
    tl = tiling.target_local.to(torch.int64)
    ei = tiling.edge_index.to(torch.int64)
    tile = tiling.tile_of_slot()
    slot = torch.arange(tiling.n_slots, device=tl.device)
    first = tiling.tile_ptr[tile]
    start = first + (slot - first) // cs * cs
    step = ((slot >> 2) - (start >> 2)) // STEP_GROUPS
    live = (ei >= 0) & (tl >= 0) & (tl < ts)
    key = torch.where(live, tl, -1)
    w = torch.where(live, w_alive[ei.clamp(min=0)], 0.0).to(torch.float64)
    head = torch.ones_like(live)
    head[1:] = (key[1:] != key[:-1]) | (start[1:] != start[:-1]) | (step[1:] != step[:-1])
    run = torch.cumsum(head, 0) - 1
    sums = torch.zeros(int(head.sum()), dtype=torch.float64, device=w.device)
    sums.index_add_(0, run, w)
    keep = (key[head] >= 0) & (sums != 0)
    return (tile[head] * ts + key[head])[keep], sums[keep].to(w_alive.dtype)
