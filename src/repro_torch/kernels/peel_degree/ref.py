"""Plain PyTorch version of the tiled-degree kernel, over the ragged layout.

Used on CPU tensors by the wrapper, by the CPU tests, and by
``chip_smoke.py`` as the kernel's comparator on the card.
"""

from __future__ import annotations

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
