"""Tile-partitioned message passing: the paper's MapReduce edge
partitioning as a differentiable GNN training primitive (counterpart of
``repro.models.gnn.dist``).

Edges are co-partitioned with their DESTINATION node tile (the shuffle done
once of graph/partition.py, paper §5.2), so on each rank of the edge axes:

  forward:   all-gather X (the node state, once)
             -> gather/scale the local in-edges -> LOCAL segment sum.  No
             reduction of node-sized partial sums.
  backward:  dX needs the edges grouped by SOURCE -> a second static tiling
             of the same edges; one all-gather of dZ, a local scatter.  dw
             comes from the in-tiling, where dZ is already local, and one
             ``all_reduce`` sums it (each edge lives on one tile).

The collectives go through ``repro_torch.collectives`` (counted), over the
group that ``core.mapreduce.edge_shards`` makes for the mesh's axes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import collectives
from repro_torch.models.common import gather, segment_sum


@dataclasses.dataclass(frozen=True)
class EdgeTiling:
    """Static two-way tiling of a directed edge list over D devices.

    Node tile d owns rows [d*tile_n, (d+1)*tile_n).  ``in_*`` buckets edges
    by dst tile (forward), ``out_*`` by src tile (backward); both padded to
    the max per-tile count (padding slots point at local row 0 with edge id
    -1, so weight 0).
    """

    in_src: np.ndarray  # int32[D, E_in]  global src ids
    in_dst_local: np.ndarray  # int32[D, E_in]  dst - tile_start
    in_eid: np.ndarray  # int32[D, E_in]  original edge index (-1 pad)
    out_dst: np.ndarray  # int32[D, E_out] global dst ids
    out_src_local: np.ndarray  # int32[D, E_out]
    out_eid: np.ndarray  # int32[D, E_out]
    tile_n: int
    n_nodes_padded: int


def build_edge_tiling(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, n_devices: int,
    pad_multiple: int = 8,
) -> EdgeTiling:
    n_pad = ((n_nodes + n_devices - 1) // n_devices) * n_devices
    tile_n = n_pad // n_devices

    def bucket(key: np.ndarray, other: np.ndarray):
        tile = key // tile_n
        order = np.argsort(tile, kind="stable")
        key_s, other_s, eid_s = key[order], other[order], order
        counts = np.bincount(tile, minlength=n_devices)
        width = int(counts.max(initial=0))
        width = max(((width + pad_multiple - 1) // pad_multiple) * pad_multiple,
                    pad_multiple)
        loc = np.zeros((n_devices, width), np.int32)
        oth = np.zeros((n_devices, width), np.int32)
        eid = np.full((n_devices, width), -1, np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for d in range(n_devices):
            s, c = starts[d], counts[d]
            loc[d, :c] = (key_s[s : s + c] - d * tile_n).astype(np.int32)
            oth[d, :c] = other_s[s : s + c].astype(np.int32)
            eid[d, :c] = eid_s[s : s + c].astype(np.int32)
        return loc, oth, eid

    in_dst_local, in_src, in_eid = bucket(np.asarray(dst, np.int64),
                                          np.asarray(src, np.int64))
    out_src_local, out_dst, out_eid = bucket(np.asarray(src, np.int64),
                                             np.asarray(dst, np.int64))
    return EdgeTiling(
        in_src=in_src, in_dst_local=in_dst_local, in_eid=in_eid,
        out_dst=out_dst, out_src_local=out_src_local, out_eid=out_eid,
        tile_n=tile_n, n_nodes_padded=n_pad,
    )


def _w_slot(w_edge: torch.Tensor, eid: torch.Tensor) -> torch.Tensor:
    """Each slot's edge weight, 0 on padding slots."""
    w = w_edge.index_select(0, eid.clamp_min(0))
    return torch.where(eid >= 0, w, torch.zeros_like(w))


def _scale(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rows * w.reshape((-1,) + (1,) * (rows.dim() - 1)).to(rows.dtype)


def make_tiled_neighbor_sum(tiling: EdgeTiling, mesh, axes: Sequence[str]):
    """Returns ``f(x_local, w_edge) -> z_local`` with Z[n] = sum over the
    edges e with dst_e = n of w_e X[src_e].

    x_local: this rank's tile of X, ``[tile_n, ...]`` (the rows of block
    ``edge_shards(mesh, axes).index``); w_edge: float[E], the weight of every
    ORIGINAL edge, the same on every rank.  z_local is this rank's tile of
    Z.  Gradients flow to both x_local and w_edge (``w_edge.grad`` is the
    whole dw, the same on every rank).
    """
    from repro_torch.core.mapreduce import edge_shards

    shards = edge_shards(mesh, axes)
    if shards.count != tiling.in_src.shape[0]:
        raise ValueError(f"the tiling has {tiling.in_src.shape[0]} tiles, the mesh's axes "
                         f"{tuple(axes)} {shards.count} shards")
    dev = torch.device(mesh.device_type)
    row = shards.index

    def take(a):
        return torch.from_numpy(np.ascontiguousarray(a[row])).to(dev).long()

    in_src, in_dst, in_eid = take(tiling.in_src), take(tiling.in_dst_local), take(tiling.in_eid)
    out_dst, out_src = take(tiling.out_dst), take(tiling.out_src_local)
    out_eid = take(tiling.out_eid)
    tile_n = tiling.tile_n

    def all_gather(x):  # the tiles in block order, [count * tile_n, ...]
        out = collectives.all_gather(x, shards.group)
        if shards.perm is None:
            return out
        blocks = out.view((shards.count, tile_n) + tuple(x.shape[1:]))
        return blocks[shards.perm.to(out.device)].reshape(out.shape)

    class _TiledNeighborSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x_local, w_edge):
            xg = all_gather(x_local.contiguous())
            ctx.save_for_backward(xg, w_edge)
            msgs = _scale(xg.index_select(0, in_src), _w_slot(w_edge, in_eid))
            return segment_sum(msgs, in_dst, tile_n)

        @staticmethod
        def backward(ctx, dz_local):
            xg, w_edge = ctx.saved_tensors
            dz_local = dz_local.contiguous()
            dzg = all_gather(dz_local)
            msgs = _scale(dzg.index_select(0, out_dst), _w_slot(w_edge, out_eid))
            dx = segment_sum(msgs, out_src, tile_n)
            # dw_e = <X[src_e], dZ[dst_e]>; dst is LOCAL in the in-tiling.
            contrib = (xg.index_select(0, in_src) * dz_local.index_select(0, in_dst))
            contrib = contrib.reshape(in_src.shape[0], -1).sum(-1).float()
            contrib = torch.where(in_eid >= 0, contrib, torch.zeros_like(contrib))
            dw = torch.zeros(w_edge.shape[0], dtype=torch.float32, device=w_edge.device)
            dw.index_add_(0, in_eid.clamp_min(0), contrib)
            collectives.all_reduce(dw, shards.group)  # each edge lives on one tile
            return dx.to(xg.dtype), dw.to(w_edge.dtype)

    return _TiledNeighborSum.apply


def neighbor_sum_reference(x, w_edge, src, dst, n_nodes):
    """The untiled oracle: gather -> scale -> segment sum."""
    msgs = _scale(gather(x, src), w_edge)
    return segment_sum(msgs, dst, n_nodes)
