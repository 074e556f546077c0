"""Endpoint bucketing by node tile for the tiled-degree kernel.

The reference (``repro.graph.partition.bucket_edges_by_tile``) lays the
buckets out as a dense ``[n_tiles, max_epT]`` rectangle: every tile is
padded to the busiest tile's slot count.  On power-law graphs the hubs sit
in tile 0, so the rectangle is mostly padding (199x the real slots at the
FLICKR scale of 976k nodes and 7.07M edges).  The port keeps the same
buckets in a RAGGED layout: the dense rows with the padding dropped, cut
apart by ``tile_ptr``.  :meth:`TiledEdges.to_dense` rebuilds the
reference's rectangle exactly, for the parity tests.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import constants

# The tiled-degree kernel's chunk plan.  A tile of at most ``chunk_slots``
# slots is one CTA; a larger one (a hub tile holds 21% of all slots at
# FLICKR scale) is cut into ``chunk_slots`` pieces spread over many SMs.
# ``chunk_slots`` depends on the slot count alone: the power of two that cuts
# the slots into about CHUNK_TARGET pieces (about one wave of resident CTAs
# on an H100), at least CHUNK_FLOOR (one 128-slot step for each of a CTA's
# 8 warps).
CHUNK_TARGET = 1024
CHUNK_FLOOR = constants.K1_CHUNK_FLOOR


def pow2_bucket(x: int, floor: int = 1) -> int:
    """Smallest power of two >= x, floored — the bucket-size rule of the
    compaction ladder, shared so every consumer lands on the same shapes."""
    return max(floor, 1 << max(int(x) - 1, 0).bit_length())


def chunk_slots_for(n_slots: int) -> int:
    """Slots per kernel chunk for a tiling of ``n_slots`` slots: 16,384 at
    FLICKR's first rung (14.1M slots), CHUNK_FLOOR below 1M slots."""
    return pow2_bucket(-(-int(n_slots) // CHUNK_TARGET), CHUNK_FLOOR)


def ladder_schedule(m0: int, floor: int = 1, stride: int = 2) -> Tuple[int, ...]:
    """The static geometric bucket schedule of the single-program ladder:
    descending capacities ``pow2(m0), pow2(m0)/stride, ..., >= pow2(floor)``."""
    if stride < 2:
        raise ValueError(f"stride={stride} must be >= 2")
    top = pow2_bucket(max(int(m0), 1))
    fl = min(pow2_bucket(max(int(floor), 1)), top)
    sizes = [top]
    while sizes[-1] // stride >= fl:
        sizes.append(sizes[-1] // stride)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class TiledEdges:
    """Ragged tiling of (duplicated) edge endpoints, on one device.

    For an undirected graph each edge (u, v) gives two slots: one under
    target u and one under target v.  Slots are sorted by target tile,
    stably, so within a tile they keep the reference's order.

    Attributes:
      tile_ptr:     int64[n_tiles+1] slot range of each tile.
      target_local: int32[S] endpoint id within its tile.
      source:       int32[S] the other endpoint's global id.
      edge_index:   int32[S] index into the edge array the tiling was built
                    from (where the pass's alive weight is read); a slot
                    with a negative index adds nothing.
      chunk_tile:   int32[C] tile of each kernel chunk; -1 past the real
                    chunks (C is the host-known bound ``n_tiles +
                    ceil(S / chunk_slots)``, so no count is read back).
      chunk_start:  int64[C] first slot of each kernel chunk; a chunk ends
                    ``chunk_slots`` later or at its tile's end.
      tile_size:    nodes per tile (node i lives in tile i // tile_size).
      n_nodes:      node count.
      n_edges:      length of the edge array ``edge_index`` addresses.
      chunk_slots:  the chunk size the plan was made with.
    """

    tile_ptr: torch.Tensor
    target_local: torch.Tensor
    source: torch.Tensor
    edge_index: torch.Tensor
    chunk_tile: torch.Tensor
    chunk_start: torch.Tensor
    tile_size: int
    n_nodes: int
    n_edges: int
    chunk_slots: int

    @classmethod
    def from_ragged(
        cls,
        tile_ptr: torch.Tensor,
        target_local: torch.Tensor,
        source: torch.Tensor,
        edge_index: torch.Tensor,
        *,
        tile_size: int,
        n_nodes: int,
        n_edges: int,
    ) -> "TiledEdges":
        """Builds the kernel's chunk plan for a ragged layout, on the
        layout's device, without reading anything back to the host: a tile
        of at most ``chunk_slots_for(S)`` slots is one chunk (an empty tile
        too), a larger one is cut into pieces of that size."""
        tile_ptr = tile_ptr.to(torch.int64)
        n_tiles, n_slots = tile_ptr.shape[0] - 1, target_local.shape[0]
        chunk_slots = chunk_slots_for(n_slots)
        pieces = ((tile_ptr[1:] - tile_ptr[:-1] + chunk_slots - 1) // chunk_slots).clamp(min=1)
        piece_end = torch.cumsum(pieces, 0)
        bound = n_tiles + -(-n_slots // chunk_slots)
        idx = torch.arange(bound, device=tile_ptr.device)
        tile = torch.searchsorted(piece_end, idx, right=True)
        real = tile < n_tiles
        tile = tile.clamp(max=max(n_tiles - 1, 0))
        rank = idx - (piece_end - pieces)[tile]
        chunk_start = torch.where(real, tile_ptr[tile] + rank * chunk_slots, 0)
        return cls(
            tile_ptr=tile_ptr.contiguous(),
            target_local=target_local.to(torch.int32).contiguous(),
            source=source.to(torch.int32).contiguous(),
            edge_index=edge_index.to(torch.int32).contiguous(),
            chunk_tile=torch.where(real, tile, -1).to(torch.int32).contiguous(),
            chunk_start=chunk_start.to(torch.int64).contiguous(),
            tile_size=int(tile_size),
            n_nodes=int(n_nodes),
            n_edges=int(n_edges),
            chunk_slots=chunk_slots,
        )

    @property
    def n_tiles(self) -> int:
        return self.tile_ptr.shape[0] - 1

    @property
    def n_slots(self) -> int:
        return self.target_local.shape[0]

    def tile_of_slot(self) -> torch.Tensor:
        """int64[S] the tile each slot belongs to."""
        counts = self.tile_ptr[1:] - self.tile_ptr[:-1]
        tiles = torch.arange(self.n_tiles, device=self.tile_ptr.device)
        return torch.repeat_interleave(tiles, counts, output_size=self.n_slots)

    def to_dense(
        self, block: int = 256, pow2_pad: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The reference's padded ``(target_local, source, edge_index)``
        rectangles, each ``int32[n_tiles, max_epT]``: ``target_local`` and
        ``source`` padded with 0, ``edge_index`` with -1.  ``max_epT`` is the
        busiest tile's count rounded up to ``block`` (at least ``block``),
        then to a power of two under ``pow2_pad``.  For tests only: the main
        path never builds this layout."""
        counts = self.tile_ptr[1:] - self.tile_ptr[:-1]
        max_epT = int(counts.max()) if self.n_tiles else 0
        max_epT = max(((max_epT + block - 1) // block) * block, block)
        if pow2_pad:
            max_epT = pow2_bucket(max_epT)
        dev = self.tile_ptr.device
        shape = (self.n_tiles, max_epT)
        tile = self.tile_of_slot()
        col = torch.arange(self.n_slots, device=dev) - self.tile_ptr[tile]
        tl = torch.zeros(shape, dtype=torch.int32, device=dev)
        sg = torch.zeros(shape, dtype=torch.int32, device=dev)
        ei = torch.full(shape, -1, dtype=torch.int32, device=dev)
        tl[tile, col] = self.target_local
        sg[tile, col] = self.source
        ei[tile, col] = self.edge_index
        return tl, sg, ei


def bucket_edges_by_tile(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    tile_size: int = 1024,
    directed: bool = False,
) -> TiledEdges:
    """One-time 'shuffle': group endpoint slots by node tile, on the device
    of ``src``, without reading anything back to the host; within a tile
    the slots keep the reference's order.  ``kernels/tile_bucket``'s
    wrapper builds the layout: on a CUDA tensor a hand-written stable
    counting sort, on a CPU tensor its plain version,
    :func:`bucket_edges_by_sort`.  The two are equal bitwise.

    For directed graphs only dst-targeted slots are produced (out-degree is
    bucketed separately by swapping arguments).
    """
    # int32 throughout (node and edge ids fit): halves the sort's traffic
    # and the transient memory of a rung's re-bucketing.
    src = src.to(torch.int32)
    dst = dst.to(torch.int32)
    from repro_torch.kernels.tile_bucket.ops import bucket_slots  # it imports this module

    return bucket_slots(src.contiguous(), dst.contiguous(), n_nodes, tile_size, directed)


def bucket_edges_by_sort(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    tile_size: int = 1024,
    directed: bool = False,
) -> TiledEdges:
    """The plain version of :func:`bucket_edges_by_tile`, on any device.  A
    stable sort of the slots' tile ids keeps the reference's in-tile order
    (int16 keys when the tile ids fit: a stable sort gives the same
    permutation at any key width, and the radix sort makes fewer passes);
    ``searchsorted`` over the sorted ids gives the tile boundaries."""
    src = src.to(torch.int32)
    dst = dst.to(torch.int32)
    e = src.shape[0]
    eidx = torch.arange(e, dtype=torch.int32, device=src.device)
    if directed:
        targets, sources = dst, src
    else:
        targets = torch.cat([dst, src])
        sources = torch.cat([src, dst])
        eidx = torch.cat([eidx, eidx])
    n_tiles = (n_nodes + tile_size - 1) // tile_size
    key_dtype = torch.int16 if n_tiles < 2**15 else torch.int32
    tile_sorted, order = torch.sort((targets // tile_size).to(key_dtype), stable=True)
    bounds = torch.arange(n_tiles + 1, dtype=key_dtype, device=src.device)
    tile_ptr = torch.searchsorted(tile_sorted, bounds)
    return TiledEdges.from_ragged(
        tile_ptr,
        targets[order] - tile_sorted.to(torch.int32) * tile_size,
        sources[order],
        eidx[order],
        tile_size=tile_size,
        n_nodes=n_nodes,
        n_edges=e,
    )
