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

from repro_torch import hostsync

# Slots per CTA of the tiled-degree kernel.  A tile's slot range is cut into
# chunks of this size so a hub tile (21% of all slots at FLICKR scale) is
# spread over many SMs instead of serializing on one.
CHUNK_SLOTS = 4096


def pow2_bucket(x: int, floor: int = 1) -> int:
    """Smallest power of two >= x, floored — the bucket-size rule of the
    compaction ladder, shared so every consumer lands on the same shapes."""
    return max(floor, 1 << max(int(x) - 1, 0).bit_length())


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
      chunk_tile:   int32[C] tile of each kernel chunk.
      chunk_start:  int64[C] first slot of each kernel chunk; a chunk ends
                    ``CHUNK_SLOTS`` later or at its tile's end.
      tile_size:    nodes per tile (node i lives in tile i // tile_size).
      n_nodes:      node count.
      n_edges:      length of the edge array ``edge_index`` addresses.
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
        """Builds the kernel's chunk list for a ragged layout."""
        counts = tile_ptr[1:] - tile_ptr[:-1]
        n_chunks = (counts + CHUNK_SLOTS - 1) // CHUNK_SLOTS
        chunk_ptr = torch.cumsum(n_chunks, 0)
        total = hostsync.read(chunk_ptr[-1]) if len(chunk_ptr) else 0
        tiles = torch.arange(len(counts), device=tile_ptr.device)
        chunk_tile = torch.repeat_interleave(tiles, n_chunks, output_size=total)
        rank = torch.arange(total, device=tile_ptr.device) - (chunk_ptr - n_chunks)[chunk_tile]
        chunk_start = tile_ptr[chunk_tile] + rank * CHUNK_SLOTS
        return cls(
            tile_ptr=tile_ptr.to(torch.int64).contiguous(),
            target_local=target_local.to(torch.int32).contiguous(),
            source=source.to(torch.int32).contiguous(),
            edge_index=edge_index.to(torch.int32).contiguous(),
            chunk_tile=chunk_tile.to(torch.int32).contiguous(),
            chunk_start=chunk_start.to(torch.int64).contiguous(),
            tile_size=int(tile_size),
            n_nodes=int(n_nodes),
            n_edges=int(n_edges),
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
    of ``src``.  A stable sort of the slots' tile ids keeps the reference's
    in-tile order; a bincount gives the tile boundaries.

    For directed graphs only dst-targeted slots are produced (out-degree is
    bucketed separately by swapping arguments).
    """
    # int32 throughout (node and edge ids fit): halves the sort's traffic
    # and the transient memory of a rung's re-bucketing.
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
    tile_sorted, order = torch.sort(targets // tile_size, stable=True)
    counts = torch.bincount(tile_sorted, minlength=n_tiles)
    tile_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return TiledEdges.from_ragged(
        tile_ptr,
        targets[order] - tile_sorted * tile_size,
        sources[order],
        eidx[order],
        tile_size=tile_size,
        n_nodes=n_nodes,
        n_edges=e,
    )
