"""Wrapper of the rung tiling's counting sort (``csrc/tile_bucket.cu``):
the ragged tile layout of an edge array's slots, on the card, in the
permutation of ``graph/partition.py::bucket_edges_by_tile``'s stable sort."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
import torch

from repro_torch.graph.partition import TiledEdges, bucket_edges_by_sort, chunk_slots_for
from repro_torch.kernels import load_library, use_kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "tile_bucket.cu"
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library():
    """The built library's C entry points, with their argument types
    declared."""
    lib = load_library(SOURCE)
    lib.tile_bucket_plan.restype = _INT
    lib.tile_bucket_plan.argtypes = [_INT, ctypes.POINTER(_INT)]
    lib.tile_bucket_count.restype = _INT
    lib.tile_bucket_count.argtypes = [_PTR, _PTR, _PTR, _LL, _INT, _INT, _INT, _INT, _PTR, _PTR,
                                      _PTR]
    lib.tile_bucket_scatter.restype = _INT
    lib.tile_bucket_scatter.argtypes = [_PTR] * 5 + [_LL, _INT, _INT, _INT, _INT, _INT] + [_PTR] * 5
    lib.tile_bucket_chunks.restype = _INT
    lib.tile_bucket_chunks.argtypes = [_PTR, _INT, _LL, _LL, _PTR, _PTR, _PTR, _PTR]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _check(src: torch.Tensor, dst: torch.Tensor, n_nodes: int, tile_size: int) -> None:
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous 1-D int32, got {t.dtype}{tuple(t.shape)}"
            )
    if src.shape != dst.shape or src.device != dst.device:
        raise ValueError(
            f"src {tuple(src.shape)} on {src.device} and dst {tuple(dst.shape)} on "
            f"{dst.device} must match"
        )
    if src.shape[0] >= 2**31:
        raise ValueError(f"{src.shape[0]} edges: edge_index is int32")
    if tile_size < 1 or n_nodes < 0 or -(-n_nodes // tile_size) >= 2**31 - 1:
        raise ValueError(f"tile_size={tile_size}, n_nodes={n_nodes}: no tiling")


def bucket_slots(
    src: torch.Tensor, dst: torch.Tensor, n_nodes: int, tile_size: int, directed: bool
) -> TiledEdges:
    """The edge array's slots grouped by node tile, in slot order within
    each tile, with K1's chunk plan: the plain ``bucket_edges_by_sort``'s
    tiling, bitwise.  On a CUDA tensor this runs the kernels' digit passes
    (a count, a ``cumsum`` and a scatter each) and the chunk plan, reads
    nothing back to the host, and counts the tiling in
    ``bucket_slots.launches``; on a CPU tensor it runs the plain version,
    uncounted.  Raises on any input the kernels do not take."""
    _check(src, dst, n_nodes, tile_size)
    if not use_kernel(src):
        return bucket_edges_by_sort(src, dst, n_nodes, tile_size, directed)
    e = src.shape[0]
    halves = 1 if directed else 2
    n_slots = halves * e
    n_tiles = -(-n_nodes // tile_size)
    lib = _library()
    dev = src.device
    with torch.cuda.device(dev):  # the C entry points use the current device
        plan = (_INT * 3)()
        _raise_on(lib.tile_bucket_plan(n_tiles, plan), "tile_bucket_plan")
        passes, cta_slots, radix = plan
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_ct = -(-n_slots // cta_slots)
        # (target or target_local, source, edge_index) as the rows of one buffer.
        out = torch.empty((3, n_slots), dtype=torch.int32, device=dev)
        other = torch.empty((3, n_slots), dtype=torch.int32, device=dev) if passes > 1 else None
        hist = torch.empty(n_tiles, dtype=torch.int64, device=dev)  # zeroed by the first count
        shape = (e, halves, tile_size, n_tiles)
        prev = None
        for p in range(passes):
            # The passes alternate between the two buffers and end in `out`.
            into = out if (passes - 1 - p) % 2 == 0 else other
            ins = [0, 0, 0] if prev is None else [t.data_ptr() for t in prev]
            scan = torch.empty(radix * n_ct, dtype=torch.int64, device=dev)
            _raise_on(lib.tile_bucket_count(
                src.data_ptr(), dst.data_ptr(), ins[0], *shape, p, scan.data_ptr(),
                hist.data_ptr() if p == 0 else 0, stream), "tile_bucket_count")
            scan.cumsum_(0)  # the counts' inclusive scan, in place
            _raise_on(lib.tile_bucket_scatter(
                src.data_ptr(), dst.data_ptr(), *ins, *shape, p, int(p == passes - 1),
                scan.data_ptr(), *(t.data_ptr() for t in into), stream), "tile_bucket_scatter")
            prev = into
        chunk_slots = chunk_slots_for(n_slots)
        bound = n_tiles + -(-n_slots // chunk_slots)
        tile_ptr = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
        chunk_tile = torch.empty(bound, dtype=torch.int32, device=dev)
        chunk_start = torch.empty(bound, dtype=torch.int64, device=dev)
        _raise_on(lib.tile_bucket_chunks(
            hist.data_ptr(), n_tiles, chunk_slots, bound, tile_ptr.data_ptr(),
            chunk_tile.data_ptr(), chunk_start.data_ptr(), stream), "tile_bucket_chunks")
    bucket_slots.launches += 1
    target_local, source, edge_index = out.unbind(0)
    return TiledEdges(tile_ptr=tile_ptr, target_local=target_local, source=source,
                      edge_index=edge_index, chunk_tile=chunk_tile, chunk_start=chunk_start,
                      tile_size=int(tile_size), n_nodes=int(n_nodes), n_edges=int(e),
                      chunk_slots=chunk_slots)


bucket_slots.launches = 0
