"""Wrapper of the tiled-degree kernel: degrees of the current alive
subgraph from a rung's ragged tiling (counterpart of
``repro.kernels.peel_degree.ops``)."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.graph.edgelist import EdgeList
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels import MAX_SMEM_BYTES, load_library, use_kernel
from repro_torch.kernels.peel_degree.ref import degrees_from_tiled, tiled_degrees_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "peel_degree.cu"


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = load_library(SOURCE).peel_degree_tiled
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch(tiling: TiledEdges, w_alive: torch.Tensor, deg: torch.Tensor) -> None:
    # The C entry point launches on the calling thread's current device.
    with torch.cuda.device(w_alive.device):
        err = _kernel()(
            tiling.tile_ptr.data_ptr(), tiling.chunk_tile.data_ptr(),
            tiling.chunk_start.data_ptr(), tiling.chunk_tile.shape[0],
            tiling.target_local.data_ptr(), tiling.edge_index.data_ptr(),
            w_alive.data_ptr(), deg.data_ptr(), tiling.tile_size, tiling.chunk_slots,
            torch.cuda.current_stream(w_alive.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"peel_degree_tiled launch failed: cudaError {err}")
    tiled_degrees.launches += 1


def _check(tiling: TiledEdges, w_alive: torch.Tensor, n_nodes: int) -> None:
    dev = w_alive.device
    want = {
        "tile_ptr": torch.int64, "target_local": torch.int32,
        "edge_index": torch.int32, "chunk_tile": torch.int32,
        "chunk_start": torch.int64,
    }
    for name, dtype in want.items():
        t = getattr(tiling, name)
        if t.device != dev or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"tiling.{name}: need contiguous 1-D {dtype} on {dev}, got "
                f"{t.dtype}{tuple(t.shape)} on {t.device}"
            )
    if w_alive.dtype != torch.float32 or w_alive.dim() != 1 or not w_alive.is_contiguous():
        raise ValueError(
            f"w_alive: need contiguous 1-D float32, got {w_alive.dtype}{tuple(w_alive.shape)}"
        )
    if w_alive.shape[0] != tiling.n_edges:
        raise ValueError(
            f"w_alive has {w_alive.shape[0]} entries; the tiling addresses {tiling.n_edges}"
        )
    if n_nodes > tiling.n_tiles * tiling.tile_size:
        raise ValueError(f"n_nodes={n_nodes} exceeds the tiling's node range")
    if not 0 < tiling.tile_size * 4 <= MAX_SMEM_BYTES:
        raise ValueError(
            f"tile_size={tiling.tile_size}: the kernel's shared-memory "
            f"histogram holds at most {MAX_SMEM_BYTES // 4} floats"
        )


def tiled_degrees(tiling: TiledEdges, w_alive: torch.Tensor, *, n_nodes: int) -> torch.Tensor:
    """float32[n_nodes] degrees of the alive subgraph: every slot adds
    ``w_alive[edge_index]`` to its target.  On a CUDA tensor this launches
    the hand-written kernel (and counts it in ``tiled_degrees.launches``);
    on a CPU tensor it runs the plain version.  Raises on any input the
    kernel does not take."""
    _check(tiling, w_alive, n_nodes)
    if not use_kernel(w_alive):
        return degrees_from_tiled(tiled_degrees_ref(tiling, w_alive), n_nodes)
    deg = torch.zeros(tiling.n_tiles * tiling.tile_size, dtype=torch.float32,
                      device=w_alive.device)
    if tiling.chunk_tile.shape[0] > 0:
        _launch(tiling, w_alive, deg)
    return degrees_from_tiled(deg, n_nodes)


tiled_degrees.launches = 0


def tiling_for_edges(edges: EdgeList, tile_size: int = 1024) -> TiledEdges:
    """Buckets all edge slots, padding included: ``edge_index`` addresses
    the edge array because the per-pass ``w_alive`` is indexed over it, and
    padded slots carry weight 0.  The ragged layout has no block or pow2
    padding, so the reference's ``block``/``pow2_pad`` have no counterpart."""
    return bucket_edges_by_tile(
        edges.src, edges.dst, edges.n_nodes, tile_size=tile_size, directed=False,
    )


def degree_backend_from_tiling(tiling: TiledEdges):
    """Engine ``DegreeBackend`` around :func:`tiled_degrees` for one fixed
    graph (undirected policies)."""
    from repro_torch.core.engine import FnBackend

    def fn(edges: EdgeList, w_alive: torch.Tensor) -> torch.Tensor:
        return tiled_degrees(tiling, w_alive, n_nodes=tiling.n_nodes)

    return FnBackend(fn)
