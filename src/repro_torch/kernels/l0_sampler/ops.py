"""ℓ0-sampling sketch over the undirected edge universe (MTVV, arXiv
1506.04417), counterpart of ``repro.kernels.l0_sampler.ops``.

The sketch is one int32 tensor ``[L, d, C, 4]``: edge ``(u, v)`` (canonical
``u < v``) lands at level ``min(clz(h(u, v)), L-1)`` and, in each of the d
tables, in one of C cells, whose four fields ``(count, sum_u, sum_v,
fingerprint)`` take ``(s, s·u, s·v, s·fp)`` mod 2^32 for the update's sign
s.  Every field is linear in the update stream, so sketches merge by
addition and an insert then a delete leaves zeros.

:func:`l0_delta` and :func:`l0_update` dispatch on the device: the
hand-written kernel K3 (``csrc/l0_sampler.cu``) on a CUDA tensor, the plain
version (``ref.py``) on a CPU tensor.  ``l0_delta.launches`` counts K3's
launches; it is the port's counterpart of the reference turnstile sketch's
``trace_count`` (nothing compiles here).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import hashing, load_library, use_kernel

__all__ = [
    "L0Params",
    "add_wrapped",
    "canonicalize_edges",
    "edge_cells",
    "edge_fingerprint",
    "edge_level",
    "flat_cells",
    "l0_delta",
    "l0_sketch_shape",
    "l0_update",
    "level_from_hash",
    "make_l0_params",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "l0_sampler.cu"
# The cell-hash parameters ride in the kernel's argument block.
MAX_TABLES = 16


@dataclasses.dataclass(frozen=True, eq=False)
class L0Params:
    """Hash parameters of an L-level, d-table, C-cell ℓ0 sketch, as host
    uint32 arrays.  Pair hashes take ``(a_x, a_y, c)`` with odd
    multipliers; the cell hash has one triple per table."""

    a_lvl: np.ndarray  # uint32[2]
    c_lvl: np.ndarray  # uint32[1]
    a_fp: np.ndarray  # uint32[2]
    c_fp: np.ndarray  # uint32[1]
    a_cell: np.ndarray  # uint32[d, 2]
    c_cell: np.ndarray  # uint32[d]
    n_levels: int
    n_cells: int

    @property
    def n_tables(self) -> int:
        return int(self.a_cell.shape[0])


def make_l0_params(
    n_levels: int = 32, n_cells: int = 1 << 14, n_tables: int = 3, seed: int = 0
) -> L0Params:
    """The reference's draw from ``numpy.random.default_rng(seed)``, in its
    order, so both packages hash with equal parameters."""
    rng = np.random.default_rng(seed)

    def odd(*s):
        return (rng.integers(0, 1 << 31, size=s, dtype=np.int64) * 2 + 1).astype(np.uint32)

    def any32(*s):
        return rng.integers(0, 1 << 32, size=s, dtype=np.int64).astype(np.uint32)

    return L0Params(
        a_lvl=odd(2), c_lvl=any32(1), a_fp=odd(2), c_fp=any32(1),
        a_cell=odd(n_tables, 2), c_cell=any32(n_tables),
        n_levels=int(n_levels), n_cells=int(n_cells),
    )


def l0_sketch_shape(p: L0Params) -> tuple:
    return (p.n_levels, p.n_tables, p.n_cells, 4)


def canonicalize_edges(src: torch.Tensor, dst: torch.Tensor, sgn: torch.Tensor):
    """``(u=min, v=max, sgn)`` with self-loops sign-zeroed; padding rows
    arrive with ``sgn == 0`` and stay so."""
    u = torch.minimum(src, dst)
    v = torch.maximum(src, dst)
    sgn = torch.where(u == v, 0, sgn.to(torch.int32)).to(torch.int32)
    return u, v, sgn


level_from_hash = hashing.level_from_hash


def _pair(a_x: int, a_y: int, c: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return hashing.mix32_pair(int(a_x), int(a_y), int(c), hashing.as_u32(u), hashing.as_u32(v))


def edge_level(p: L0Params, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int32[E] level of each canonical edge."""
    return level_from_hash(_pair(p.a_lvl[0], p.a_lvl[1], p.c_lvl[0], u, v), p.n_levels)


def edge_cells(p: L0Params, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int32[d, E] cell of each canonical edge in every table."""
    return torch.stack([
        hashing.bucket32(_pair(p.a_cell[j, 0], p.a_cell[j, 1], p.c_cell[j], u, v), p.n_cells)
        for j in range(p.n_tables)
    ])


def flat_cells(p: L0Params, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int64[d, E] index of each canonical edge's cell in every table, in
    the sketch viewed as ``[L*d*C, 4]``: ``(level·d + j)·C + cell_j``."""
    rows = torch.arange(p.n_tables, dtype=torch.int64, device=u.device)[:, None]
    lvl = edge_level(p, u, v).to(torch.int64)[None, :]
    return (lvl * p.n_tables + rows) * p.n_cells + edge_cells(p, u, v).to(torch.int64)


def edge_fingerprint(p: L0Params, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fingerprint of each canonical edge: its uint32 value, held in int64."""
    return _pair(p.a_fp[0], p.a_fp[1], p.c_fp[0], u, v)


def add_wrapped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` of two int32 tensors, wrapped mod 2^32 (summed in int64)."""
    return hashing.to_i32(a.to(torch.int64) + b.to(torch.int64))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = load_library(SOURCE).l0_sampler_update
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def _hash_words(p: L0Params) -> np.ndarray:
    """The parameters' uint32 bit patterns, in the order the C entry point
    reads them: a_lvl[2], c_lvl, a_fp[2], c_fp, a_cell[d, 2], c_cell[d]."""
    return np.ascontiguousarray(np.concatenate([
        p.a_lvl, p.c_lvl, p.a_fp, p.c_fp, p.a_cell.reshape(-1), p.c_cell,
    ]).astype(np.uint32))


def _launch(src, dst, sgn, tables, p: L0Params) -> None:
    """K3: adds the batch's rows into ``tables`` (canonicalizing them on
    the way), on the current stream."""
    words = _hash_words(p)  # bit patterns, never a value cast
    with torch.cuda.device(tables.device):
        err = _kernel()(
            src.data_ptr(), dst.data_ptr(), sgn.data_ptr(), src.shape[0],
            tables.data_ptr(), words.ctypes.data, p.n_levels, p.n_tables, p.n_cells,
            torch.cuda.current_stream(tables.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"l0_sampler_update launch failed: cudaError {err}")
    l0_delta.launches += 1


def _check(src, dst, sgn, p: L0Params, tables=None) -> None:
    dev = src.device
    for name, x in (("src", src), ("dst", dst), ("sgn", sgn)):
        if x.device != dev or x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous 1-D int32 on {dev}, got "
                f"{x.dtype}{tuple(x.shape)} on {x.device}"
            )
        if x.shape[0] != src.shape[0]:
            raise ValueError(f"{name} has {x.shape[0]} rows, src has {src.shape[0]}")
    if not 1 <= p.n_tables <= MAX_TABLES:
        raise ValueError(f"n_tables={p.n_tables}: the kernel takes 1..{MAX_TABLES} tables")
    if p.n_levels < 1 or p.n_cells < 1:
        raise ValueError(f"n_levels={p.n_levels}, n_cells={p.n_cells}: need both >= 1")
    if tables is not None and (
        tables.device != dev or tables.dtype != torch.int32
        or tuple(tables.shape) != l0_sketch_shape(p) or not tables.is_contiguous()
    ):
        raise ValueError(
            f"tables: need contiguous int32{l0_sketch_shape(p)} on {dev}, got "
            f"{tables.dtype}{tuple(tables.shape)} on {tables.device}"
        )


def l0_delta(src: torch.Tensor, dst: torch.Tensor, sgn: torch.Tensor,
             params: L0Params) -> torch.Tensor:
    """Sketch DELTA int32[L, d, C, 4] of one signed edge batch (endpoints in
    any order; +1 insert, -1 delete, 0 padding).  On a CUDA tensor one K3
    launch into fresh zeros; on a CPU tensor the plain version."""
    _check(src, dst, sgn, params)
    if not use_kernel(src):
        from repro_torch.kernels.l0_sampler.ref import l0_delta_ref

        return l0_delta_ref(*canonicalize_edges(src, dst, sgn), params)
    delta = torch.zeros(l0_sketch_shape(params), dtype=torch.int32, device=src.device)
    if src.shape[0] > 0:
        _launch(src, dst, sgn, delta, params)
    return delta


l0_delta.launches = 0


def l0_update(tables: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              sgn: torch.Tensor, params: L0Params) -> torch.Tensor:
    """``tables += l0_delta(...)`` mod 2^32, IN PLACE, and returns
    ``tables``.  On the card K3 adds straight into ``tables`` (no 25 MB
    delta at the defaults); the bits are those of adding the delta."""
    _check(src, dst, sgn, params, tables)
    if not use_kernel(src):
        return tables.copy_(add_wrapped(tables, l0_delta(src, dst, sgn, params)))
    if src.shape[0] > 0:
        _launch(src, dst, sgn, tables, params)
    return tables
