"""Wrapper of the Count-Sketch update kernel K2 (counterpart of
``repro.kernels.count_sketch.ops``): ``[t, b]`` signed counters from an
endpoint stream, on the card through ``csrc/count_sketch.cu``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.countsketch import SketchParams
from repro_torch.kernels import MAX_SMEM_BYTES, load_library, use_kernel
from repro_torch.kernels.count_sketch.ref import count_sketch_update_ref, sketch_edges_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "count_sketch.cu"
# The hash parameters ride in the kernel's argument block (4 words a table).
MAX_TABLES = 16
# Shared memory a CTA's counter window may take: what one CTA may use, less
# the 16 KB of its 32 warps' queues of folded adds (count_sketch.cu, Queue).
WINDOW_BYTES = MAX_SMEM_BYTES - 32 * 64 * 8


def plan(n_tables: int, n_buckets: int) -> Tuple[int, int]:
    """``(window, n_groups)``: the flat ``t*b`` counter index is cut into
    ``n_groups`` windows of ``window`` counters, each held in one CTA's
    shared memory (at most ``WINDOW_BYTES``), and every group of CTAs
    reads all the edges once.  All tables fit one window at the defaults
    (t=5, b=8192: 160 KB); else whole tables per window; else a table is
    split into windows."""
    cap = WINDOW_BYTES // 4
    total = n_tables * n_buckets
    if total <= cap:
        window = total
    elif n_buckets <= cap:
        window = (cap // n_buckets) * n_buckets
    else:
        window = cap
    return window, -(-total // window)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = load_library(SOURCE).count_sketch_update
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch(x0: torch.Tensor, x1: Optional[torch.Tensor], w: torch.Tensor,
            out: torch.Tensor, params: SketchParams) -> None:
    # The parameters go over as their uint32 bit patterns (a host array the
    # C entry point copies into the kernel's argument block), never as a
    # value cast.
    bits = np.ascontiguousarray(
        np.stack([params.a_h, params.c_h, params.a_g, params.c_g]).astype(np.uint32)
    )
    window, n_groups = plan(params.n_tables, params.n_buckets)
    with torch.cuda.device(w.device):
        err = _kernel()(
            x0.data_ptr(), None if x1 is None else x1.data_ptr(), w.data_ptr(),
            w.shape[0], out.data_ptr(), bits.ctypes.data, params.n_tables,
            params.n_buckets, window, n_groups,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"count_sketch_update launch failed: cudaError {err}")
    count_sketch_update.launches += 1


def _check(w: torch.Tensor, params: SketchParams, *endpoints: torch.Tensor) -> None:
    for x in endpoints:
        if (x.device != w.device or x.dtype != torch.int32 or x.dim() != 1
                or not x.is_contiguous()):
            raise ValueError(
                f"endpoints: need contiguous 1-D int32 on {w.device}, got "
                f"{x.dtype}{tuple(x.shape)} on {x.device}"
            )
        if x.shape[0] != w.shape[0]:
            raise ValueError(f"{x.shape[0]} endpoints but {w.shape[0]} weights")
    if w.dtype != torch.float32 or w.dim() != 1 or not w.is_contiguous():
        raise ValueError(f"w: need contiguous 1-D float32, got {w.dtype}{tuple(w.shape)}")
    t, b = params.n_tables, params.n_buckets
    if not 1 <= t <= MAX_TABLES:
        raise ValueError(f"n_tables={t}: the kernel takes 1..{MAX_TABLES} tables")
    if not 1 <= b or t * b >= 2**31:
        raise ValueError(f"n_buckets={b}: need b >= 1 and t*b < 2^31")


def count_sketch_update(endpoints: torch.Tensor, w: torch.Tensor,
                        params: SketchParams) -> torch.Tensor:
    """float32[t, b] counters from one endpoint stream.  On a CUDA tensor
    this launches K2 (counted in ``count_sketch_update.launches``); on a
    CPU tensor it runs the plain version.  Raises on any input the kernel
    does not take."""
    _check(w, params, endpoints)
    if not use_kernel(w):
        return count_sketch_update_ref(endpoints, w, params)
    out = torch.zeros(params.n_tables, params.n_buckets, dtype=torch.float32, device=w.device)
    if w.shape[0] > 0:
        _launch(endpoints, None, w, out, params)
    return out


count_sketch_update.launches = 0


def sketch_edges(src: torch.Tensor, dst: torch.Tensor, w_alive: torch.Tensor,
                 params: SketchParams) -> torch.Tensor:
    """Both endpoints of every edge contribute (the §5.1 update rule).  On
    the card this is ONE K2 launch that reads ``src``, ``dst`` and
    ``w_alive`` once: no ``2E`` concatenation and no copy of the weights."""
    _check(w_alive, params, src, dst)
    if not use_kernel(w_alive):
        return sketch_edges_ref(src, dst, w_alive, params)
    out = torch.zeros(params.n_tables, params.n_buckets, dtype=torch.float32,
                      device=w_alive.device)
    if w_alive.shape[0] > 0:
        _launch(src, dst, w_alive, out, params)
    return out
