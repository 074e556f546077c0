"""Wrapper of the flash-attention kernel K4 (counterpart of
``repro.kernels.flash_attention.ops``): causal, optionally sliding-window,
grouped-query attention over the model's ``[B, S, H, D]`` tensors.

:func:`flash_attention` dispatches on the device: the hand-written kernel
(``csrc/flash_attention.cu``) on a CUDA tensor, the plain version
(``ref.py``) on a CPU tensor.  ``flash_attention.launches`` counts the
kernel's calls (one per call: on bfloat16 the tile plan and the attention
are two launches on the stream).  K4 has no backward: under autograd
:func:`flash_attention` raises rather than return an output with no
gradient, and :func:`flash_attention_trainable` is the trainable route
(K4's forward, the chunked path's backward), as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import load_library, use_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, tile_bounds_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's tiles: q rows per CTA and keys per kv tile.
Q_BLOCK_BF16 = KV_TILE_BF16 = 128
KV_TILE_F32 = 32
# Codes of the C entry points at or above this are cuTensorMapEncodeTiled's
# CUresult plus it (the driver refused a tensor map); below, a cudaError_t.
TENSOR_MAP_ERROR = 1000


@functools.lru_cache(maxsize=None)
def _library():
    """The built library, with its entry points' argument types declared."""
    lib = load_library(SOURCE)
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.flash_attention_plan.restype = ctypes.c_int
    lib.flash_attention_plan.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    )
    lib.flash_attention_bf16_smem.restype = ctypes.c_int
    lib.flash_attention_bf16_smem.argtypes = [ctypes.c_int]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: the driver refused a TMA tensor map "
                           f"(CUresult {err - TENSOR_MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _n_tiles(n: int) -> int:
    return -(-n // KV_TILE_BF16)


def bf16_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one bfloat16 CTA at head dim ``d``."""
    return _library().flash_attention_bf16_smem(d)


def tile_bounds(q_positions: torch.Tensor, kv_positions: torch.Tensor) -> torch.Tensor:
    """The bfloat16 route's tile plan on its own: int32 (min, max) of each
    128-key tile's positions, then of each 128-row q block's (the kernel's
    first launch; ``ref.tile_bounds_ref`` on a CPU tensor)."""
    if not use_kernel(kv_positions):
        return tile_bounds_ref(q_positions, kv_positions, Q_BLOCK_BF16, KV_TILE_BF16)
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    sq, sk = qpos.numel(), kpos.numel()
    bounds = torch.empty(2 * (_n_tiles(sk) + _n_tiles(sq)), dtype=torch.int32,
                         device=kpos.device)
    with torch.cuda.device(kpos.device):
        err = _library().flash_attention_plan(
            qpos.data_ptr(), kpos.data_ptr(), sq, sk, bounds.data_ptr(),
            torch.cuda.current_stream(kpos.device).cuda_stream)
    _raise_on(err, "flash_attention_plan")
    return bounds


def _launch(q, k, v, out, qpos, kpos, window: Optional[int]) -> None:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    bounds = None
    if q.dtype == torch.bfloat16:  # the plan's scratch
        bounds = torch.empty(2 * (_n_tiles(sk) + _n_tiles(sq)), dtype=torch.int32,
                             device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            qpos.data_ptr(), kpos.data_ptr(), None if bounds is None else bounds.data_ptr(),
            b, sq, sk, hq, hkv, d, *strides,
            0 if window is None else int(window), 1.0 / (d ** 0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_attention_fwd")
    flash_attention.launches += 1


def _check(q, k, v, q_positions, kv_positions, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,Sq,Hq,D], k = v [B,Sk,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(batch, head dim, Hq % Hkv == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"need q, k, v all float32 or all bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == q_positions.device == kv_positions.device):
        raise ValueError("q, k, v and the positions must share one device")
    if q_positions.shape != (sq,) or kv_positions.shape != (k.shape[1],):
        raise ValueError(f"positions: need int[{sq}] and int[{k.shape[1]}] shared by the "
                         f"batch; got {tuple(q_positions.shape)}, {tuple(kv_positions.shape)}")
    if k.shape[1] < 1:
        raise ValueError("need at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: need None or >= 1")
    if d > MAX_HEAD_DIM or (q.dtype == torch.bfloat16 and d % 8):
        raise ValueError(f"head dim {d}: need <= {MAX_HEAD_DIM}, and a multiple of 8 for "
                         "bfloat16")


def _kernel_layout_ok(t: torch.Tensor) -> bool:
    """The last dim must be contiguous.  bf16 rows are read by TMA through
    the first three strides, which needs a 16-byte aligned base and strides
    that are multiples of 16 bytes."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        return False
    if t.dtype == torch.bfloat16:
        return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
    return True


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,  # int[Sq]
    kv_positions: torch.Tensor,  # int[Sk]
    kv_valid: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    block_q: int = 128,
    block_kv: int = 128,
    interpret: bool = True,
) -> torch.Tensor:
    """Causal (+ sliding-window) GQA attention, ``[B, Sq, Hq, D]`` in q's
    dtype (float32 or bfloat16).

    The signature is the reference's.  In the port the device decides the
    route: a CUDA tensor gets K4 (one call, counted in
    ``flash_attention.launches``) and a CPU tensor the plain version, so
    ``interpret`` changes nothing (the reference's interpreter stands in
    for a TPU that the port never has).  ``block_q`` and ``block_kv`` set
    the reference's Pallas tiles and the padding of Sq and Sk to them; the
    kernel picks its own tiles (bfloat16: 128-row q blocks and 128-key kv
    tiles through wgmma and a TMA ring; float32: 32 x 32) and masks the
    ragged edge instead of padding, and neither changes the output of a
    real row.  A row with no allowed key (never on the model's paths) is 0
    from the kernel and the mean of v from the plain version.

    Under autograd (grad mode on and q, k or v requiring grad) it raises
    ``RuntimeError`` on both routes: use :func:`flash_attention_trainable`.
    """
    if kv_valid is not None:
        raise NotImplementedError(
            "pallas path is for full-sequence attention; decode w/ cache "
            "validity uses the XLA path"
        )
    _check(q, k, v, q_positions, kv_positions, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # The kernel writes into an empty tensor: its output would carry no
        # grad_fn and q, k, v would silently get no gradient.  Both routes
        # raise, so the CPU shows what the card does (the reference cannot
        # differentiate its Pallas call either).
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or train through flash_attention_trainable "
            "(K4's forward with the chunked path's backward)")
    if not use_kernel(q):
        return flash_attention_ref(q, k, v, q_positions, kv_positions, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout_ok(t):
            raise ValueError(f"{name}: the kernel needs a contiguous last dim and, for "
                             "bfloat16, 16-byte aligned rows (strides multiple of 8)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.shape[1] == 0 or q.shape[0] == 0:
        return out
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    _launch(q, k, v, out, qpos, kpos, window)
    return out


flash_attention.launches = 0


class _FlashTrainable(torch.autograd.Function):
    """K4's forward; the backward is the vjp of the chunked path
    (``models.attention._chunked_gqa``) at the backward's chunk sizes,
    re-run from q, k, v: K4's output is not used in it."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, window, bwd_q_chunk, bwd_kv_chunk):
        ctx.save_for_backward(q, k, v, q_positions, kv_positions)
        ctx.chunks = (window, bwd_q_chunk, bwd_kv_chunk)
        # Grad mode is off inside forward, so this is K4's plain call.
        return flash_attention(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                               window=window)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.models.attention import chunked_vjp

        q, k, v, q_positions, kv_positions = ctx.saved_tensors
        window, q_chunk, kv_chunk = ctx.chunks
        dq, dk, dv = chunked_vjp(q, k, v, dout, q_positions=q_positions,
                                 kv_positions=kv_positions, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_trainable(
    q, k, v, *, q_positions, kv_positions, window=None,
    bwd_q_chunk: int = 512, bwd_kv_chunk: int = 1024,
):
    """K4's forward (the kernel on a CUDA tensor, its plain version on a CPU
    tensor) glued to the chunked path's backward by a
    ``torch.autograd.Function``: the reference's training route.  The
    backward re-runs ``_chunked_gqa`` on the grouped q, k, v at
    ``bwd_q_chunk`` x ``bwd_kv_chunk`` and takes its vjp (the per-chunk
    recompute from the saved log-sum-exp), as the reference does.  The
    reference's Pallas tile arguments (``block_q``, ``block_kv``,
    ``interpret``) are not taken: the kernel picks its own tiles."""
    return _FlashTrainable.apply(q, k, v, q_positions, kv_positions, window,
                                 bwd_q_chunk, bwd_kv_chunk)
