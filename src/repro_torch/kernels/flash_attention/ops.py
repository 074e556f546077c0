"""Wrapper of the flash-attention kernel K4 (counterpart of
``repro.kernels.flash_attention.ops``): causal, optionally sliding-window,
grouped-query attention over the model's ``[B, S, H, D]`` tensors.

:func:`flash_attention` dispatches on the device: the hand-written kernel
(``csrc/flash_attention.cu``) on a CUDA tensor, the plain version
(``ref.py``) on a CPU tensor.  ``flash_attention.launches`` counts the
kernel's launches.  The reference's training wrapper
(``flash_attention_trainable``, K4's forward with the chunked XLA
backward) comes with the port's training path.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import load_library, use_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = load_library(SOURCE).flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def _launch(q, k, v, out, qpos, kpos, window: Optional[int]) -> None:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            qpos.data_ptr(), kpos.data_ptr(), b, sq, sk, hq, hkv, d, *strides,
            0 if window is None else int(window), 1.0 / (d ** 0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
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
    """The kernel reads rows with 16-byte loads (bf16) through the first
    three strides; the last dim must be contiguous."""
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
    route: a CUDA tensor gets K4 (one launch, counted in
    ``flash_attention.launches``) and a CPU tensor the plain version, so
    ``interpret`` changes nothing (the reference's interpreter stands in
    for a TPU that the port never has).  ``block_q`` and ``block_kv`` set
    the reference's Pallas tiles and the padding of Sq and Sk to them; the
    kernel picks its own tiles (64 x 64 for bfloat16, 32 x 32 for float32)
    and masks the ragged edge instead of padding, and neither changes the
    output of a real row.  A row with no allowed key (never on the model's
    paths) is 0 from the kernel and the mean of v from the plain version.
    """
    if kv_valid is not None:
        raise NotImplementedError(
            "pallas path is for full-sequence attention; decode w/ cache "
            "validity uses the XLA path"
        )
    _check(q, k, v, q_positions, kv_positions, window)
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
