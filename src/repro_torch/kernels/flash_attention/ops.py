"""Wrappers of the flash-attention kernels K4 and K4b (counterpart of
``repro.kernels.flash_attention.ops``): causal, optionally sliding-window,
grouped-query attention over the model's ``[B, S, H, D]`` tensors.

:func:`flash_attention` dispatches on the device: the hand-written kernel
(``csrc/flash_attention.cu``) on a CUDA tensor, the plain version
(``ref.py``) on a CPU tensor.  ``flash_attention.launches`` counts the
kernel's calls (one per call: on bfloat16 the tile plan and the attention
are two launches on the stream).  K4 has no backward of its own: under
autograd :func:`flash_attention` raises rather than return an output with
no gradient, and :func:`flash_attention_trainable` is the trainable route,
as in the reference: K4's forward (which then also writes each row's
log-sum-exp) and, on a CUDA tensor, the backward kernel K4b
(:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``; counted in
``flash_attention_bwd.launches``), whose plain version is the chunked
path's vjp (``models.attention.chunked_vjp``), the reference's backward.
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
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's tiles: q rows per CTA and keys per kv tile (float32: 64-row
# CTAs over 32-key steps, split-TF32 wgmma, ``kernels/csrc/flash_tf32.cuh``).
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
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.flash_attention_plan.restype = ctypes.c_int
    lib.flash_attention_plan.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    )
    lib.flash_attention_bf16_smem.restype = ctypes.c_int
    lib.flash_attention_bf16_smem.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    """K4b's built library, with its entry points' argument types declared."""
    lib = load_library(BWD_SOURCE)
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 24
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.flash_attention_bwd_smem.restype = ctypes.c_int
    lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
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


def bwd_bf16_smem_bytes(d: int) -> dict:
    """Dynamic shared memory of one bfloat16 CTA of K4b's dK/dV and dQ
    kernels at head dim ``d``."""
    lib = _bwd_library()
    return {"dkdv": lib.flash_attention_bwd_smem(d, 0), "dq": lib.flash_attention_bwd_smem(d, 1)}


def _query(lib, name: str, nargs: int, restype=ctypes.c_int):
    """A size query of a built library (declared at first use)."""
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, [ctypes.c_int] * nargs
    return fn


def f32_smem_bytes(d: int) -> dict:
    """Dynamic shared memory of one float32 CTA at head dim ``d``: K4's
    forward and K4b's dV, dK and dQ passes."""
    bwd = _query(_bwd_library(), "flash_attention_bwd_f32_smem", 2)
    return {"fwd": _query(_library(), "flash_attention_f32_smem", 1)(d), "dv": bwd(d, 0),
            "dk": bwd(d, 1), "dq": bwd(d, 2)}


def f32_scratch_bytes_built(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, *,
                            backward: bool = False) -> int:
    """The scratch bytes the built library carves (``f32_scratch_bytes``
    mirrors it; the card's tests hold the two equal)."""
    lib, name = ((_bwd_library(), "flash_attention_bwd_f32_scratch") if backward
                 else (_library(), "flash_attention_f32_scratch"))
    return _query(lib, name, 6, ctypes.c_longlong)(b, sq, sk, hq, hkv, d)


def f32_scratch_bytes(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, *,
                      backward: bool = False) -> int:
    """Bytes of the float32 route's scratch, as the C entry points carve it
    (``flash_tf32.cuh``): each part rounded up to 256 bytes; the int32
    (min, max) of every 32 keys and 32 q rows, then each split copy as its
    TF32 hi and lo, D padded to 32, 64 or 128 columns.  Forward: q and k
    as rows, v as columns (the sequence rounded up to 8); backward: q and
    dout as rows and columns, k as rows and columns, v as rows."""
    dp = 32 if d <= 32 else 64 if d <= 64 else 128

    def up(n: int, m: int) -> int:
        return -(-n // m) * m

    q_rows, q_cols = 8 * b * hq * sq * dp, 8 * b * hq * dp * up(sq, 8)
    k_rows, k_cols = 8 * b * hkv * sk * dp, 8 * b * hkv * dp * up(sk, 8)
    parts = [8 * (up(sk, 32) + up(sq, 32)) // 32]
    parts += ([q_rows, q_cols, q_rows, q_cols, k_rows, k_cols, k_rows] if backward
              else [q_rows, k_rows, k_cols])
    return sum(up(n, 256) for n in parts)


def bwd_rows_scratch(b: int, sq: int, hq: int, dtype: torch.dtype) -> int:
    """Float32 values of K4b's per-row scratch: delta, ``[B, Hq, Sq]``, for
    float32; for bfloat16 each row's log-sum-exp times log2 e and its delta,
    each ``[B, Hq, Sq']`` with Sq' = Sq rounded up to the 128-row q block,
    the rows past Sq filled (+inf, 0) by the pre-pass so that the dK/dV
    kernel's 1-D bulk copies of 64 rows never read past an array."""
    if dtype == torch.bfloat16:
        return 2 * b * hq * _n_tiles(sq) * Q_BLOCK_BF16
    return b * hq * sq


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


def _plan_scratch(q, k, *, backward: bool = False) -> torch.Tensor:
    """The C entry's ``bounds`` scratch: the bfloat16 route's tile plan, or
    the float32 route's plan and split copies (``f32_scratch_bytes``)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        return torch.empty(2 * (_n_tiles(sk) + _n_tiles(sq)), dtype=torch.int32,
                           device=q.device)
    return torch.empty(f32_scratch_bytes(b, sq, sk, hq, hkv, d, backward=backward),
                       dtype=torch.uint8, device=q.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, out, qpos, kpos, window: Optional[int],
            lse: Optional[torch.Tensor] = None) -> None:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    bounds = _plan_scratch(q, k)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
            qpos.data_ptr(), kpos.data_ptr(), _ptr(bounds),
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
    tiles through wgmma and a TMA ring; float32: 64-row q blocks and
    32-key tiles through split-TF32 wgmma) and masks the
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
            "(K4's forward with its backward kernel K4b)")
    if not use_kernel(q):
        return flash_attention_ref(q, k, v, q_positions, kv_positions, window=window)
    return _kernel_forward(q, k, v, q_positions, kv_positions, window, with_lse=False)[0]


flash_attention.launches = 0


def _check_layout(**tensors) -> None:
    for name, t in tensors.items():
        if not _kernel_layout_ok(t):
            raise ValueError(f"{name}: the kernel needs a contiguous last dim and, for "
                             "bfloat16, 16-byte aligned rows (strides multiple of 8)")


def _positions(q_positions, kv_positions):
    return (q_positions.to(torch.int32).contiguous(),
            kv_positions.to(torch.int32).contiguous())


def _kernel_forward(q, k, v, q_positions, kv_positions, window, *, with_lse: bool):
    """K4 on checked CUDA tensors: (out, each row's log-sum-exp as float32
    ``[B, Hq, Sq]`` in natural log, or None)."""
    _check_layout(q=q, k=k, v=v)
    b, sq, hq, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if sq == 0 or b == 0:
        return out, lse
    qpos, kpos = _positions(q_positions, kv_positions)
    _launch(q, k, v, out, qpos, kpos, window, lse)
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    out: torch.Tensor,  # K4's output, [B, Sq, Hq, D]
    dout: torch.Tensor,  # its cotangent
    lse: Optional[torch.Tensor],  # K4's float32 [B, Hq, Sq] log-sum-exp (natural log)
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
):
    """(dq, dk, dv) of causal (+ sliding-window) GQA attention at ``dout``,
    in q's dtype: K4b on a CUDA tensor (one call, counted in
    ``flash_attention_bwd.launches``), from K4's ``out`` and ``lse``.  On a
    CPU tensor its plain version, the vjp of the chunked path at ``q_chunk``
    x ``kv_chunk`` (``models.attention.chunked_vjp``: the reference's
    backward, re-run from q, k, v, so ``out`` and ``lse`` are not read);
    the kernel picks its own tiles.  ``dout`` is made contiguous when its
    layout is one the kernel does not take (autograd's cotangents can be
    expanded views); q, k, v and out must be in K4's layout."""
    _check(q, k, v, q_positions, kv_positions, window)
    if not use_kernel(q):
        from repro_torch.models.attention import chunked_vjp

        return chunked_vjp(q, k, v, dout, q_positions=q_positions, kv_positions=kv_positions,
                           window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, sq, hq, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)}: need q's "
                         f"shape {tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout: need q's dtype {q.dtype}; got {out.dtype}, "
                         f"{dout.dtype}")
    if lse is None or lse.dtype != torch.float32 or lse.shape != (b, hq, sq) or (
            not lse.is_contiguous()):
        raise ValueError(f"lse: need contiguous float32 [{b}, {hq}, {sq}] from K4's forward")
    if not (out.device == dout.device == lse.device == q.device):
        raise ValueError("out, dout and lse must lie on q's device")
    if not _kernel_layout_ok(dout):
        dout = dout.contiguous()
    _check_layout(q=q, k=k, v=v, out=out, dout=dout)
    if sq == 0 or b == 0:  # no query: no gradient reaches k or v
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # The kernels write every row of each.
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    qpos, kpos = _positions(q_positions, kv_positions)
    sk, hkv, d = k.shape[1], k.shape[2], k.shape[3]
    bounds = _plan_scratch(q, k, backward=True)
    rows = torch.empty(bwd_rows_scratch(b, sq, hq, q.dtype), dtype=torch.float32,
                       device=q.device)
    strides = [s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _bwd_library().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), _ptr(bounds), rows.data_ptr(), b, sq, sk, hq, hkv, d, *strides,
            0 if window is None else int(window), 1.0 / (d ** 0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashTrainable(torch.autograd.Function):
    """K4's forward; the backward is :func:`flash_attention_bwd`: K4b from
    K4's output and log-sum-exp on a CUDA tensor, the vjp of the chunked
    path (``models.attention._chunked_gqa``) at the backward's chunk sizes,
    re-run from q, k, v, on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, window, bwd_q_chunk, bwd_kv_chunk):
        _check(q, k, v, q_positions, kv_positions, window)
        if use_kernel(q):
            out, lse = _kernel_forward(q, k, v, q_positions, kv_positions, window,
                                       with_lse=True)
        else:
            out, lse = flash_attention_ref(q, k, v, q_positions, kv_positions,
                                           window=window), None
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.chunks = (window, bwd_q_chunk, bwd_kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_positions, kv_positions = ctx.saved_tensors
        window, q_chunk, kv_chunk = ctx.chunks
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, q_positions=q_positions,
                                         kv_positions=kv_positions, window=window,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_trainable(
    q, k, v, *, q_positions, kv_positions, window=None,
    bwd_q_chunk: int = 512, bwd_kv_chunk: int = 1024,
):
    """K4's forward glued to a backward by a ``torch.autograd.Function``:
    the reference's training route.  On a CUDA tensor K4 (once, also
    writing each row's log-sum-exp) and K4b (once): no torch-op attention
    runs, and a K4b that fails to build or launch raises.  On a CPU tensor
    K4's plain version, and the vjp of ``_chunked_gqa`` re-run on the
    grouped q, k, v at ``bwd_q_chunk`` x ``bwd_kv_chunk`` (the per-chunk
    recompute from the saved log-sum-exp), as the reference does.  The
    reference's Pallas tile arguments (``block_q``, ``block_kv``,
    ``interpret``) are not taken: the kernels pick their own tiles."""
    return _FlashTrainable.apply(q, k, v, q_positions, kv_positions, window,
                                 bwd_q_chunk, bwd_kv_chunk)
