"""Plain PyTorch version of the flash-attention kernel (K4): dense masked
softmax attention, the counterpart of ``repro.kernels.flash_attention.ref``.

It takes the model's ``[B, S, H, D]`` layout and maps query head ``h`` to
kv head ``h // (Hq // Hkv)`` by a reshape, so it covers what the
reference's wrapper does around its kernel (``ops.py``: the transpose to
``[B*H, S, D]``, the repeat of K/V per group, the padding of Sq and Sk to
the block size).  Padding changes no real row: a padded key carries the
position 2^30, which no query reaches, and its probability is exactly 0.

Used on CPU tensors by the wrapper, by the CPU tests, and by
``chip_smoke.py`` as the plain version K4 is held against on the card;
:func:`flash_attention_lse_ref` is the plain version of the log-sum-exp K4
writes for its backward K4b (whose own plain version is the chunked path's
vjp, ``models.attention.chunked_vjp``).
:func:`tile_bounds_ref` and :func:`tile_plan_ref` are the plain versions of
the bfloat16 route's tile plan (which kv tiles a q block skips, masks per
element, or takes whole).  :func:`tf32_split_matmul` and the two
``*_tf32_ref`` functions emulate the float32 route's split-TF32 products
for the CPU tests (nothing in the port calls them).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    q_positions: torch.Tensor,  # int[Sq]
    kv_positions: torch.Tensor,  # int[Sk]
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``[B, Sq, Hq, D]`` in q's dtype: scores q.k/sqrt(D) in f32, allowed
    where ``kpos <= qpos`` (and ``kpos > qpos - window``), ``-2e38``
    elsewhere, softmax in f32, probabilities rounded to v's dtype for the
    product with v (accumulated in f32)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()).mul_(scale)
    qp, kp = q_positions.long(), kv_positions.long()
    ok = kp[None, :] <= qp[:, None]
    if window is not None:
        ok &= kp[None, :] > qp[:, None] - window
    s.masked_fill_(~ok, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.div_(s.sum(dim=-1, keepdim=True).clamp_min_(1e-30))
    out = torch.einsum("bhgqk,bkhd->bqhgd", s.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    q_positions: torch.Tensor,  # int[Sq]
    kv_positions: torch.Tensor,  # int[Sk]
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """float32 ``[B, Hq, Sq]``: each row's log-sum-exp of its allowed
    scores q.k/sqrt(D) (natural log, f32), ``+inf`` for a row with no
    allowed key, as the reference's ``_chunked_gqa`` keeps it: the plain
    version of what K4 writes for its backward (K4b)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()).mul_(scale)
    qp, kp = q_positions.long(), kv_positions.long()
    ok = kp[None, :] <= qp[:, None]
    if window is not None:
        ok &= kp[None, :] > qp[:, None] - window
    lse = s.masked_fill_(~ok, -torch.inf).logsumexp(dim=-1)  # [b, hkv, g, sq]
    return lse.masked_fill_(~ok.any(dim=-1), torch.inf).reshape(b, hq, sq)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero) as the float32 kernels round on the bits: ``(x +
    0x1000) & ~0x1fff``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_matmul(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """float32 ``a @ b`` as K4's and K4b's float32 kernels take it on the
    tensor cores: hi = TF32 of x, lo = TF32 of x - hi, and lo(a) hi(b) +
    hi(a) lo(b) + hi(a) hi(b) summed exactly, then rounded to float32
    (``products=1``: hi(a) hi(b) alone, the control that loses the f32
    limits).  Used by the tests only."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = torch.matmul(ah.double(), bh.double())
    if products == 3:
        al, bl = tf32_round(a.float() - ah), tf32_round(b.float() - bh)
        out = torch.matmul(al.double(), bh.double()) + torch.matmul(ah.double(), bl.double()) + out
    elif products != 1:
        raise ValueError(f"products={products}: need 3 (the split) or 1 (the control)")
    return out.float()


def _grouped_scores_tf32(q, k, q_positions, kv_positions, window, products):
    """(scores q.k * scale as ``[B, Hkv, g, Sq, Sk]`` through
    :func:`tf32_split_matmul`, the allowed mask ``[Sq, Sk]``)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]
    s = tf32_split_matmul(qg, kt, products) * (1.0 / (d ** 0.5))
    qp, kp = q_positions.long(), kv_positions.long()
    ok = kp[None, :] <= qp[:, None]
    if window is not None:
        ok &= kp[None, :] > qp[:, None] - window
    return s, ok


def flash_attention_tf32_ref(q, k, v, q_positions, kv_positions, *, window=None,
                             products: int = 3):
    """float32 ``[B, Sq, Hq, D]``: K4's float32 forward as its kernel
    computes it, every product split TF32 (:func:`tf32_split_matmul`),
    the softmax in float32; a row with no allowed key is 0.  The plain
    emulation the CPU tests hold against the reference; the port never
    calls it."""
    b, sq, hq, d = q.shape
    s, ok = _grouped_scores_tf32(q, k, q_positions, kv_positions, window, products)
    s = s.masked_fill(~ok, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = tf32_split_matmul(p, v.float().permute(0, 2, 1, 3)[:, :, None], products)
    out = out / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def flash_attention_bwd_tf32_ref(q, k, v, dout, q_positions, kv_positions, *, window=None,
                                 products: int = 3):
    """float32 (dq, dk, dv): K4b's float32 passes as the kernels compute
    them, from the emulated forward's log-sum-exp and output: P =
    exp(S - lse), delta = rowsum(dout * out), dV = P^T dO, dP = dO V^T,
    dS = P (dP - delta), dQ = dS K scale, dK = dS^T Q scale, each product
    split TF32, dK and dV summed over the group's q heads.  Tests only."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    s, ok = _grouped_scores_tf32(q, k, q_positions, kv_positions, window, products)
    s = s.masked_fill(~ok, -torch.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    lse = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, torch.inf))
    p = torch.exp(s - lse)  # [b, hkv, g, sq, sk]
    kg, vg = k.float().permute(0, 2, 1, 3)[:, :, None], v.float().permute(0, 2, 1, 3)[:, :, None]
    out = tf32_split_matmul(p, vg, products)  # [b, hkv, g, sq, d]
    dog = dout.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    qg = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    delta = (dog * out).sum(dim=-1, keepdim=True)
    dv = tf32_split_matmul(p.transpose(-1, -2), dog, products).double().sum(dim=2)
    dp = tf32_split_matmul(dog, vg.transpose(-1, -2), products)
    ds = p * (dp - delta)
    dq = tf32_split_matmul(ds, kg, products) * scale
    dk = tf32_split_matmul(ds.transpose(-1, -2), qg, products).double().sum(dim=2) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return dq, dk.float().permute(0, 2, 1, 3), dv.float().permute(0, 2, 1, 3)


def _block_min_max(pos: torch.Tensor, block: int) -> torch.Tensor:
    """int32 [n_blocks, 2]: (min, max) of each ``block`` consecutive
    positions, the last block over its real entries only."""
    n = pos.numel()
    nb = -(-n // block)
    p = pos.long()
    tail = nb * block - n
    lo = torch.cat([p, p.new_full((tail,), 2 ** 31)]).view(nb, block).amin(dim=1)
    hi = torch.cat([p, p.new_full((tail,), -2 ** 31 - 1)]).view(nb, block).amax(dim=1)
    return torch.stack([lo, hi], dim=1).to(torch.int32)


def tile_bounds_ref(
    q_positions: torch.Tensor, kv_positions: torch.Tensor, block_q: int, block_kv: int
) -> torch.Tensor:
    """The plan of K4's bfloat16 route (``flash_plan``): int32 (min, max) of
    each kv tile's positions, then of each q block's, flattened."""
    return torch.cat([_block_min_max(kv_positions, block_kv).flatten(),
                      _block_min_max(q_positions, block_q).flatten()])


def tile_plan_ref(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    window: Optional[int],
    block_q: int,
    block_kv: int,
) -> torch.Tensor:
    """int8 ``[n_q_blocks, n_kv_tiles]``: how K4 treats each (q block, kv
    tile) pair, from the bounds alone (``tile_kind`` in the kernel).  0:
    every pair masked, skipped; 2: every pair allowed and the tile whole
    (no key past Sk), no per-element mask; 1: mixed, masked per element."""
    sk = kv_positions.numel()
    bounds = tile_bounds_ref(q_positions, kv_positions, block_q, block_kv).long()
    n_kt = -(-sk // block_kv)
    kv, q = bounds[:2 * n_kt].view(-1, 2), bounds[2 * n_kt:].view(-1, 2)
    kmin, kmax = kv[None, :, 0], kv[None, :, 1]
    qmin, qmax = q[:, None, 0], q[:, None, 1]
    whole = (torch.arange(1, n_kt + 1, device=bounds.device) * block_kv <= sk)[None, :]
    skip = kmin > qmax
    full = (kmax <= qmin) & whole
    if window is not None:
        skip |= kmax <= qmin - window
        full &= kmin > qmax - window
    kind = torch.where(full, 2, 1)
    return torch.where(skip, 0, kind).to(torch.int8)
