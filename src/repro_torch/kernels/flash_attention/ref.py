"""Plain PyTorch version of the flash-attention kernel (K4): dense masked
softmax attention, the counterpart of ``repro.kernels.flash_attention.ref``.

It takes the model's ``[B, S, H, D]`` layout and maps query head ``h`` to
kv head ``h // (Hq // Hkv)`` by a reshape, so it covers what the
reference's wrapper does around its kernel (``ops.py``: the transpose to
``[B*H, S, D]``, the repeat of K/V per group, the padding of Sq and Sk to
the block size).  Padding changes no real row: a padded key carries the
position 2^30, which no query reaches, and its probability is exactly 0.

Used on CPU tensors by the wrapper, by the CPU tests, and by
``chip_smoke.py`` as the plain version K4 is held against on the card.
:func:`tile_bounds_ref` and :func:`tile_plan_ref` are the plain versions of
the bfloat16 route's tile plan (which kv tiles a q block skips, masks per
element, or takes whole).
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
