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
