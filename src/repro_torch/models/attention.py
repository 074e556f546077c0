"""Attention of the LM family (counterpart of ``repro.models.attention``):
GQA with causal / sliding-window masks, and the KV cache for decode.

``impl='xla'`` is the dense path, plain torch ops (the reference left it to
XLA, outside any kernel); ``impl='pallas'`` runs the flash-attention kernel
K4 (``kernels/flash_attention``): the hand-written CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor.  ``'xla_chunked'`` and
``'auto'`` raise: the chunked online-softmax path and its custom backward
come with the training path (ROADMAP Queue 1, item 12).

Positions may also be given per batch row (``q_positions [B, Sq]``,
``kv_positions [B, Sk]``) on the dense path: the serving engine decodes
its slots as one batch, each at its own length.  The reference vmaps a
B=1 decode over the slots instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

NEG_INF = -2.0e38
_NOT_PORTED = ("impl={!r}: the chunked flash path (and 'auto', which picks it) comes with "
               "the training path, ROADMAP Queue 1 item 12")


def _causal_window_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                        window: Optional[int]) -> torch.Tensor:
    """bool[..., Q, K] allowed-attention mask: kv_pos <= q_pos (& within window)."""
    ok = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= kv_pos[..., None, :] > q_pos[..., :, None] - window
    return ok


def _scale(d: int) -> float:
    """The reference's ``1 / jnp.sqrt(d).astype(float32)``, in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def gqa_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    q_positions: torch.Tensor,  # int[Sq] (or [B, Sq] on the dense path)
    kv_positions: torch.Tensor,  # int[Sk] (or [B, Sk])
    kv_valid: Optional[torch.Tensor] = None,  # bool[B, Sk] cache-slot validity
    window: Optional[int] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Grouped-query attention with causal (+ optional sliding-window) mask.

    impl:
      'xla'     dense S^2 scores in f32 (short sequences / decode)
      'pallas'  the flash-attention kernel K4 (its plain version on CPU)
    The reference's ``q_chunk``/``kv_chunk`` arguments belong to its chunked
    path ('xla_chunked', 'auto'), which is not ported yet; they come with it.
    """
    if impl in ("auto", "xla_chunked"):
        raise NotImplementedError(_NOT_PORTED.format(impl))
    if impl == "pallas":
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(
            q, k, v,
            q_positions=q_positions, kv_positions=kv_positions,
            kv_valid=kv_valid, window=window,
        )
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")

    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    g = hq // hkv

    qg = q.reshape(b, sq, hkv, g, d)
    # [B, Hkv, G, Sq, Sk], f32 (the reference's preferred_element_type).
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * _scale(d)
    mask = _causal_window_mask(q_positions, kv_positions, window)  # [(B,) Sq, Sk]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]  # [B, Sq, Sk]
    mask = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(b, sq, hq, d)


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static description of a decode KV cache.

    For sliding-window layers the cache is a rolling buffer of ``window``
    slots (the Mistral/Mixtral rolling cache).
    """

    batch: int
    n_layers: int
    max_len: int  # slots actually materialized (min(seq, window) for SWA)
    n_kv_heads: int
    d_head: int
    dtype: torch.dtype = torch.bfloat16


Lengths = Union[int, torch.Tensor]


def lengths(cur_len: Lengths, batch: int, device) -> torch.Tensor:
    """``cur_len`` as int64[batch]: one scalar for every row, or one per row."""
    t = torch.as_tensor(cur_len, dtype=torch.int64, device=device)
    return t.expand(batch) if t.dim() == 0 else t


def cache_update(
    cache_k: torch.Tensor,  # [B, M, Hkv, D] one layer's cache
    cache_v: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    cur_len: Lengths,  # tokens already in the cache (per row, or one for all)
    rolling: bool,
):
    """Writes the new token's K/V at slot ``cur_len % M`` (rolling) or
    ``min(cur_len, M - 1)`` (dense), IN PLACE, and returns the two caches.
    The reference returns updated copies."""
    b, m = cache_k.shape[0], cache_k.shape[1]
    cur = lengths(cur_len, b, cache_k.device)
    slot = cur % m if rolling else cur.clamp(max=m - 1)
    rows = torch.arange(b, device=cache_k.device)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] current-token queries (RoPE applied)
    cache_k: torch.Tensor,  # [B, M, Hkv, D] already containing the new token
    cache_v: torch.Tensor,
    cur_len: Lengths,  # position of the CURRENT token (per row, or one for all)
    *,
    window: Optional[int] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """One-token attention against the cache.

    Cache slot i holds absolute position i for dense caches; for rolling
    caches slot s holds the largest position p <= cur_len with p % M == s.
    Absolute positions are rebuilt from cur_len for masking.
    """
    b, m = cache_k.shape[0], cache_k.shape[1]
    cur = lengths(cur_len, b, cache_k.device)[:, None]  # [B, 1]
    slots = torch.arange(m, dtype=torch.int64, device=cache_k.device)[None, :]
    if window is None:
        kv_pos = slots.expand(b, m)  # direct-mapped cache
        valid = slots <= cur
    else:
        cur_slot = cur % m
        wrapped = slots > cur_slot
        kv_pos = cur - cur_slot + slots - torch.where(wrapped, m, 0)
        valid = (kv_pos >= 0) & (kv_pos > cur - window) & (kv_pos <= cur)
    return gqa_attention(
        q, cache_k, cache_v,
        q_positions=cur, kv_positions=kv_pos,
        kv_valid=valid.expand(b, m),
        window=None,  # windowing already folded into `valid`
        impl=impl,
    )
