"""Attention of the LM family (counterpart of ``repro.models.attention``):
GQA with causal / sliding-window masks, and the KV cache for decode.

``impl='xla'`` is the dense path, plain torch ops (the reference left it to
XLA, outside any kernel); ``impl='pallas'`` runs the flash-attention kernel
K4 (``kernels/flash_attention``): the hand-written CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor.  K4 has no backward, so under
autograd ``'pallas'`` raises (as the reference's Pallas call cannot be
differentiated); ``kernels.flash_attention.ops.flash_attention_trainable``
is its training route.  ``'xla_chunked'`` is the flash-style double chunk
loop with its own backward (:func:`_chunked_gqa`), torch ops as the
reference's was XLA; ``'auto'`` picks it when ``Sq * Sk > 4096 * 2048``.

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

# Not -inf: a fully masked early chunk then gives p = exp(0) = 1, which the
# next real maximum wipes out through alpha = exp(NEG_INF - m) = 0; with
# -inf the online softmax would form inf - inf = NaN.
NEG_INF = -2.0e38
# 'auto' takes the chunked path above this many scores per head.
AUTO_CHUNKED_SCORES = 4096 * 2048


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
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Grouped-query attention with causal (+ optional sliding-window) mask.

    impl:
      'xla'         dense S^2 scores in f32 (short sequences / decode)
      'xla_chunked' flash-style online-softmax double loop over q_chunk x
                    kv_chunk blocks (O(chunk^2) memory), with a backward
                    that recomputes each block from the saved log-sum-exp
      'pallas'      the flash-attention kernel K4 (its plain version on CPU);
                    raises under autograd
      'auto'        chunked when Sq*Sk > 4096*2048, dense otherwise
    """
    if impl == "auto":
        impl = "xla_chunked" if q.shape[1] * k.shape[1] > AUTO_CHUNKED_SCORES else "xla"
    if impl == "xla_chunked":
        # The reference expands K and V to the full query-head count first
        # (its tensor-parallel layout); their gradients then sum over the
        # group through the repeat's backward.
        g = q.shape[2] // k.shape[2]
        if g != 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return _chunked_gqa(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                            kv_valid=kv_valid, window=window, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
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


def _chunked_gqa(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    q_positions: torch.Tensor,  # int[Sq]
    kv_positions: torch.Tensor,  # int[Sk]
    kv_valid: Optional[torch.Tensor],  # bool[B, Sk] or None
    window: Optional[int],
    q_chunk: int,
    kv_chunk: int,
) -> torch.Tensor:
    """Flash attention (forward + custom backward) as a double chunk loop,
    the reference's ``_chunked_gqa``: ``[B, Sq, Hq, D]`` in v's dtype.

    Peak live memory is O(q_chunk * kv_chunk) scores in both directions: the
    backward (:class:`_ChunkedFlash`) recomputes each chunk pair's
    probabilities from the saved (out, log-sum-exp) instead of keeping
    every chunk's score matrix.  Sq and Sk are padded to chunk multiples
    (padding is differentiable torch ops around the Function): padded
    queries sit at position -2^30, padded keys at 2^30 with a built
    ``kv_valid``, so neither reaches a real row.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    pad_q = (-sq) % q_chunk
    pad_k = (-sk) % kv_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = torch.cat([q_positions, q_positions.new_full((pad_q,), -(2 ** 30))])
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_positions = torch.cat([kv_positions, kv_positions.new_full((pad_k,), 2 ** 30)])
        if kv_valid is None:
            base = torch.arange(sk + pad_k, device=k.device) < sk
            kv_valid = base[None].expand(b, sk + pad_k)
        else:
            kv_valid = torch.nn.functional.pad(kv_valid, (0, pad_k))
    out = _ChunkedFlash.apply(q, k, v, q_positions, kv_positions, kv_valid, window,
                              q_chunk, kv_chunk)
    return out[:, :sq]


def chunked_vjp(q, k, v, dout, *, q_positions, kv_positions, window, q_chunk, kv_chunk):
    """(dq, dk, dv): the vjp of :func:`_chunked_gqa` on the grouped q, k, v
    at ``dout`` (its forward re-run, then its backward), the backward of
    ``flash_attention_trainable``."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = _chunked_gqa(qq, kk, vv, q_positions=q_positions, kv_positions=kv_positions,
                           kv_valid=None, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def _chunk_mask(qpos_blk, kpos_blk, valid_blk, window):
    """bool[(b|1), 1, 1, qc, kc] allowed mask for one (q, kv) chunk pair."""
    ok = kpos_blk[None, :] <= qpos_blk[:, None]  # causal
    if window is not None:
        ok &= kpos_blk[None, :] > qpos_blk[:, None] - window
    ok = ok[None, None, None]
    if valid_blk is not None:
        ok = ok & valid_blk[:, None, None, None, :]
    return ok


def _chunks(q, k, v, q_positions, kv_positions, kv_valid, q_chunk, kv_chunk):
    """The padded inputs cut into chunks, each operand upcast to f32 once
    (the reference's products are f32 products of the operands: its
    ``preferred_element_type``; ``torch.einsum`` on bf16 would round)."""
    b, sqp, hq, d = q.shape
    _, skp, hkv, _ = k.shape
    g = hq // hkv
    nq, nk = sqp // q_chunk, skp // kv_chunk
    qc = q.float().reshape(b, nq, q_chunk, hkv, g, d).unbind(1)
    kc = k.float().reshape(b, nk, kv_chunk, hkv, d).unbind(1)
    vc = v.float().reshape(b, nk, kv_chunk, hkv, d).unbind(1)
    qpos = q_positions.reshape(nq, q_chunk).unbind(0)
    kpos = kv_positions.reshape(nk, kv_chunk).unbind(0)
    valid = (kv_valid.reshape(b, nk, kv_chunk).unbind(1) if kv_valid is not None
             else (None,) * nk)
    return qc, kc, vc, qpos, kpos, valid


class _ChunkedFlash(torch.autograd.Function):
    """The reference's ``_flash_fn`` custom vjp on padded inputs: the
    forward keeps (out, lse); the backward recomputes each chunk pair's
    probabilities ``p = exp(s - lse)`` and takes ``delta = rowsum(dout *
    out)``, kv chunks outer, q chunks inner, as the reference's scans."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, kv_valid, window, q_chunk, kv_chunk):
        b, sqp, hq, d = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        scale = _scale(d)
        qc, kc, vc, qpos, kpos, valid = _chunks(q, k, v, q_positions, kv_positions, kv_valid,
                                                q_chunk, kv_chunk)
        outs, lses = [], []
        for q_blk, qpos_blk in zip(qc, qpos):  # q_blk [b, qc, hkv, g, d]
            m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=q.device)
            acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32, device=q.device)
            for k_blk, v_blk, kpos_blk, valid_blk in zip(kc, vc, kpos, valid):
                s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
                s = torch.where(_chunk_mask(qpos_blk, kpos_blk, valid_blk, window), s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                # p rounded to v's dtype for the PV product, as the reference.
                pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v_blk)
                acc = acc * alpha[..., None] + pv
                m = m_new
            out = acc / l.clamp_min(1e-30)[..., None]  # [b, hkv, g, qc, d]
            lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.inf)
            outs.append(out.permute(0, 3, 1, 2, 4).to(v.dtype))
            lses.append(lse)
        out = torch.stack(outs, 1).reshape(b, sqp, hq, d)
        lse = torch.stack(lses)  # [nq, b, hkv, g, qc]: kept chunked
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, kv_valid, out, lse)
        ctx.static = (window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, kv_positions, kv_valid, out, lse = ctx.saved_tensors
        window, q_chunk, kv_chunk = ctx.static
        b, sqp, hq, d = q.shape
        _, skp, hkv, _ = k.shape
        g = hq // hkv
        nq = sqp // q_chunk
        scale = _scale(d)
        qc, kc, vc, qpos, kpos, valid = _chunks(q, k, v, q_positions, kv_positions, kv_valid,
                                                q_chunk, kv_chunk)
        doc = dout.float().reshape(b, nq, q_chunk, hkv, g, d).unbind(1)
        # delta_i = rowsum(dout_i * out_i): [b, hkv, g, qc] per q chunk.
        delta = (dout.float() * out.float()).sum(-1).reshape(b, nq, q_chunk, hkv, g)
        delta = delta.permute(1, 0, 3, 4, 2).unbind(0)
        dq = [torch.zeros((b, q_chunk, hkv, g, d), dtype=torch.float32, device=q.device)
              for _ in range(nq)]
        dks, dvs = [], []
        for k_blk, v_blk, kpos_blk, valid_blk in zip(kc, vc, kpos, valid):
            dk_j = torch.zeros((b, kv_chunk, hkv, d), dtype=torch.float32, device=q.device)
            dv_j = torch.zeros_like(dk_j)
            dq_j = []
            for q_blk, do_blk, lse_blk, delta_blk, qpos_blk in zip(qc, doc, lse, delta, qpos):
                s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
                ok = _chunk_mask(qpos_blk, kpos_blk, valid_blk, window)
                # p = exp(s - lse); a row with no allowed key has lse = inf: p = 0.
                p = torch.where(ok, torch.exp(s - lse_blk[..., None]), 0.0)
                dv_j = dv_j + torch.einsum("bhgqk,bqhgd->bkhd", p, do_blk)
                dp = torch.einsum("bqhgd,bkhd->bhgqk", do_blk, v_blk)
                ds = p * (dp - delta_blk[..., None]) * scale
                dq_j.append(torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk))
                dk_j = dk_j + torch.einsum("bhgqk,bqhgd->bkhd", ds, q_blk)
            dq = [acc + blk for acc, blk in zip(dq, dq_j)]
            dks.append(dk_j)
            dvs.append(dv_j)
        dq = torch.stack(dq, 1).reshape(b, sqp, hq, d).to(q.dtype)
        dk = torch.stack(dks, 1).reshape(b, skp, hkv, d).to(k.dtype)
        dv = torch.stack(dvs, 1).reshape(b, skp, hkv, d).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


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
