"""Shared neural-net building blocks (counterpart of
``repro.models.common``): dense layers, MLPs, norms, RoPE, the losses, and
the segment ops that the GNN and recsys families aggregate with.

Parameters are plain nested dicts of tensors in the reference's layout
(a dense weight is ``[d_in, d_out]``), so carrying a JAX parameter tree
across is a copy.  Initializers draw from an explicit ``torch.Generator``:
the same distributions as the reference, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.sharding.local import (
    edge_local, is_dtensor, take_last, whole_last,
)
from repro_torch.sharding.local import matmul as sharded_matmul


def trunc_normal(generator: torch.Generator, shape: Sequence[int], std: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn in f32."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.to(dtype).mul_(std)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               std: Optional[float] = None, dtype=torch.float32, device=None):
    """``{"w": [d_in, d_out]}`` at std ``1/sqrt(d_in)`` (and a zero ``"b"``)."""
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": trunc_normal(generator, (d_in, d_out), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``x @ w (+ b)``, with the weight and x cast to ``compute_dtype``
    first (a cast copy per call, as in the reference)."""
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = sharded_matmul(x, w) if is_dtensor(w) else x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def mlp_init(generator: torch.Generator, dims: Sequence[int], *, bias: bool = True,
             dtype=torch.float32, device=None):
    """``{"layer<i>": dense_init(dims[i], dims[i + 1])}`` for each pair."""
    return {f"layer{i}": dense_init(generator, dims[i], dims[i + 1], bias=bias, dtype=dtype,
                                    device=device)
            for i in range(len(dims) - 1)}


def mlp(p, x: torch.Tensor, act: Optional[Callable] = None, compute_dtype=None,
        final_act: bool = False) -> torch.Tensor:
    """Dense layers in ``p``'s order, ``act`` (default :func:`silu`) after
    each but the last (and after the last too with ``final_act``)."""
    act = silu if act is None else act
    n = len(p)
    for i in range(n):
        x = dense(p[f"layer{i}"], x, compute_dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


class _Silu(torch.autograd.Function):
    """``x * (1 / (1 + exp(-x)))`` op by op, whose backward is
    ``g * (r + x r (1 - r))`` with r = 1 / (1 + exp(-x)): the same
    derivative as autograd's through the ops, but finite where exp(-x)
    overflows (x < -88 in f32), where autograd's is 0 * inf = NaN and
    JAX's (through ``sigmoid``) is 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        r = 1 / (1 + torch.exp(-x))
        return grad * (r + x * r * (1 - r))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, op by op in x's dtype as XLA lowers it (each op
    rounds: in bf16 one fused sigmoid differs from it in a third of the
    elements); its gradient stays finite for very negative x (:class:`_Silu`)."""
    return _Silu.apply(x)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


# ----------------------------- RoPE ----------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] int.  Rotates in
    f32 and casts back to x's dtype."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)  # [d/2]
    angles = positions[..., :, None].float() * freqs  # [..., seq, d/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., seq, 1, d/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------- losses & metrics -----------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, z_loss: float = 0.0):
    """Token-level cross entropy with an optional z-loss, logits promoted to
    f32: ``(mean loss, {"loss", "accuracy", "tokens"})``.

    logits ``[..., V]``; labels int ``[...]``; mask broadcastable to labels
    (the token count is its sum, at least 1)."""
    logits = whole_last(logits).float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):  # each device its rows (DTensor's gather strategy would mask)
        ll = take_last(logits, labels)
    else:
        ll = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    mask = torch.ones_like(loss) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    mean = (loss * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).float() * mask).sum() / denom
    return mean, {"loss": mean, "accuracy": acc, "tokens": denom}


def l2_loss(pred: torch.Tensor, target: torch.Tensor):
    """Mean squared error in f32: ``(loss, {"loss", "rmse"})``."""
    loss = (pred.float() - target.float()).square().mean()
    return loss, {"loss": loss, "rmse": torch.sqrt(loss)}


# --------------------- segment ops (GNN substrate) ---------------------------

# Rows of a low-precision segment sum converted to the f32 accumulator at a
# time (a [2^22, 128] chunk is 2 GiB of f32).
SEGMENT_CHUNK = 1 << 22


class _SegmentSum(torch.autograd.Function):
    """``out[s] = sum of data[i] with ids[i] == s``.  bf16 and f16 rows are
    added up in an f32 accumulator, a chunk of rows converted at a time,
    and the sums rounded once to data's dtype: on the card ``index_add_``
    adds with atomics, whose order is not fixed, and an f32 accumulator
    keeps that order's effect at f32 rounding.  The backward is the gather
    ``grad[ids]``."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        low = data.dtype in (torch.bfloat16, torch.float16)
        out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                          dtype=torch.float32 if low else data.dtype, device=data.device)
        if not low:
            return out.index_add_(0, ids, data)
        for a in range(0, data.shape[0], SEGMENT_CHUNK):
            out.index_add_(0, ids[a:a + SEGMENT_CHUNK], data[a:a + SEGMENT_CHUNK].float())
        return out.to(data.dtype)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


class _Gather(torch.autograd.Function):
    """``data[ids]`` along dim 0, whose backward is :class:`_SegmentSum`:
    the scatter of the gradient accumulates in f32 as the forward's sums
    do."""

    @staticmethod
    def forward(ctx, data, ids):
        ctx.save_for_backward(ids)
        ctx.rows = data.shape[0]
        return data.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return segment_sum(grad, ids, ctx.rows), None


class _GatherScaleSum(torch.autograd.Function):
    """``out[s] = sum over the edges e with dst[e] == s of data[src[e]] *
    w[e]``: a gather, a scale and a segment sum a chunk of SEGMENT_CHUNK
    edges at a time, so no ``[E, ...]`` message tensor is ever whole (at
    ogb_products' 61.9 M edges and width 128 one is 15.8 GB in bf16, 31.7
    GB in f32).  Each chunk's messages are rounded to data's dtype as the
    reference's ``take(...) * w`` rounds them, then summed in the f32
    accumulator of :class:`_SegmentSum`; the backward runs the same loop
    the other way (dst -> src).  ``w`` is a constant (no gradient)."""

    @staticmethod
    def forward(ctx, data, src, dst, weight, num_segments):
        ctx.save_for_backward(src, dst, weight)
        ctx.rows = data.shape[0]
        return _scaled_sums(data, src, dst, weight, num_segments)

    @staticmethod
    def backward(ctx, grad):
        src, dst, weight = ctx.saved_tensors
        return _scaled_sums(grad, dst, src, weight, ctx.rows), None, None, None, None


def _scaled_sums(data, take, put, weight, rows):
    low = data.dtype in (torch.bfloat16, torch.float16)
    out = torch.zeros((rows,) + tuple(data.shape[1:]),
                      dtype=torch.float32 if low else data.dtype, device=data.device)
    tail = (1,) * (data.dim() - 1)
    for a in range(0, take.shape[0], SEGMENT_CHUNK):
        b = a + SEGMENT_CHUNK
        msgs = data.index_select(0, take[a:b]) * weight[a:b].view((-1,) + tail).to(data.dtype)
        out.index_add_(0, put[a:b], msgs.to(out.dtype))
    return out.to(data.dtype)


def gather_segment_sum(data: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       weight: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_sum(gather(data, src) * weight[:, None], dst, n)`` in
    chunks of edges (:class:`_GatherScaleSum`): the same sums, without the
    whole message tensor.  ``weight`` gets no gradient."""
    if weight.requires_grad:
        raise ValueError("gather_segment_sum: the edge weights are constants")
    n = int(num_segments)
    if any(is_dtensor(t) for t in (data, src, dst)):
        return edge_local(lambda d, s_, t, w: _GatherScaleSum.apply(d, _ids(s_), _ids(t), w, n),
                          (data,), (src, dst, weight))
    return _GatherScaleSum.apply(data, _ids(src), _ids(dst), weight, n)


def _ids(ids: torch.Tensor) -> torch.Tensor:
    return ids if ids.dtype == torch.int64 else ids.long()


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_sum``: rows of ``data`` added up by segment, in
    data's dtype (accumulated in f32, see :class:`_SegmentSum`)."""
    n = int(num_segments)
    if is_dtensor(data) or is_dtensor(segment_ids):
        return edge_local(lambda d, i: _SegmentSum.apply(d, _ids(i), n), (), (data, segment_ids))
    return _SegmentSum.apply(data, _ids(segment_ids), n)


def gather(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(data, ids, axis=0)`` for 1-D ``ids``; the gradient's
    scatter accumulates in f32."""
    if is_dtensor(data) or is_dtensor(ids):
        return edge_local(lambda d, i: _Gather.apply(d, _ids(i)), (data,), (ids,), out="edges")
    return _Gather.apply(data, _ids(ids))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Each segment's sum over its row count (at least 1), both in data's
    dtype, as the reference divides."""
    s = segment_sum(data, segment_ids, num_segments)
    ones = (torch.ones_like(data.reshape(data.shape[0], -1)[:, 0]) if is_dtensor(data)
            else torch.ones(data.shape[:1], dtype=data.dtype, device=data.device))
    cnt = segment_sum(ones, segment_ids, num_segments)
    return s / cnt.clamp_min(1.0)[(...,) + (None,) * (data.dim() - 1)]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_max``: -inf where a segment is empty.  Its gradient
    goes to the rows that reach the maximum, split evenly among ties."""
    if is_dtensor(data) or is_dtensor(segment_ids):
        return edge_local(lambda d, i: segment_max(d, i, num_segments), (), (data, segment_ids),
                          reduce_op="max")
    ids = _ids(segment_ids)
    index = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    init = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                      dtype=data.dtype, device=data.device)
    return init.scatter_reduce(0, index, data, "amax", include_self=False)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Softmax over variable-size segments (edge softmax), each trailing
    column on its own (the reference vmaps it over heads)."""
    smax = segment_max(scores, segment_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(scores - gather(smax, segment_ids))
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / gather(denom, segment_ids).clamp_min(1e-9)


def tree_from_reference(tree, like, device) -> dict:
    """The reference's parameter tree (numpy arrays, or anything
    ``numpy.asarray`` takes) as f32 tensors on ``device``, in the structure
    of ``like`` (the port's parameters for the same config, e.g. drawn on
    the ``meta`` device), each shape checked against it."""
    def take(node, ref, path):
        if isinstance(ref, dict):
            if sorted(node) != sorted(ref):
                raise ValueError(f"{path or '/'}: keys {sorted(node)}, the config gives "
                                 f"{sorted(ref)}")
            return {k: take(node[k], ref[k], f"{path}/{k}") for k in ref}
        a = np.asarray(node)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{path}: shape {a.shape}, the config gives {tuple(ref.shape)}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return take(tree, like, "")


def count_params(params) -> int:
    """Elements over every leaf of a parameter tree."""
    from repro_torch import tree

    return sum(int(x.numel()) for x in tree.leaves(params))
