"""Shared neural-net building blocks of the LM path (counterpart of
``repro.models.common``).

Parameters are plain nested dicts of tensors in the reference's layout
(a dense weight is ``[d_in, d_out]``), so carrying a JAX parameter tree
across is a copy.  Initializers draw from an explicit ``torch.Generator``:
the same distributions as the reference, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


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
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, op by op in x's dtype as XLA lowers it (each op
    rounds: in bf16 one fused sigmoid differs from it in a third of the
    elements)."""
    return x * (1 / (1 + torch.exp(-x)))


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
