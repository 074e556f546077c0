"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): top-k
routing with capacity-based dispatch (GShard/Switch style), grouped to bound
the dispatch state.

Tokens are reshaped into groups of ``gs = min(group_size, tokens)``; within a
group each token claims its top-k experts, claims are ranked first come
first served (all k=0 claims of the group before any k=1 claim), and an
expert buffer holds ``C = max(ceil(gs * top_k * capacity_factor / n_experts),
top_k)`` slots: a claim ranked C or later is dropped.

The reference moves tokens with ``[g, gs, e, C]`` one-hot dispatch and
combine tensors contracted by einsums, the TPU's way.  Here the same ranks
index the buffers directly: each kept claim's token row is copied into its
slot of an ``[e, g, C, d]`` buffer, and each token's output gathers its kept
claims' slot rows.  That equals the one-hot contraction: a slot is filled
by at most one claim (ranks are unique per expert and group), so each
dispatch sum has exactly one nonzero term and empty slots are zero rows; a
token's combine sum has one term per kept claim, the slot's output times
the claim's weight rounded to the compute dtype (``combine.astype(cd)``),
summed in float32 and rounded once, as XLA's CPU dot does for bf16.  The
expert FFN ``silu(x W_gate) * (x W_up) W_down`` runs over the whole buffer,
empty slots included, as plain batched products (the reference computes
them outside any Pallas kernel).

Aux losses: the Switch load-balance loss and the router z-loss; and the
share of tokens whose every claim was dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.models.common import silu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 2048
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


def moe_spec(cfg: MoEConfig, d_model: int, d_ff: int, lead: Tuple[int, ...] = ()):
    """Every MoE parameter as ``(shape, init)`` (``models/transformer.py``'s
    form), with the reference's ``moe_init`` stds: 1/sqrt(d_model) for the
    router and the input projections, 1/sqrt(d_ff) for ``w_down``.  ``lead``
    prefixes every shape (the stacked layer axis)."""
    e = cfg.n_experts
    std_in = ("trunc", 1.0 / math.sqrt(d_model))
    return {
        "router": {"w": ((*lead, d_model, e), std_in)},
        "w_gate": ((*lead, e, d_model, d_ff), std_in),
        "w_up": ((*lead, e, d_model, d_ff), std_in),
        "w_down": ((*lead, e, d_ff, d_model), ("trunc", 1.0 / math.sqrt(d_ff))),
    }


def capacity(cfg: MoEConfig, group: int) -> int:
    """Slots per expert and group."""
    return max(int(math.ceil(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)),
               cfg.top_k)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values on the last axis and their indices, ties broken
    toward the lower index as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def moe_apply(
    p,
    cfg: MoEConfig,
    x: torch.Tensor,  # [B, S, D]
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE FFN on ``x``: ``(y [B, S, D] in x's dtype, {"moe_aux",
    "moe_z", "moe_drop_frac"})``, float32 scalars on x's device."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    gs = min(cfg.group_size, n_tok)
    if n_tok % gs:
        raise ValueError(f"tokens {n_tok} % group {gs}: the reference's groups do not pad")
    g = n_tok // gs
    cap = capacity(cfg, gs)
    xt = x.reshape(g, gs, d)

    logits = xt.float() @ p["router"]["w"].float()  # [g, gs, e], the router in f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)  # [g, gs, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # Rank of each claim at its expert, first come first served per group,
    # every k=0 claim before any k=1 claim (the reference's transpose+cumsum).
    onehot = torch.nn.functional.one_hot(top_e, e)  # int64 [g, gs, k, e]
    flat = onehot.transpose(1, 2).reshape(g, k * gs, e)
    ranks = (flat.cumsum(1) - flat).reshape(g, k, gs, e).transpose(1, 2)
    rank = ranks.gather(-1, top_e[..., None])[..., 0]  # [g, gs, k]
    kept = rank < cap

    # Dispatch by index: kept claim (t, j) -> row (expert, group, rank); a
    # dropped claim -> the spare row e*g*cap, outside the experts' buffer.
    # Fixed shapes: no boolean index, so no read of the device.
    cd = compute_dtype
    n_rows = e * g * cap
    group = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(kept, (top_e * g + group) * cap + rank, n_rows).reshape(-1)
    rows = xt.to(cd)[:, :, None, :].expand(g, gs, k, d).reshape(-1, d)
    buf = torch.zeros(n_rows + 1, d, dtype=cd, device=x.device)
    buf[slot] = rows
    expert_in = buf[:n_rows].view(e, g * cap, d)

    h = silu(expert_in @ p["w_gate"].to(cd)) * (expert_in @ p["w_up"].to(cd))
    out = (h @ p["w_down"].to(cd)).reshape(n_rows, d)

    # Combine: each token's kept claims, weight in cd, summed in f32.
    claims = out[slot.clamp_max(n_rows - 1)].view(g, gs, k, d).masked_fill(~kept[..., None], 0)
    y = (claims.float() * top_p.to(cd).float()[..., None]).sum(2).to(cd)
    y = y.reshape(b, s, d).to(x.dtype)

    # Aux losses (Switch): top-1 assignment share against router mass.
    me = onehot[:, :, 0, :].float().mean((0, 1))
    ce = probs.mean((0, 1))
    aux = cfg.aux_loss_weight * e * (me * ce).sum()
    zloss = cfg.router_z_weight * torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - kept.any(-1).float().mean()
    return y, {"moe_aux": aux, "moe_z": zloss, "moe_drop_frac": dropped}
