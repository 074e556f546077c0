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
from repro_torch.sharding.local import fsdp_weight, is_dtensor, run_local
from repro_torch.sharding.rules import shard


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
    "moe_z", "moe_drop_frac"})``, float32 scalars on x's device.

    On DTensors (the dry-run's sharded steps) the routing, dispatch and
    combine run on each device's own groups (``run_local``) and the expert
    FFN as DTensor products over ``[e, groups x capacity, d]`` buffers split
    over the batch axes; with experts split too (expert parallelism) DTensor
    moves the buffers between the layouts."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    gs = min(cfg.group_size, n_tok)
    if n_tok % gs:
        raise ValueError(f"tokens {n_tok} % group {gs}: the reference's groups do not pad")
    cd = compute_dtype
    if is_dtensor(x):
        return _moe_sharded(p, cfg, x, gs, cd)
    expert_in, route = _dispatch(p["router"]["w"], cfg, x, gs, cd)
    out = _experts(p, expert_in, cd)
    y, aux = _combine(cfg, out, route)
    return y.reshape(b, s, d).to(x.dtype), aux


def _dispatch(router_w, cfg: MoEConfig, x, gs: int, cd):
    """Routing and dispatch of ``x``'s groups: ``(expert_in [e, g*cap, d],
    route)``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = b * s // gs
    cap = capacity(cfg, gs)
    xt = x.reshape(g, gs, d)

    logits = xt.float() @ router_w.float()  # [g, gs, e], the router in f32
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
    n_rows = e * g * cap
    group = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(kept, (top_e * g + group) * cap + rank, n_rows).reshape(-1)
    rows = xt.to(cd)[:, :, None, :].expand(g, gs, k, d).reshape(-1, d)
    buf = torch.zeros(n_rows + 1, d, dtype=cd, device=x.device)
    buf[slot] = rows
    expert_in = buf[:n_rows].view(e, g * cap, d)
    return expert_in, (slot, kept, top_p, onehot, probs, logits)


def _experts(p, expert_in, cd):
    """The expert FFN over the whole buffer, empty slots included."""
    w_gate = fsdp_weight(p["w_gate"], expert_in, in_dim=1)
    w_up = fsdp_weight(p["w_up"], expert_in, in_dim=1)
    h = silu(expert_in @ w_gate.to(cd)) * (expert_in @ w_up.to(cd))
    h = shard(h, "expert", "batch", "mlp")
    out = h @ fsdp_weight(p["w_down"], h, in_dim=1).to(cd)
    return shard(out, "expert", "batch", "embed")


def _combine(cfg: MoEConfig, out, route):
    """Each token's kept claims, weight in cd, summed in f32: ``(y [g, gs,
    d] in cd, aux)``."""
    slot, kept, top_p, onehot, probs, logits = route
    e = cfg.n_experts
    g, gs, k = kept.shape
    d = out.shape[-1]
    n_rows = out.shape[0] * out.shape[1]
    cd = out.dtype
    claims = out.reshape(n_rows, d)[slot.clamp_max(n_rows - 1)].view(g, gs, k, d)
    claims = claims.masked_fill(~kept[..., None], 0)
    y = (claims.float() * top_p.to(cd).float()[..., None]).sum(2).to(cd)

    # Aux losses (Switch): top-1 assignment share against router mass.
    me = onehot[:, :, 0, :].float().mean((0, 1))
    ce = probs.mean((0, 1))
    aux = cfg.aux_loss_weight * e * (me * ce).sum()
    zloss = cfg.router_z_weight * torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - kept.any(-1).float().mean()
    return y, {"moe_aux": aux, "moe_z": zloss, "moe_drop_frac": dropped}


def _moe_sharded(p, cfg: MoEConfig, x, gs: int, cd):
    """:func:`moe_apply` on DTensors: each device routes and dispatches its
    own groups (a group never spans devices: with fewer tokens a device
    than a group, the batch is gathered first)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b, s, d = x.shape
    x = shard(x, "batch", None, None)
    mesh = x.device_mesh
    batch_axes = [i for i, pl in enumerate(x.placements) if isinstance(pl, Shard)]
    local_tok = x.to_local().shape[0] * s
    if local_tok % gs:
        x = x.redistribute(mesh, (Replicate(),) * mesh.ndim)
        batch_axes = []
    router = p["router"]["w"]
    router = router.redistribute(mesh, (Replicate(),) * mesh.ndim)
    rows_pl = tuple(Shard(1) if i in batch_axes else Replicate() for i in range(mesh.ndim))
    tok_pl = tuple(Shard(0) if i in batch_axes else Replicate() for i in range(mesh.ndim))
    expert_in, *route = run_local(
        lambda xl, w: (lambda ei, r: (ei, *r))(*_dispatch(w, cfg, xl, gs, cd)),
        (x, router), (rows_pl,) + (tok_pl,) * 6)
    expert_in = shard(expert_in, "expert", "batch", "embed")
    out = _experts(p, expert_in, cd)
    out = out.redistribute(mesh, rows_pl)
    mean_pl = tuple(Partial("avg") if i in batch_axes else Replicate() for i in range(mesh.ndim))
    y, aux, zloss, dropped = run_local(
        lambda o, *r: (lambda yy, a: (yy, a["moe_aux"], a["moe_z"], a["moe_drop_frac"]))(
            *_combine(cfg, o, r)),
        (out, *route), (tok_pl, mean_pl, mean_pl, mean_pl))
    aux_d = {"moe_aux": aux, "moe_z": zloss, "moe_drop_frac": dropped}
    return y.reshape(b, s, d).to(x.dtype), aux_d
