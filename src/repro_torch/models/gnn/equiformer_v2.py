"""EquiformerV2-style equivariant graph attention (arXiv:2306.12059),
counterpart of ``repro.models.gnn.equiformer_v2``: node features are
spherical channels (l <= l_max=6 -> 49 components) x C; messages apply
eSCN-style m-restricted SO(2) channel mixing (|m| <= m_max=2) with radial
modulation, edge attention (8 heads) and segment-sum aggregation.  As in
the reference, the SO(2) restriction is applied in the global frame for
l >= 2 (exact edge alignment only for l in {0, 1}).

The SO(2) weights are head-block-diagonal, so the per-edge scalars
(attention, radial gate) commute with the mixing, and the mixing runs on
the aggregated node features:

    sum_e alpha_eh gate_ej (X_src_e W_h) == (sum_e alpha_eh gate_ej X_src_e) W_h

Per edge that leaves a gather-scale-scatter of [E, n_sh, C]; the matmuls
are [N, ...].  Where the reference writes into slices (``.at[...].set``,
``.at[...].add``), the port builds new tensors (``torch.cat``,
``index_copy``): no tensor that autograd saved is written in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.sharding.local import (
    fsdp_weight, index_select, is_dtensor, merge_dims, split_dim,
)
from repro_torch.sharding.local import index_copy as sharded_index_copy

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.common import (
    dense,
    dense_init,
    gather,
    l2_loss,
    mlp,
    mlp_init,
    segment_softmax,
    segment_sum,
    silu,
    softmax_cross_entropy,
    tree_from_reference,
)
from repro_torch.models.gnn.mace import bessel_basis
from repro_torch.sharding.rules import shard


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    r_cut: float = 6.0
    d_in: int = 16
    n_classes: int = 0
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_sh(self) -> int:
        return (self.l_max + 1) ** 2


EQ2_PARAM_RULES = [
    (r".*(radial|attn_mlp|update|readout|embed).*/w", ("fsdp", "tp")),
    (r".*/b", (None,)),
    (r".*so2_m\d+_(r|i|0)", (None, None, "tp")),
]


def _sh_index(l: int, m: int) -> int:
    return l * l + l + m


def _m_slices(l_max: int, m_max: int) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """For each m in 0..m_max: (m, flat idx of (l, +m), flat idx of (l, -m))."""
    out = []
    for m in range(0, m_max + 1):
        ls = np.arange(max(m, 0), l_max + 1)
        if m == 0:
            idx = np.asarray([_sh_index(l, 0) for l in ls])
            out.append((m, idx, idx))
        else:
            out.append(
                (
                    m,
                    np.asarray([_sh_index(l, m) for l in ls]),
                    np.asarray([_sh_index(l, -m) for l in ls]),
                )
            )
    return out


def _row_slice_map(l_max: int, m_max: int) -> np.ndarray:
    """int32[n_sh]: which radial-gate slice modulates each (l, m) row;
    -1 = row does not participate in SO(2) mixing (pass-through)."""
    n_sh = (l_max + 1) ** 2
    out = np.full(n_sh, -1, np.int32)
    for j, (m, idx_p, idx_n) in enumerate(_m_slices(l_max, m_max)):
        out[idx_p] = j
        out[idx_n] = j
    return out


def init_params(cfg: EquiformerV2Config, generator: torch.Generator, device: Device = None):
    """f32 parameters drawn from ``generator`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    c = cfg.d_hidden
    h = cfg.n_heads
    ch = c // h
    slices = _m_slices(cfg.l_max, cfg.m_max)

    def normal(shape, std):
        t = torch.empty(shape, device=dev)
        return t.normal_(0.0, 1.0, generator=generator).mul_(std)

    with torch.no_grad():
        params = {"embed": {"layer0": dense_init(generator, cfg.d_in, c, bias=True,
                                                 device=dev)}}
        for i in range(cfg.n_layers):
            layer = {
                "radial": mlp_init(generator, [cfg.n_rbf, 64, len(slices)], device=dev),
                "attn_mlp": mlp_init(generator, [2 * c + cfg.n_rbf, c, cfg.n_heads],
                                     device=dev),
                "update": mlp_init(generator, [2 * c, c, c], device=dev),
            }
            for m, idx_p, _ in slices:
                dim = len(idx_p) * ch  # head-block-diagonal: mixes within one head block
                std = 1.0 / np.sqrt(dim)
                if m == 0:
                    layer[f"so2_m{m}_0"] = normal((h, dim, dim), std)
                else:
                    layer[f"so2_m{m}_r"] = normal((h, dim, dim), std)
                    layer[f"so2_m{m}_i"] = normal((h, dim, dim), std)
            params[f"layer{i}"] = layer
        out_d = cfg.n_classes if cfg.n_classes > 0 else 1
        params["readout"] = mlp_init(generator, [c, c, out_d], device=dev)
    return params


def params_from_reference(tree, cfg: EquiformerV2Config, device: Device = None):
    """The reference's parameter tree (numpy arrays) as f32 tensors on
    ``device`` (default: the card)."""
    like = init_params(cfg, torch.Generator(), "meta")
    return tree_from_reference(tree, like, resolve_device(device))


def _so2_mix_nodes(layer, cfg, Z):
    """Head-block-diagonal SO(2) mixing on AGGREGATED node features.

    Z: [N, n_sh, C] (already attention/gate-weighted sums of neighbors).
    Rows outside |m| <= m_max pass through; the mixed rows are put in
    place with ``index_copy`` (out of place).
    """
    cd = cfg.compute_dtype
    n, n_sh, c = Z.shape
    h = cfg.n_heads
    ch = c // h
    rows, mixed = [], []

    def blockify(rows):  # [N, n_l, C] -> [N, H, n_l*ch]
        n_l = rows.shape[1]
        return merge_dims(split_dim(rows, 2, h, ch).permute(0, 2, 1, 3), 2)

    def unblockify(y, n_l):  # [N, H, n_l*ch] -> [N, n_l, C]
        return merge_dims(split_dim(y, 2, n_l, ch).permute(0, 2, 1, 3), 2)

    def mix(s, wgt):  # "nha,hab->nhb"
        return torch.einsum("nha,hab->nhb", s, fsdp_weight(wgt, s, in_dim=1))

    for m, idx_p, idx_n in _m_slices(cfg.l_max, cfg.m_max):
        n_l = len(idx_p)
        ip = torch.as_tensor(idx_p, device=Z.device)
        if m == 0:
            y = mix(blockify(index_select(Z, 1, ip)), layer["so2_m0_0"].to(cd))
            rows.append(idx_p)
            mixed.append(unblockify(y, n_l))
        else:
            sp = blockify(index_select(Z, 1, ip))
            sn = blockify(index_select(Z, 1, torch.as_tensor(idx_n, device=Z.device)))
            wr = layer[f"so2_m{m}_r"].to(cd)
            wi = layer[f"so2_m{m}_i"].to(cd)
            yp = mix(sp, wr) - mix(sn, wi)
            yn = mix(sp, wi) + mix(sn, wr)
            rows += [idx_p, idx_n]
            mixed += [unblockify(yp, n_l), unblockify(yn, n_l)]
    index = torch.as_tensor(np.concatenate(rows), device=Z.device)
    if is_dtensor(Z):
        return sharded_index_copy(Z, 1, index, torch.cat(mixed, dim=1))
    return Z.index_copy(1, index, torch.cat(mixed, dim=1))


def forward(params, cfg: EquiformerV2Config, batch):
    """batch = {features [N,F], positions [N,3], src, dst, edge_mask [E]}."""
    cd = cfg.compute_dtype
    n = batch["features"].shape[0]
    c = cfg.d_hidden
    h0 = dense(params["embed"]["layer0"], batch["features"].to(cd), cd)  # [N, C]
    X = torch.cat([h0[:, None, :], h0.new_zeros((n, cfg.n_sh - 1, c))], dim=1)
    x = batch["positions"].float()
    src, dst = batch["src"], batch["dst"]
    w = batch["edge_mask"].float()

    rij = gather(x, dst) - gather(x, src)
    r = torch.linalg.vector_norm(rij + 1e-12, dim=-1)
    rbf = (bessel_basis(r, cfg.n_rbf, cfg.r_cut) * w[:, None]).to(cd)  # [E, n_rbf]
    ch_per_head = c // cfg.n_heads
    row_slice = torch.as_tensor(_row_slice_map(cfg.l_max, cfg.m_max), device=X.device)
    passes = row_slice < 0  # [n_sh]: rows outside the SO(2) mixing
    edge_live = w[:, None] > 0

    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        X = shard(X, "nodes", None, None)
        radial_gate = mlp(p["radial"], rbf, act=silu, compute_dtype=cd)

        # Edge attention from the invariant (l=0) channels, per head.
        s0 = X[:, 0, :]
        scores = mlp(
            p["attn_mlp"], torch.cat([gather(s0, dst), gather(s0, src), rbf], -1),
            act=silu, compute_dtype=cd,
        ).float()  # [E, H]
        scores = torch.where(edge_live, scores, torch.full_like(scores, float("-inf")))
        alpha = segment_softmax(scores, dst, n)  # [E, H]
        alpha = (alpha * w[:, None]).to(cd)

        # Per-edge scalars commute with the head-block-diagonal SO(2) mix,
        # so weight at the EDGE, mix at the NODE (see module docstring).
        a_ch = alpha.repeat_interleave(ch_per_head, dim=1)  # [E, C]
        gate = index_select(radial_gate, 1, row_slice.clamp_min(0))  # [E, n_sh]
        row_gate = torch.where(passes, torch.ones_like(gate), gate)
        Xs = gather(X, src)  # [E, n_sh, C]  (read-once gather)
        weighted = Xs * row_gate[..., None] * a_ch[:, None, :]
        Z = shard(segment_sum(weighted, dst, n), "nodes", None, None)  # [N, n_sh, C]
        agg = _so2_mix_nodes(p, cfg, Z)  # [N, n_sh, C] node-side matmuls

        # Node update: equivariant residual + invariant-gated MLP on l=0.
        X = X + agg
        s = torch.cat([X[:, 0, :], agg[:, 0, :]], -1)
        u = mlp(p["update"], s, act=silu, compute_dtype=cd)
        X = torch.cat([(X[:, 0, :] + u)[:, None, :], X[:, 1:, :]], dim=1)
        # Per-l RMS normalization (keeps deep stacks stable).
        X32 = X.float()
        norm = torch.sqrt(X32.square().mean(dim=(1, 2), keepdim=True) + 1e-6)
        X = (X32 / norm).to(cd)
    return X


def loss_energy(params, cfg: EquiformerV2Config, batch):
    X = forward(params, cfg, batch)
    e_node = mlp(params["readout"], X[:, 0, :], act=silu, compute_dtype=cfg.compute_dtype)
    e = segment_sum(e_node[:, 0].float(), batch["graph_ids"], batch["graph_labels"].shape[0])
    return l2_loss(e, batch["graph_labels"])


def loss_node_class(params, cfg: EquiformerV2Config, batch):
    X = forward(params, cfg, batch)
    logits = mlp(params["readout"], X[:, 0, :], act=silu, compute_dtype=cfg.compute_dtype)
    return softmax_cross_entropy(logits.float(), batch["labels"], batch.get("train_mask"))
