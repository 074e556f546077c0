"""EGNN, the E(n)-equivariant graph network (Satorras et al.,
arXiv:2102.09844), counterpart of ``repro.models.gnn.egnn``.

Exactly the paper's layer:
  m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
  x_i'  = x_i + C * sum_j (x_i - x_j) phi_x(m_ij)
  h_i'  = phi_h(h_i, sum_j m_ij)

The coordinates and their update stay f32; only the MLPs run in
``compute_dtype``.  Equivariance is exact and property-tested
(tests/test_torch_gnn.py).  One deviation: the distance's square root has
a zero gradient at a masked self-loop (:func:`_sqrt0`), where the
reference's gradient is NaN; the forward is the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.common import (
    dense,
    dense_init,
    gather,
    l2_loss,
    mlp,
    mlp_init,
    segment_sum,
    silu,
    softmax_cross_entropy,
    tree_from_reference,
)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_in: int = 64
    d_hidden: int = 64
    n_classes: int = 0  # 0 => energy regression readout
    compute_dtype: torch.dtype = torch.bfloat16


EGNN_PARAM_RULES = [
    (r".*(phi_e|phi_h|phi_x|readout|embed)/layer\d+/w", ("fsdp", "tp")),
    (r".*/b", (None,)),
]


def init_params(cfg: EGNNConfig, generator: torch.Generator, device: Device = None):
    """f32 parameters drawn from ``generator`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    with torch.no_grad():
        params = {"embed": {"layer0": dense_init(generator, cfg.d_in, d, bias=True,
                                                 device=dev)}}
        for i in range(cfg.n_layers):
            params[f"layer{i}"] = {
                "phi_e": mlp_init(generator, [2 * d + 1, d, d], device=dev),
                "phi_x": mlp_init(generator, [d, d, 1], device=dev),
                "phi_h": mlp_init(generator, [2 * d, d, d], device=dev),
            }
        out_d = cfg.n_classes if cfg.n_classes > 0 else 1
        params["readout"] = mlp_init(generator, [d, d, out_d], device=dev)
    return params


def params_from_reference(tree, cfg: EGNNConfig, device: Device = None):
    """The reference's parameter tree (numpy arrays) as f32 tensors on
    ``device`` (default: the card)."""
    like = init_params(cfg, torch.Generator(), "meta")
    return tree_from_reference(tree, like, resolve_device(device))


def _sqrt0(d2: torch.Tensor) -> torch.Tensor:
    """``sqrt(d2)``, the same values, with a zero gradient where d2 == 0.
    A masked self-loop has rij = 0 and d2 = 0, where sqrt's gradient is
    infinite; times rij's zero it is NaN.  From the third layer on the
    coordinates depend on the parameters, so the reference's
    ``jnp.sqrt(d2)`` turns every earlier leaf's gradient into NaN at its
    published 4 layers on any batch with a self-loop."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def forward(params, cfg: EGNNConfig, batch):
    """batch = {features [N,F], positions [N,3], src, dst, edge_mask [E]}.

    Returns (h [N,d], x [N,3]) after all layers.
    """
    cd = cfg.compute_dtype
    h = dense(params["embed"]["layer0"], batch["features"].to(cd), cd)
    x = batch["positions"].float()
    src, dst = batch["src"], batch["dst"]
    w = batch["edge_mask"].float()
    n = h.shape[0]

    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        hi = gather(h, dst)
        hj = gather(h, src)
        rij = gather(x, dst) - gather(x, src)  # [E, 3]
        d2 = (rij * rij).sum(-1, keepdim=True)
        m = mlp(p["phi_e"], torch.cat([hi, hj, d2.to(cd)], -1), act=silu,
                compute_dtype=cd, final_act=True)
        m = m * w[:, None].to(cd)
        # Coordinate update (float32 for stability, normalized by distance).
        coef = mlp(p["phi_x"], m, act=silu, compute_dtype=cd).float()
        upd = rij / (_sqrt0(d2) + 1.0) * coef * w[:, None]
        x = x + segment_sum(upd, dst, n) / (segment_sum(w, dst, n)[:, None] + 1.0)
        # Feature update.
        agg = segment_sum(m, dst, n)
        h = h + mlp(p["phi_h"], torch.cat([h, agg], -1), act=silu, compute_dtype=cd)
    return h, x


def readout_energy(params, cfg: EGNNConfig, h, graph_ids, n_graphs):
    e_node = mlp(params["readout"], h, act=silu, compute_dtype=cfg.compute_dtype)
    return segment_sum(e_node[:, 0].float(), graph_ids, n_graphs)


def loss_energy(params, cfg: EGNNConfig, batch):
    h, _ = forward(params, cfg, batch)
    e = readout_energy(params, cfg, h, batch["graph_ids"], batch["graph_labels"].shape[0])
    return l2_loss(e, batch["graph_labels"])


def loss_node_class(params, cfg: EGNNConfig, batch):
    h, _ = forward(params, cfg, batch)
    logits = mlp(params["readout"], h, act=silu, compute_dtype=cfg.compute_dtype)
    return softmax_cross_entropy(logits.float(), batch["labels"], batch.get("train_mask"))
