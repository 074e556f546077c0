"""GraphSAGE (mean aggregator), full-batch (edge-list segment mean) and
sampled-minibatch (layered fanout blocks from ``graph/sampler.py``) paths
(counterpart of ``repro.models.gnn.graphsage``).

The full-batch path is the same gather -> segment-reduce substrate as the
densest-subgraph core: each layer's segment mean is
``common.gather_segment_sum`` (the source rows gathered, scaled by the
edge mask and summed over the destinations in chunks of edges, into an f32
accumulator) over the destinations' edge counts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.common import (
    dense,
    dense_init,
    gather_segment_sum,
    l2_loss,
    segment_mean,
    segment_sum,
    softmax_cross_entropy,
    tree_from_reference,
)


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    fanouts: Tuple[int, ...] = (15, 10)
    compute_dtype: torch.dtype = torch.bfloat16


SAGE_PARAM_RULES = [
    (r"layer\d+/(w_self|w_neigh)/w", ("fsdp", "tp")),
    (r"head/w", ("fsdp", "tp")),
    (r".*/b", (None,)),
]


def _out_dim(cfg: SAGEConfig) -> int:
    return cfg.n_classes if cfg.n_classes > 0 else 1  # 0 => regression head


def init_params(cfg: SAGEConfig, generator: torch.Generator, device: Device = None):
    """f32 parameters drawn from ``generator`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    params = {}
    d = cfg.d_in
    with torch.no_grad():
        for i in range(cfg.n_layers):
            params[f"layer{i}"] = {
                "w_self": dense_init(generator, d, cfg.d_hidden, bias=True, device=dev),
                "w_neigh": dense_init(generator, d, cfg.d_hidden, device=dev),
            }
            d = cfg.d_hidden
        params["head"] = dense_init(generator, d, _out_dim(cfg), bias=True, device=dev)
    return params


def params_from_reference(tree, cfg: SAGEConfig, device: Device = None):
    """The reference's parameter tree (numpy arrays) as f32 tensors on
    ``device`` (default: the card)."""
    like = init_params(cfg, torch.Generator(), "meta")
    return tree_from_reference(tree, like, resolve_device(device))


def _sage_layer(p, h_self, h_neigh_mean, cd, act=True):
    y = dense(p["w_self"], h_self, cd) + dense(p["w_neigh"], h_neigh_mean, cd)
    return torch.relu(y) if act else y


def forward_full(params, cfg: SAGEConfig, batch):
    """Full-batch: batch = {features [N,F], src, dst, edge_mask}."""
    cd = cfg.compute_dtype
    h = batch["features"].to(cd)
    n = h.shape[0]
    src, dst = batch["src"], batch["dst"]
    w = batch["edge_mask"].to(cd)
    # segment_mean's count: every edge, the masked ones too, as the reference's.
    cnt = segment_sum(torch.ones(src.shape, dtype=cd, device=h.device), dst, n)
    for i in range(cfg.n_layers):
        agg = gather_segment_sum(h, src, dst, w, n) / cnt.clamp_min(1.0)[:, None]
        h = _sage_layer(params[f"layer{i}"], h, agg, cd)
    return dense(params["head"], h, cd).float()


def forward_sampled(params, cfg: SAGEConfig, batch):
    """Minibatch: layered fanout gathers (GraphSAGE's own sampling scheme).

    batch = {feat_table [N,F], hop0 [R], hop1 [R,f1], hop2 [R,f1,f2],
             hop1_mask, hop2_mask, labels [R]}
    """
    cd = cfg.compute_dtype
    ft = batch["feat_table"]
    f0 = ft[batch["hop0"].long()].to(cd)  # [R, F]
    f1 = ft[batch["hop1"].long()].to(cd)  # [R, f1, F]
    f2 = ft[batch["hop2"].long()].to(cd)  # [R, f1, f2, F]
    m1 = batch["hop1_mask"].to(cd)[..., None]
    m2 = batch["hop2_mask"].to(cd)[..., None]

    def masked_mean(x, m, dim):
        return (x * m).sum(dim) / m.sum(dim).clamp_min(1.0)

    l0 = params["layer0"]
    h1 = _sage_layer(l0, f1, masked_mean(f2, m2, dim=2), cd)  # [R, f1, d]
    h0 = _sage_layer(l0, f0, masked_mean(f1, m1, dim=1), cd)  # [R, d]
    l1 = params["layer1"]
    hr = _sage_layer(l1, h0, masked_mean(h1, m1, dim=1), cd)  # [R, d]
    return dense(params["head"], hr, cd).float()


def loss_full(params, cfg: SAGEConfig, batch):
    logits = forward_full(params, cfg, batch)
    return softmax_cross_entropy(logits, batch["labels"], batch.get("train_mask"))


def loss_sampled(params, cfg: SAGEConfig, batch):
    logits = forward_sampled(params, cfg, batch)
    return softmax_cross_entropy(logits, batch["labels"])


def loss_pooled(params, cfg: SAGEConfig, batch):
    """Batched small graphs (molecule shape): mean-pool per graph, regress."""
    out = forward_full(params, cfg, batch)  # [N, 1]
    n_graphs = batch["graph_labels"].shape[0]
    pooled = segment_mean(out, batch["graph_ids"], n_graphs)[:, 0]
    return l2_loss(pooled, batch["graph_labels"])
