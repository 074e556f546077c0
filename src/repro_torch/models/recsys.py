"""Two-tower retrieval model (YouTube, RecSys'19 style), counterpart of
``repro.models.recsys``: large embedding tables -> towers -> dot
interaction -> in-batch sampled softmax with logQ correction.

The tables are plain f32 tensors.  The bags are built as the reference
builds them, from a row gather and a segment reduce (ragged path) or a
masked mean (fixed-width path).  A table's gradient is dense, as the
reference's ``jnp.take`` gradient is; but the backward of a gather
(:class:`_TableRows`) hands autograd only the gathered rows (a sparse COO
tensor), which the train step's preset dense gradient buffer adds up in
place: no second table-sized buffer appears.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.common import (
    mlp,
    mlp_init,
    segment_max,
    segment_sum,
    tree_from_reference,
)
from repro_torch.sharding.local import is_dtensor, take_last, whole_last
from repro_torch.sharding.local import take_rows as sharded_take_rows
from repro_torch.sharding.rules import shard


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users: int = 8_388_608  # 2^23
    n_items: int = 2_097_152  # 2^21
    embed_dim: int = 256
    tower_dims: Tuple[int, ...] = (1024, 512, 256)
    hist_len: int = 32
    temperature: float = 0.05
    compute_dtype: torch.dtype = torch.bfloat16


TWO_TOWER_PARAM_RULES = [
    (r"(user|item)_table", ("fsdp", "tp")),
    (r"(user|item)_tower/layer\d+/w", ("fsdp", "tp")),
    (r".*/b", (None,)),
]


def init_params(cfg: TwoTowerConfig, generator: torch.Generator, device: Device = None):
    """f32 parameters drawn from ``generator`` on ``device`` (default: the
    card): tables at std 0.02, the towers' dense layers as ``mlp_init``."""
    dev = resolve_device(device)
    d = cfg.embed_dim

    def table(rows):
        t = torch.empty((rows, d), device=dev)
        return t.normal_(0.0, 1.0, generator=generator).mul_(0.02)

    with torch.no_grad():
        return {
            "user_table": table(cfg.n_users),
            "item_table": table(cfg.n_items),
            "user_tower": mlp_init(generator, [2 * d, *cfg.tower_dims], device=dev),
            "item_tower": mlp_init(generator, [d, *cfg.tower_dims], device=dev),
        }


def params_from_reference(tree, cfg: TwoTowerConfig, device: Device = None):
    """The reference's parameter tree (numpy arrays) as f32 tensors on
    ``device`` (default: the card)."""
    like = init_params(cfg, torch.Generator(), "meta")
    return tree_from_reference(tree, like, resolve_device(device))


class _TableRows(torch.autograd.Function):
    """``table[ids]`` whose backward is the sparse COO tensor of the
    gathered rows' gradients: added to a dense ``.grad`` it is an
    ``index_add_`` in place."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows = grad.reshape(-1, ctx.shape[1])
        return torch.sparse_coo_tensor(ids[None], rows, ctx.shape, check_invariants=False), None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for ids of any shape: ``ids.shape +
    table.shape[1:]``."""
    if is_dtensor(table):
        return sharded_take_rows(table, ids)
    rows = _TableRows.apply(table, ids.reshape(-1).long())
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


# ----------------------------- EmbeddingBag ---------------------------------


def embedding_bag_ragged(
    table: torch.Tensor,  # [V, D]
    flat_ids: torch.Tensor,  # int[T] concatenated bag members
    bag_ids: torch.Tensor,  # int[T] which bag each member belongs to
    n_bags: int,
    mode: str = "mean",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``torch.nn.EmbeddingBag``'s function: ragged gather + segment reduce
    (an empty bag is 0 in sum and mean, -inf in max)."""
    rows = take_rows(table, flat_ids)
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, bag_ids, n_bags)
    if mode == "mean":
        s = segment_sum(rows, bag_ids, n_bags)
        cnt = segment_sum(torch.ones(flat_ids.shape, dtype=rows.dtype, device=rows.device),
                          bag_ids, n_bags)
        return s / cnt.clamp_min(1.0)[:, None]
    if mode == "max":
        return segment_max(rows, bag_ids, n_bags)
    raise ValueError(mode)


def embedding_bag_padded(
    table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, mode: str = "mean"
) -> torch.Tensor:
    """Fixed-width bags: ids [B, H], mask [B, H] -> [B, D]."""
    rows = take_rows(table, ids)  # [B, H, D]
    m = mask.to(rows.dtype)[..., None]
    if mode == "sum":
        return (rows * m).sum(1)
    if mode == "mean":
        return (rows * m).sum(1) / m.sum(1).clamp_min(1.0)
    raise ValueError(mode)


# ------------------------------- towers -------------------------------------


def _unit(v: torch.Tensor) -> torch.Tensor:
    v = v.float()
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-6)


def user_embedding(params, cfg: TwoTowerConfig, user_id, hist, hist_mask):
    cd = cfg.compute_dtype
    ue = take_rows(params["user_table"], user_id)  # [B, D]
    hb = embedding_bag_padded(params["item_table"], hist, hist_mask, "mean")
    z = shard(torch.cat([ue, hb], dim=-1).to(cd), "batch", None)
    return _unit(mlp(params["user_tower"], z, act=torch.relu, compute_dtype=cd))


def item_embedding(params, cfg: TwoTowerConfig, item_id):
    cd = cfg.compute_dtype
    z = shard(take_rows(params["item_table"], item_id).to(cd), "batch", None)
    return _unit(mlp(params["item_tower"], z, act=torch.relu, compute_dtype=cd))


def loss_in_batch_softmax(params, cfg: TwoTowerConfig, batch):
    """Sampled softmax over in-batch negatives with logQ correction."""
    u = user_embedding(params, cfg, batch["user_id"], batch["hist"], batch["hist_mask"])
    v = item_embedding(params, cfg, batch["item_id"])
    logits = shard((u @ v.T) / cfg.temperature, "batch", "vocab")  # [B, B]
    logits = logits - batch["logq"][None, :]  # logQ correction
    labels = torch.arange(logits.shape[0], device=logits.device)
    if is_dtensor(logits):  # each device its rows' diagonal entries
        logits = whole_last(logits)
        ll = take_last(logits, labels)
    else:
        ll = logits.diagonal()
    lse = torch.logsumexp(logits, dim=-1)
    loss = (lse - ll).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "in_batch_acc": acc}


def serve_scores(params, cfg: TwoTowerConfig, batch):
    """Online/offline pairwise scoring: one score per (user, item) row."""
    u = user_embedding(params, cfg, batch["user_id"], batch["hist"], batch["hist_mask"])
    v = item_embedding(params, cfg, batch["item_id"])
    return (u * v).sum(-1) / cfg.temperature


def retrieval_topk(params, cfg: TwoTowerConfig, batch, k: int = 100):
    """One query scored against a large candidate set: one matmul and a
    top-k (not a loop), as the retrieval_cand shape requires."""
    u = user_embedding(params, cfg, batch["user_id"], batch["hist"], batch["hist_mask"])  # [1, D]
    v = shard(item_embedding(params, cfg, batch["cand_ids"]), "vocab", None)  # [Ncand, D]
    scores = (u @ v.T)[0] / cfg.temperature  # [Ncand]
    return torch.topk(scores, k)
