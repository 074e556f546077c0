"""Per-family step functions (counterpart of ``repro.train.step``): the loss
function, the train step (forward, backward, AdamW) and the serve steps of
the LM, GNN and recsys families.

The train step computes gradients with two memory rules that a
3.2 B-parameter model needs on one card (``make_train_step``):

* each stacked leaf (``params["layers"]...``, ``[L, ...]``) is handed to
  the loss as L detached per-layer views that require grad.  Letting
  autograd ``select`` layer i out of one leaf that requires grad would
  write a full-size zero gradient per layer (2.82 GB for llama3.2-3b's
  ``w_gate``);
* every view's ``.grad`` is preset to its slice of one zeroed gradient
  buffer per leaf, so autograd accumulates there in place and the
  gradients are whole leaves again, without a second copy.

AdamW then updates the parameters and moments in place
(``optim.apply_updates``).  The GNN and recsys parameters are not stacked:
each leaf is one view.  A recsys table's gradient arrives as the sparse
rows of its gathers (``models/recsys.py``), added into its preset buffer
in place.
"""

from __future__ import annotations

import dataclasses
import importlib
from functools import partial
from typing import Any, Callable

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ArchSpec
from repro_torch.graph.edgelist import Device
from repro_torch.optim import AdamWConfig, AdamWState, apply_updates

_GNN_MODULES = {
    "graphsage-reddit": "repro_torch.models.gnn.graphsage",
    "mace": "repro_torch.models.gnn.mace",
    "egnn": "repro_torch.models.gnn.egnn",
    "equiformer-v2": "repro_torch.models.gnn.equiformer_v2",
}


def _family_error(spec: ArchSpec) -> ValueError:
    return ValueError(f"family {spec.family!r} has no training step")


def make_loss_fn(spec: ArchSpec, shape_kind: str, cfg=None) -> Callable:
    """``loss(params, batch=...) -> (scalar, metrics)`` for an (arch, shape)."""
    cfg = cfg if cfg is not None else spec.config
    if spec.family == "lm":
        from repro_torch.models.transformer import lm_loss

        return partial(lm_loss, cfg=cfg)
    if spec.family == "gnn":
        m = importlib.import_module(_GNN_MODULES[spec.arch_id])
        if spec.arch_id == "graphsage-reddit":
            table = {
                "full_train": m.loss_full,
                "sampled_train": m.loss_sampled,
                "molecule_train": m.loss_pooled,
            }
            return partial(table[shape_kind], cfg=cfg)
        if shape_kind == "molecule_train":
            return partial(m.loss_energy, cfg=cfg)
        return partial(m.loss_node_class, cfg=cfg)
    if spec.family == "recsys":
        from repro_torch.models.recsys import loss_in_batch_softmax

        return partial(loss_in_batch_softmax, cfg=cfg)
    raise _family_error(spec)


def init_model_params(spec: ArchSpec, generator: torch.Generator, cfg=None,
                      device: Device = None):
    """Parameters of ``spec`` (or of ``cfg``, e.g. its reduced config) drawn
    from ``generator`` on ``device`` (default: the card)."""
    cfg = cfg if cfg is not None else spec.config
    if spec.family == "lm":
        from repro_torch.models.transformer import init_params

        return init_params(cfg, generator, device)
    if spec.family == "gnn":
        return importlib.import_module(_GNN_MODULES[spec.arch_id]).init_params(
            cfg, generator, device)
    if spec.family == "recsys":
        from repro_torch.models.recsys import init_params

        return init_params(cfg, generator, device)
    raise _family_error(spec)


def specialize_gnn_config(cfg, shape_params) -> Any:
    """GNN configs carry d_in/n_classes that depend on the shape's dataset."""
    reps = {}
    if "d_feat" in shape_params:
        reps["d_in"] = shape_params["d_feat"]
    if hasattr(cfg, "n_classes"):
        reps["n_classes"] = shape_params.get("n_classes", 0)
    return dataclasses.replace(cfg, **reps)


def _views(params, grads, stacked: bool = False):
    """``params`` as detached leaves that require grad, each ``.grad``
    preset to its part of ``grads``; a stacked leaf becomes a list of
    per-layer views."""
    if isinstance(params, dict):
        return {k: _views(v, grads[k], stacked or k == "layers") for k, v in params.items()}

    def view(p, g):
        v = p.detach().requires_grad_()
        v.grad = g
        return v

    if stacked:
        return [view(p, g) for p, g in zip(params.unbind(0), grads.unbind(0))]
    return view(params, grads)


def loss_and_grads(loss_fn: Callable, params, batch):
    """``(loss, metrics, grads)``: the loss, its metrics (detached) and the
    gradients as a tree of whole leaves like ``params``."""
    grads = tree_util.tree_map(torch.zeros_like, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(_views(params, grads), batch=batch)
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.  The
    parameters and the optimizer state are updated in place (and returned):
    copy them first to keep the old values."""

    def train_step(params, opt_state: AdamWState, batch):
        _, metrics, grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, om = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_lm_prefill(cfg):
    from repro_torch.models.transformer import prefill

    def step(params, batch):
        logits, cache, cur_len = prefill(params, cfg, batch["tokens"])
        return {"logits": logits, "cache": cache, "cur_len": cur_len}

    return step


def make_lm_decode(cfg):
    from repro_torch.models.transformer import decode_step

    def step(params, cache, batch, cur_len):
        logits, cache, cur_len = decode_step(params, cfg, cache, batch["tokens"], cur_len)
        return {"logits": logits, "next": logits.argmax(-1).to(torch.int32)}, cache, cur_len

    return step


def make_recsys_serve(cfg):
    from repro_torch.models.recsys import serve_scores

    def step(params, batch):
        return serve_scores(params, cfg, batch)

    return step


def make_recsys_retrieval(cfg, k: int = 100):
    from repro_torch.models.recsys import retrieval_topk

    def step(params, batch):
        scores, idx = retrieval_topk(params, cfg, batch, k=k)
        return {"scores": scores, "indices": idx}

    return step
