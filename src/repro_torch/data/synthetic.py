"""Concrete synthetic batches (counterpart of ``repro.data.synthetic``) of
the LM, GNN and recsys families, for smoke tests, examples, training runs
and the card's full-size cells.  The numbers are numpy's, drawn in the
reference's call order, so every array equals the reference's bit for bit;
only then do they become tensors on ``device`` (default: the card)."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.graph.edgelist import Device, resolve_device


def lm_train_batch(rng: np.random.Generator, vocab: int, batch: int, seq: int,
                   device: Device = None) -> Dict[str, torch.Tensor]:
    """Uniform tokens: ``{"tokens", "labels"}`` int32 ``[batch, seq]``."""
    dev = resolve_device(device)
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    return {
        "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
        "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
    }


def _tensors(arrays: Dict[str, np.ndarray], device: Device) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_full_batch(rng: np.random.Generator, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, with_positions: bool, device: Device = None):
    """One graph, uniform random edges: ``{features [N,F], src, dst,
    edge_mask (src != dst), labels, train_mask (half the nodes)}`` and
    ``positions [N,3]`` for the geometric archs."""
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    b = {
        "features": rng.standard_normal((n_nodes, d_feat), dtype=np.float32),
        "src": src,
        "dst": dst,
        "edge_mask": src != dst,
        "labels": rng.integers(0, max(n_classes, 2), n_nodes, dtype=np.int32),
        "train_mask": (rng.random(n_nodes) < 0.5).astype(np.float32),
    }
    if with_positions:
        b["positions"] = rng.standard_normal((n_nodes, 3), dtype=np.float32) * 2.0
    return _tensors(b, device)


def gnn_molecule_batch(rng: np.random.Generator, batch: int, nodes_per: int, edges_per: int,
                       d_feat: int, with_positions: bool, device: Device = None):
    """``batch`` small graphs in one edge list (each molecule's edges stay
    inside its node block): ``{features, src, dst, edge_mask, graph_ids,
    graph_labels [batch]}`` (+ ``positions``)."""
    n = batch * nodes_per
    e = batch * edges_per
    graph_of_edge = np.repeat(np.arange(batch), edges_per)
    src = (rng.integers(0, nodes_per, e) + graph_of_edge * nodes_per).astype(np.int32)
    dst = (rng.integers(0, nodes_per, e) + graph_of_edge * nodes_per).astype(np.int32)
    b = {
        "features": rng.standard_normal((n, d_feat), dtype=np.float32),
        "src": src,
        "dst": dst,
        "edge_mask": src != dst,
        "graph_ids": np.repeat(np.arange(batch), nodes_per).astype(np.int32),
        "graph_labels": rng.standard_normal(batch).astype(np.float32),
    }
    if with_positions:
        b["positions"] = rng.standard_normal((n, 3), dtype=np.float32) * 2.0
    return _tensors(b, device)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def recsys_train_batch(rng: np.random.Generator, cfg, batch: int, device: Device = None):
    """``{user_id, hist [B,H], hist_mask (70% set), item_id, logq}``: the
    logQ correction of a Zipf-like (exponent 0.9) item popularity."""
    h = cfg.hist_len
    ranks = rng.integers(1, cfg.n_items, size=(batch,))
    q = 1.0 / (np.asarray(ranks, np.float64) ** 0.9)
    return _tensors({
        "user_id": rng.integers(0, cfg.n_users, batch, dtype=np.int32),
        "hist": rng.integers(0, cfg.n_items, (batch, h), dtype=np.int32),
        "hist_mask": (rng.random((batch, h)) < 0.7).astype(np.float32),
        "item_id": rng.integers(0, cfg.n_items, batch, dtype=np.int32),
        "logq": np.log(q / q.sum()).astype(np.float32),
    }, device)


_GEOMETRIC = {"mace", "egnn", "equiformer-v2"}


def _gnn_needs_positions(arch_id: str) -> bool:
    return arch_id in _GEOMETRIC


def make_batch(spec: ArchSpec, shape_kind: str, *, reduced_shape: Mapping[str, Any],
               seed: int = 0, device: Device = None) -> Dict[str, Any]:
    """A concrete batch of ``spec``'s reduced config: the same layout as the
    full shape, reduced sizes."""
    rng = np.random.default_rng(seed)
    p = dict(reduced_shape)
    if spec.family == "lm":
        cfg = spec.reduced_config
        if shape_kind == "train":
            return lm_train_batch(rng, cfg.vocab, p["global_batch"], p["seq_len"], device)
        if shape_kind == "prefill":
            t = rng.integers(0, cfg.vocab, (p["global_batch"], p["seq_len"]), dtype=np.int32)
            return {"tokens": torch.from_numpy(t).to(resolve_device(device))}
        raise ValueError(shape_kind)
    if spec.family == "gnn":
        pos = _gnn_needs_positions(spec.arch_id)
        if shape_kind == "full_train":
            return gnn_full_batch(rng, p["n_nodes"], p["n_edges"], p["d_feat"], p["n_classes"],
                                  pos, device)
        if shape_kind == "molecule_train":
            return gnn_molecule_batch(rng, p["batch"], p["n_nodes"], p["n_edges"], p["d_feat"],
                                      pos, device)
        raise ValueError(shape_kind)
    if spec.family == "recsys":
        return recsys_train_batch(rng, spec.reduced_config, p["batch"], device)
    raise ValueError(spec.family)
