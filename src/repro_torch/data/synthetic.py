"""Concrete synthetic batches (counterpart of ``repro.data.synthetic``):
the LM family's, for smoke tests, examples and CPU training runs.  The
numbers are numpy's, drawn as the reference draws them; the tensors go to
``device`` (default: the card).  The GNN and recsys families' batches come
with those families (ROADMAP Queue 1 item 12.2)."""

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


def make_batch(spec: ArchSpec, shape_kind: str, *, reduced_shape: Mapping[str, Any],
               seed: int = 0, device: Device = None) -> Dict[str, Any]:
    """A concrete batch of ``spec``'s reduced config: the same layout as the
    full shape, reduced sizes."""
    rng = np.random.default_rng(seed)
    p = dict(reduced_shape)
    if spec.family != "lm":
        raise NotImplementedError(
            f"family {spec.family!r}: only the LM family is ported (ROADMAP Queue 1 item 12.2)")
    cfg = spec.reduced_config
    if shape_kind == "train":
        return lm_train_batch(rng, cfg.vocab, p["global_batch"], p["seq_len"], device)
    if shape_kind == "prefill":
        t = rng.integers(0, cfg.vocab, (p["global_batch"], p["seq_len"]), dtype=np.int32)
        return {"tokens": torch.from_numpy(t).to(resolve_device(device))}
    raise ValueError(shape_kind)
