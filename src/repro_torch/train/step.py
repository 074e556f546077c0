"""Per-family step helpers (counterpart of ``repro.train.step``): the LM
branch of ``init_model_params``.  The GNN and recsys families, the losses
and the AdamW train step are ROADMAP Queue 1, item 12."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.graph.edgelist import Device


def init_model_params(spec: ArchSpec, generator: torch.Generator, cfg=None,
                      device: Device = None):
    """Parameters of ``spec`` (or of ``cfg``, e.g. its reduced config) drawn
    from ``generator`` on ``device`` (default: the card)."""
    cfg = cfg if cfg is not None else spec.config
    if spec.family == "lm":
        from repro_torch.models.transformer import init_params

        return init_params(cfg, generator, device)
    raise NotImplementedError(
        f"family {spec.family!r}: only the LM family is ported (ROADMAP Queue 1 item 12)"
    )
