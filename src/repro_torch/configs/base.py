"""ArchSpec: one record per architecture (counterpart of
``repro.configs.base``): model config, reduced smoke config, sharding rules
(read by ``launch/cells.py`` through ``sharding/rules.py``) and the arch's
input-shape set."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture."""

    name: str
    kind: str  # train | prefill | decode | decode_long | peel | peel_sketched |
    #            full_train | sampled_train | molecule_train | serve | retrieval
    params: Mapping[str, Any]
    skip_reason: Optional[str] = None  # non-None => documented skip


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | densest
    config: Any
    reduced_config: Any
    param_rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]]
    shapes: Mapping[str, ShapeSpec]
    # Extra logical-axis rules overriding the family defaults, per shape kind.
    rule_overrides: Mapping[str, Mapping[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items() if v.skip_reason is None}


def lm_shapes(long_skip_reason: Optional[str]) -> Dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        "prefill_32k": ShapeSpec(
            "prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)
        ),
        "decode_32k": ShapeSpec(
            "decode_32k", "decode", dict(seq_len=32768, global_batch=128)
        ),
        "long_500k": ShapeSpec(
            "long_500k",
            "decode_long",
            dict(seq_len=524288, global_batch=1),
            skip_reason=long_skip_reason,
        ),
    }


def gnn_shapes(d_feat_defaults: Mapping[str, int]) -> Dict[str, ShapeSpec]:
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm",
            "full_train",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
        ),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg",
            "sampled_train",
            dict(
                n_nodes=232_965,
                n_edges=114_615_892,
                batch_nodes=1024,
                fanout=(15, 10),
                d_feat=602,
                n_classes=41,
            ),
        ),
        "ogb_products": ShapeSpec(
            "ogb_products",
            "full_train",
            dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47),
        ),
        "molecule": ShapeSpec(
            "molecule",
            "molecule_train",
            dict(n_nodes=30, n_edges=64, batch=128, d_feat=d_feat_defaults.get("molecule", 16)),
        ),
    }


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", dict(batch=65_536)),
        "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262_144)),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
        ),
    }


# The reference's training override (pure FSDP over every chip), as data.
FSDP_TRAIN_OVERRIDES = {
    "train": {
        "batch": ("data", "model"), "fsdp": ("data", "model"),
        "tp": None, "heads4": None, "kv_heads": None, "heads": None,
        "mlp": None, "vocab": None, "embed": None, "seq": None,
    },
}
