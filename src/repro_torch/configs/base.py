"""ArchSpec: one record per architecture (counterpart of
``repro.configs.base``): model config, reduced smoke config, sharding rules
(data, unused until the mesh slice) and the arch's input-shape set."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture."""

    name: str
    kind: str  # train | prefill | decode | decode_long | peel | peel_sketched
    params: Mapping[str, Any]
    skip_reason: Optional[str] = None  # non-None => documented skip


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | densest
    config: Any
    reduced_config: Any
    param_rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]]
    shapes: Mapping[str, ShapeSpec]
    # Extra logical-axis rules overriding the family defaults, per shape kind.
    rule_overrides: Mapping[str, Mapping[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    notes: str = ""


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


# The reference's training override (pure FSDP over every chip), as data.
FSDP_TRAIN_OVERRIDES = {
    "train": {
        "batch": ("data", "model"), "fsdp": ("data", "model"),
        "tp": None, "heads4": None, "kv_heads": None, "heads": None,
        "mlp": None, "vocab": None, "embed": None, "seq": None,
    },
}
