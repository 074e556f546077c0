"""mixtral-8x7b [arXiv:2401.04088]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000, MoE 8 experts top-2, sliding-window attention 4096
(the numbers of ``repro.configs.mixtral_8x7b``).

SWA keeps the decode cache at 4096 slots whatever the context; prefill
runs K4's windowed route under ``attn_impl='pallas'``."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LM_PARAM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25, group_size=1024),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab=512, window=64,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25, group_size=64),
)

SPEC = ArchSpec(
    arch_id="mixtral-8x7b",
    family="lm",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=LM_PARAM_RULES,
    shapes=lm_shapes(long_skip_reason=None),  # SWA => sub-quadratic: runs
    # The reference's logical-axis overrides, as data (unused until the
    # sharding slice): experts replicated with a TP expert FFN; FSDP for
    # training; TP over both axes for batch-1 long decode.
    rule_overrides={
        "*": {"expert": None},
        "train": {
            "batch": ("data", "model"), "fsdp": ("data", "model"),
            "tp": None, "heads4": None, "kv_heads": None, "heads": None,
            "mlp": None, "vocab": None, "embed": None, "seq": None,
            "expert": None, "expert_batch": None,
        },
        "decode_long": {
            "expert": None, "batch": None, "fsdp": None,
            "tp": ("data", "model"), "kv_seq": ("model",),
            "heads": None, "kv_heads": None, "mlp": ("data", "model"),
            "vocab": ("data", "model"),
        },
    },
    notes="SWA 4096 rolling cache; MoE 8e top-2 with TP-sharded experts",
)
