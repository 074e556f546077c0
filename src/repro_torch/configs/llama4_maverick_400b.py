"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family; unverified]:
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 (17B active) (the numbers of ``repro.configs.llama4_maverick_400b``;
its modality frontend is a stub there as here: tokens in)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LM_PARAM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=202048,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25, group_size=1024),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=1, capacity_factor=1.5, group_size=64),
)

SPEC = ArchSpec(
    arch_id="llama4-maverick-400b-a17b",
    family="lm",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=LM_PARAM_RULES,
    shapes=lm_shapes(
        long_skip_reason=(
            "assigned config is full-attention (iRoPE chunked-attention "
            "variant not part of the assigned spec): 524k decode excluded; "
            "see DESIGN.md"
        )
    ),
    # The reference's override, as data: 128 experts over the data axis.
    rule_overrides={"*": {"expert": ("data",)}},
    notes="EP over data axis (128 experts), int8 Adam moments to fit HBM",
)
