"""llama3.2-3b [hf:meta-llama/Llama-3.2-1B-family; unverified]:
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, SwiGLU, RoPE,
tied embeddings (the numbers of ``repro.configs.llama3_2_3b``)."""

import dataclasses

from repro_torch.configs.base import FSDP_TRAIN_OVERRIDES, ArchSpec, lm_shapes
from repro_torch.models.transformer import LM_PARAM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=128256,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab=512,
)

SPEC = ArchSpec(
    arch_id="llama3.2-3b",
    family="lm",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=LM_PARAM_RULES,
    shapes=lm_shapes(
        long_skip_reason=(
            "pure full-attention arch: 524k-token KV with quadratic attention "
            "is excluded per assignment (see DESIGN.md long_500k skips)"
        )
    ),
    rule_overrides=FSDP_TRAIN_OVERRIDES,
    notes="tied embeddings; GQA 24/8; uneven heads4 sharding (24 -> 32 pad)",
)
