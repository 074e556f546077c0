"""starcoder2-7b [arXiv:2402.19173]: 32L d_model=4608 36H (GQA kv=4)
d_ff=18432 vocab=49152, GELU MLP, LayerNorm, qkv-bias, RoPE (the numbers of
``repro.configs.starcoder2_7b``)."""

import dataclasses

from repro_torch.configs.base import FSDP_TRAIN_OVERRIDES, ArchSpec, lm_shapes
from repro_torch.models.transformer import LM_PARAM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="starcoder2-7b",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_head=128,
    d_ff=18432,
    vocab=49152,
    mlp_type="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=100_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=144, n_heads=6, n_kv_heads=2, d_head=24,
    d_ff=288, vocab=512,
)

SPEC = ArchSpec(
    arch_id="starcoder2-7b",
    family="lm",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=LM_PARAM_RULES,
    shapes=lm_shapes(
        long_skip_reason=(
            "pure full-attention arch (assigned config): 524k decode excluded; "
            "see DESIGN.md long_500k skips"
        )
    ),
    rule_overrides=FSDP_TRAIN_OVERRIDES,
    notes="GELU MLP + LayerNorm + qkv bias per StarCoder2",
)
