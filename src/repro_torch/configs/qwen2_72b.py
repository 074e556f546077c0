"""qwen2-72b [arXiv:2407.10671]: 80L d_model=8192 64H (GQA kv=8)
d_ff=29568 vocab=152064, SwiGLU, RMSNorm, QKV bias, RoPE (the numbers of
``repro.configs.qwen2_72b``)."""

import dataclasses

from repro_torch.configs.base import FSDP_TRAIN_OVERRIDES, ArchSpec, lm_shapes
from repro_torch.models.transformer import LM_PARAM_RULES, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    mlp_type="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=384, vocab=512,
)

SPEC = ArchSpec(
    arch_id="qwen2-72b",
    family="lm",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=LM_PARAM_RULES,
    shapes=lm_shapes(
        long_skip_reason=(
            "pure full-attention arch: 524k decode excluded; see DESIGN.md"
        )
    ),
    rule_overrides=FSDP_TRAIN_OVERRIDES,
    notes="64 q heads / 16 = 4 per shard; kv=8 heads sharded on flattened dim",
)
