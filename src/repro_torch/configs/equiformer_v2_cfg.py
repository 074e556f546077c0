"""equiformer-v2 [arXiv:2306.12059]: 12L d_hidden=128 l_max=6 m_max=2 8H,
eSCN-style SO(2) convolutions (the numbers of
``repro.configs.equiformer_v2_cfg``)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn.equiformer_v2 import EQ2_PARAM_RULES, EquiformerV2Config

CONFIG = EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8)
REDUCED = dataclasses.replace(CONFIG, n_layers=2, d_hidden=32, l_max=3, n_heads=4)

SPEC = ArchSpec(
    arch_id="equiformer-v2",
    family="gnn",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=EQ2_PARAM_RULES,
    shapes=gnn_shapes({"molecule": 16}),
    notes="per-m SO(2) matmuls restricted to |m|<=2; 49 spherical components",
)
