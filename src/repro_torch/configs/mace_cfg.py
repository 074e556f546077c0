"""mace [arXiv:2206.07697]: 2L d_hidden=128 l_max=2 correlation=3 n_rbf=8,
E(3)-equivariant ACE message passing (the numbers of
``repro.configs.mace_cfg``)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn.mace import MACE_PARAM_RULES, MACEConfig

CONFIG = MACEConfig(n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8)
REDUCED = dataclasses.replace(CONFIG, d_hidden=32, n_rbf=4)

SPEC = ArchSpec(
    arch_id="mace",
    family="gnn",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=MACE_PARAM_RULES,
    shapes=gnn_shapes({"molecule": 16}),
    notes="graph-dataset shapes use synthesized positions + node-class head",
)
