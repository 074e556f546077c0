"""egnn [arXiv:2102.09844]: 4L d_hidden=64, E(n)-equivariant (the numbers
of ``repro.configs.egnn_cfg``)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn.egnn import EGNN_PARAM_RULES, EGNNConfig

CONFIG = EGNNConfig(n_layers=4, d_hidden=64)
REDUCED = dataclasses.replace(CONFIG, n_layers=2, d_hidden=16)

SPEC = ArchSpec(
    arch_id="egnn",
    family="gnn",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=EGNN_PARAM_RULES,
    shapes=gnn_shapes({"molecule": 16}),
    notes="exactly E(n)-equivariant; property-tested under random rotations",
)
