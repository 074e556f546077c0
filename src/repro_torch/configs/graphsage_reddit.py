"""graphsage-reddit [arXiv:1706.02216]: 2L d_hidden=128 mean aggregator,
sample sizes 25-10 (the minibatch_lg shape samples 15-10); the numbers of
``repro.configs.graphsage_reddit``."""

import dataclasses

from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn.graphsage import SAGE_PARAM_RULES, SAGEConfig

CONFIG = SAGEConfig(n_layers=2, d_hidden=128, fanouts=(15, 10))
REDUCED = dataclasses.replace(CONFIG, d_hidden=32)

SPEC = ArchSpec(
    arch_id="graphsage-reddit",
    family="gnn",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=SAGE_PARAM_RULES,
    shapes=gnn_shapes({"molecule": 16}),
    notes="minibatch_lg uses the real layered neighbor sampler",
)
