"""two-tower-retrieval [RecSys'19 YouTube; unverified]: embed_dim=256,
tower MLP 1024-512-256, dot interaction, in-batch sampled softmax with logQ
(the numbers of ``repro.configs.two_tower_retrieval``)."""

import dataclasses

from repro_torch.configs.base import ArchSpec, recsys_shapes
from repro_torch.models.recsys import TWO_TOWER_PARAM_RULES, TwoTowerConfig

CONFIG = TwoTowerConfig(
    n_users=8_388_608, n_items=2_097_152, embed_dim=256,
    tower_dims=(1024, 512, 256), hist_len=32,
)
REDUCED = dataclasses.replace(
    CONFIG, n_users=4096, n_items=2048, embed_dim=32, tower_dims=(64, 32), hist_len=8
)

SPEC = ArchSpec(
    arch_id="two-tower-retrieval",
    family="recsys",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=TWO_TOWER_PARAM_RULES,
    shapes=recsys_shapes(),
    rule_overrides={
        # retrieval_cand: batch=1 -> candidates carry the parallelism.
        "retrieval": {"batch": None, "vocab": ("data", "model")},
    },
    notes="column-sharded 8.4M/2.1M-row tables; EmbeddingBag via take+segment_sum",
)
