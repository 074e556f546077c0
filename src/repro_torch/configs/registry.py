"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro.configs.registry``), over every arch of the reference.

``densest-mapreduce`` is registered for its shapes and config, which the
benchmarks read; its launch dry-run waits for the port's launch layer
(ROADMAP Queue 1 item 12.3), so ``repro_torch.launch`` has no ``dryrun``."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec

# The reference's archs that the port does not run yet, and the ROADMAP item
# that ports each: none since the GNN and recsys families came.
NOT_PORTED: Dict[str, str] = {}


def all_archs() -> Dict[str, ArchSpec]:
    from repro_torch.configs import (
        densest_mapreduce,
        egnn_cfg,
        equiformer_v2_cfg,
        graphsage_reddit,
        llama3_2_3b,
        llama4_maverick_400b,
        mace_cfg,
        mixtral_8x7b,
        qwen2_72b,
        starcoder2_7b,
        two_tower_retrieval,
    )

    specs = [llama3_2_3b.SPEC, starcoder2_7b.SPEC, qwen2_72b.SPEC, mixtral_8x7b.SPEC,
             llama4_maverick_400b.SPEC, mace_cfg.SPEC, egnn_cfg.SPEC, graphsage_reddit.SPEC,
             equiformer_v2_cfg.SPEC, two_tower_retrieval.SPEC, densest_mapreduce.SPEC]
    return {s.arch_id: s for s in specs}


def get_arch(arch_id: str) -> ArchSpec:
    archs = all_archs()
    if arch_id in archs:
        return archs[arch_id]
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it needs {NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(archs)}")
