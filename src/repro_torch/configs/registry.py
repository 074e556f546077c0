"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro.configs.registry``), over the archs the port runs.

``densest-mapreduce`` is registered for its shapes and config, which the
benchmarks read; its launch dry-run waits for the port's launch layer
(ROADMAP Queue 1 item 12), so ``repro_torch.launch`` has no ``dryrun``."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec

# The reference's other archs, and the ROADMAP item that ports each.
NOT_PORTED = {
    "mace": "the GNN family, ROADMAP Queue 1 item 12",
    "egnn": "the GNN family, ROADMAP Queue 1 item 12",
    "graphsage-reddit": "the GNN family, ROADMAP Queue 1 item 12",
    "equiformer-v2": "the GNN family, ROADMAP Queue 1 item 12",
    "two-tower-retrieval": "the recsys family, ROADMAP Queue 1 item 12",
}


def all_archs() -> Dict[str, ArchSpec]:
    from repro_torch.configs import (
        densest_mapreduce,
        llama3_2_3b,
        llama4_maverick_400b,
        mixtral_8x7b,
        qwen2_72b,
        starcoder2_7b,
    )

    specs = [llama3_2_3b.SPEC, starcoder2_7b.SPEC, qwen2_72b.SPEC, mixtral_8x7b.SPEC,
             llama4_maverick_400b.SPEC, densest_mapreduce.SPEC]
    return {s.arch_id: s for s in specs}


def get_arch(arch_id: str) -> ArchSpec:
    archs = all_archs()
    if arch_id in archs:
        return archs[arch_id]
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it needs {NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(archs)}")
