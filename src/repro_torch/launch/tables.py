"""Logical-axis -> mesh-axis tables per (family, shape-kind, mesh flavor),
plus the per-input logical-axis declarations the dry-run uses to shard the
abstract batch (counterpart of ``repro.launch.tables``: the same data).

The model code only ever names logical axes ("batch", "heads", "edges", ...);
everything mesh-specific lives here and in the per-arch ``rule_overrides``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.sharding.rules import AxisRules, MeshAxes


def _dp(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _flat(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def _lm_table(multi_pod: bool, kind: str) -> Dict[str, MeshAxes]:
    t: Dict[str, MeshAxes] = {
        "batch": _dp(multi_pod),
        "fsdp": ("data",),
        "tp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "heads4": ("model",),  # 4D [b,s,h,d] attention head sharding
        "mlp": ("model",),
        "vocab": ("model",),
        "embed": ("model",),  # residual stream feature-sharded (SP-style)
        "seq": None,  # sequence-parallel residual (perf variant)
        "expert": None,
        "kv_seq": None,
    }
    if kind in ("decode", "decode_long"):
        t["kv_seq"] = ("model",)
        t["embed"] = None  # tiny decode activations; avoid per-token reshards
    return t


def _gnn_table(multi_pod: bool, kind: str) -> Dict[str, MeshAxes]:
    t = {
        # Edges sharded over every mesh axis (the paper's MapReduce edge
        # partitioning); node state replicated for small graphs.
        "batch": _dp(multi_pod),
        "fsdp": ("data",),
        "tp": ("model",),
        "nodes": None,
        "edges": _flat(multi_pod),
        "table_rows": None,
    }
    if kind == "full_train":
        # Perf iteration (EXPERIMENTS.md §Perf, equiformer x ogb_products):
        # replicated node state costs O(N x width) f32 autodiff residuals
        # per layer (60 GB x 12 layers at ogb scale) and full-state psums;
        # sharding nodes over all axes turns those into AG/RS of 1/256
        # slices.  Inputs are padded to 512 (see gnn_full_batch_spec).
        t["nodes"] = _flat(multi_pod)
    return t


def _recsys_table(multi_pod: bool, kind: str) -> Dict[str, MeshAxes]:
    return {
        "batch": _dp(multi_pod),
        "fsdp": ("data",),
        "tp": ("model",),
        "vocab": ("model",),
        "cand": _flat(multi_pod),
    }


def _densest_table(multi_pod: bool, kind: str) -> Dict[str, MeshAxes]:
    return {"edges": _flat(multi_pod)}


_FAMILY_TABLES = {
    "lm": _lm_table,
    "gnn": _gnn_table,
    "recsys": _recsys_table,
    "densest": _densest_table,
}


def _podify(value: MeshAxes, multi_pod: bool, key: str = "") -> MeshAxes:
    """Arch overrides are written in single-pod axis names; on the multi-pod
    mesh any tuple using 'data' widens to ('pod', 'data', ...) — EXCEPT the
    'fsdp' axis: ZeRO weight gathers must stay on fast intra-pod ICI (grads
    reduce across pods once per step; weights gather per layer)."""
    if not multi_pod or value is None or isinstance(value, str):
        return value
    if key == "fsdp":
        return value
    if "data" in value and "pod" not in value:
        return ("pod",) + tuple(value)
    return value


def rules_for(
    spec: ArchSpec,
    shape: ShapeSpec,
    multi_pod: bool,
    extra: Optional[Mapping[str, MeshAxes]] = None,
) -> AxisRules:
    """Family defaults <- arch '*' overrides <- arch per-kind overrides <-
    explicit extra overrides (perf variants)."""
    table = dict(_FAMILY_TABLES[spec.family](multi_pod, shape.kind))
    for layer in (
        spec.rule_overrides.get("*", {}),
        spec.rule_overrides.get(shape.kind, {}),
        dict(extra or {}),
    ):
        for k, v in layer.items():
            table[k] = _podify(v, multi_pod, key=k)
    return AxisRules(table)


# ---------------------------------------------------------------------------
# Input logical axes: pytrees of per-dim logical names matching the abstract
# batch structure from data/synthetic.py.
# ---------------------------------------------------------------------------


def input_axes(spec: ArchSpec, shape: ShapeSpec) -> Dict[str, Any]:
    family, kind = spec.family, shape.kind
    if family == "lm":
        if kind == "train":
            return {"tokens": ("batch", None), "labels": ("batch", None)}
        if kind == "prefill":
            return {"tokens": ("batch", None)}
        if kind in ("decode", "decode_long"):
            return {"tokens": ("batch", None)}
        raise ValueError(kind)
    if family == "gnn":
        if kind in ("full_train", "molecule_train") or (
            kind == "sampled_train" and spec.arch_id != "graphsage-reddit"
        ):
            ax = {
                "features": ("nodes", None),
                "src": ("edges",),
                "dst": ("edges",),
                "edge_mask": ("edges",),
                "labels": ("nodes",),
                "train_mask": ("nodes",),
                "positions": ("nodes", None),
                "graph_ids": ("nodes",),
                "graph_labels": ("batch",),
            }
            return ax
        if kind == "sampled_train":  # graphsage layered minibatch
            return {
                "feat_table": ("table_rows", None),
                "hop0": ("batch",),
                "hop1": ("batch", None),
                "hop2": ("batch", None, None),
                "hop1_mask": ("batch", None),
                "hop2_mask": ("batch", None, None),
                "labels": ("batch",),
            }
        raise ValueError(kind)
    if family == "recsys":
        if kind in ("train", "serve"):
            return {
                "user_id": ("batch",),
                "hist": ("batch", None),
                "hist_mask": ("batch", None),
                "item_id": ("batch",),
                "logq": ("batch",),
            }
        if kind == "retrieval":
            return {
                "user_id": ("batch",),
                "hist": ("batch", None),
                "hist_mask": ("batch", None),
                "cand_ids": ("cand",),
            }
        raise ValueError(kind)
    if family == "densest":
        return {
            "src": ("edges",),
            "dst": ("edges",),
            "weight": ("edges",),
            "mask": ("edges",),
        }
    raise ValueError(family)
