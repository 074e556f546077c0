"""Logical-axis sharding (counterpart of ``repro.sharding.rules``): model
code names axes ("embed", "heads", ...) and a per-run rule table maps them
to mesh axes.  Changing the mesh (single-pod 16x16, multi-pod 2x16x16, a
test 1x1) never touches model code.

A spec is a plain tuple with one entry a tensor dimension: ``None``
(replicated) or a tuple of mesh-axis names (that dimension split over
those axes, the first the major one), trailing ``None``s dropped; it is
``tuple(P)`` of the reference's ``PartitionSpec``.  :func:`placements`
turns it into DTensor placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh` (one ``Shard`` or
``Replicate`` a mesh dimension).

Parameter specs come from path-pattern rules (a regex on the nested-dict
path), activation specs from ``shard(x, "batch", "seq", "embed")`` calls
that consult an ambient context.  ``shard`` is the identity outside a
context or on a plain tensor, so the port's results on one device never
change; inside a context, on a DTensor, it redistributes to the rule's
placements (``jax.lax.with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Optional[Tuple[str, ...]], ...]


# Default logical-axis -> mesh-axis tables.  "batch" spreads over pod+data;
# tensor-parallel dims go to "model".
SINGLE_POD_RULES: dict = {
    "batch": ("data",),
    "expert_batch": ("data",),
    "model": ("model",),
    "edges": ("data", "model"),
}
MULTI_POD_RULES: dict = {
    "batch": ("pod", "data"),
    "expert_batch": ("data",),
    "model": ("model",),
    "edges": ("pod", "data", "model"),
}


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Maps logical axis names to mesh axes."""

    table: Mapping[str, MeshAxes]

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.table.get(logical, None)

    def pspec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        used: list = []
        seen: set = set()
        for a in logical_axes:
            m = self.mesh_axes(a)
            # A mesh axis may appear at most once in a spec.
            if m is None:
                used.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(x for x in ms if x not in seen)
            seen.update(ms)
            used.append(ms if ms else None)
        while used and used[-1] is None:
            used.pop()
        return tuple(used)


def make_rules(logical_to_mesh: Mapping[str, MeshAxes],
               base: Optional[Mapping[str, MeshAxes]] = None) -> AxisRules:
    table = dict(base or {})
    table.update(logical_to_mesh)
    return AxisRules(table)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of such a mapping,
    returned as a dict), in the mesh's order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension that splits tensor dimension ``d``, ``Replicate()`` on the
    rest.  A dimension split over several axes is split in the mesh's axis
    order (DTensor's rule); the local shard shapes are the same in any
    order."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the mesh {names}")
            if sizes[a] > 1:  # a split in one is no split
                out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of the first device's shard of a tensor of ``shape`` laid
    out by ``spec`` (each split dimension rounded up, as DTensor and the
    reference's padded shards round)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in _axes(entry):
            out[d] = -(-out[d] // sizes[a])
    return tuple(out)


def fit(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """``spec`` with each dimension's axes cut to the longest prefix whose
    product divides the dimension (``('pod', 'data')`` -> ``('pod',)``), so
    every shard has the same shape: the reference's rule for explicit
    input shardings (the reference's ``launch/cells.py::_sanitize_pspec``).  Tiny GNN
    weights like (1433, 64) fall back toward replication dim by dim."""
    sizes = mesh_shape(mesh)
    out = []
    for i, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))):
        if ax is None:
            out.append(None)
            continue
        kept, run = [], 1
        for a in _axes(ax):
            if shape[i] % (run * sizes[a]) == 0:
                kept.append(a)
                run *= sizes[a]
            else:
                break
        out.append(tuple(kept) if kept else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# Ambient sharding context (mesh + rules) for activation constraints.
# ---------------------------------------------------------------------------


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[AxisRules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[AxisRules]):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical_axes: Optional[str],
          uneven: Sequence[str] = ()) -> torch.Tensor:
    """Constrains an activation's sharding: the identity with no context or
    on a plain tensor; on a DTensor, a redistribution to the rule's
    placements.  Where a dimension does not divide over its axes, it keeps
    the longest prefix of them that divides it (:func:`fit`); the
    reference's partitioner pads instead.  The logical axes named in
    ``uneven`` keep such a split as DTensor's uneven shards (the padded
    layout), for dimensions whose next ops run on each device's shard
    (attention heads)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"shard(): got {len(logical_axes)} axes for rank-{x.dim()} array")
    if not _is_dtensor(x):
        return x
    full = _CTX.rules.pspec(logical_axes)
    fitted = fit(tuple(x.shape), full, x.device_mesh)
    fitted += (None,) * (len(full) - len(fitted))
    spec = tuple(f if a in uneven else g for a, f, g in zip(logical_axes, full, fitted))
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[AxisRules]:
    return _CTX.rules


# ---------------------------------------------------------------------------
# Parameter specs from path-pattern rules.
# ---------------------------------------------------------------------------

ParamRule = Tuple[str, Tuple[Optional[str], ...]]  # (path regex, logical axes)


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, (dict, list, tuple))


def map_with_path(fn, tree, *rest, path: str = "", is_leaf=_is_leaf):
    """``fn(path, leaf, *matching)`` over a nested dict / list tree; the
    path joins dict keys and list indices with "/" as the reference's
    ``_path_str`` does."""
    if is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=f"{path}/{k}" if path else str(k), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, *(r[i] for r in rest),
                             path=f"{path}/{i}" if path else str(i), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    raise TypeError(f"not a tree node or leaf at {path!r}: {type(tree).__name__}")


def logical_axes_for_params(params: Any, param_rules: Sequence[ParamRule]) -> Any:
    """A tree of logical-axis tuples matching ``params``' structure."""

    def assign(path, leaf):
        for pattern, axes in param_rules:
            if re.search(pattern, path):
                if len(axes) != len(leaf.shape):
                    raise ValueError(
                        f"rule {pattern} gives {len(axes)} axes for rank-{len(leaf.shape)} "
                        f"param at {path} with shape {tuple(leaf.shape)}")
                return tuple(axes)
        return (None,) * len(leaf.shape)

    return map_with_path(assign, params)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def pspecs_for_params(params: Any, param_rules: Sequence[ParamRule], rules: AxisRules):
    axes_tree = logical_axes_for_params(params, param_rules)
    return map_with_path(lambda _p, a: rules.pspec(a), axes_tree, is_leaf=_is_axes)


def shardings_for_params(params: Any, param_rules: Sequence[ParamRule], rules: AxisRules,
                         mesh):
    """A tree of DTensor placements (one tuple a leaf) on ``mesh``."""
    specs = pspecs_for_params(params, param_rules, rules)
    return map_with_path(lambda _p, s: placements(s, mesh), specs, is_leaf=_is_axes)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, tuple) for e in x)


def divisibility_check(shape_tree: Any, specs: Any, mesh) -> list:
    """Human-readable problems where a sharded dim is not divisible by its
    mesh-axis product (the reference's messages)."""
    sizes = mesh_shape(mesh)
    problems: list = []

    def check(path, leaf, spec):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axs = _axes(ax)
            total = 1
            for a in axs:
                total *= sizes[a]
            if leaf.shape[dim] % total != 0:
                problems.append(f"{path}: dim {dim} ({leaf.shape[dim]}) % {axs}={total}")

    map_with_path(check, shape_tree, specs)
    return problems
