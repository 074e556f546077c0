"""The port's logical-axis sharding (``repro_torch.sharding.rules``,
``repro_torch.launch.tables``) against the reference's, and the dry-run
cells' ``info`` against the reference's ``build_cell``.

Every (arch x shape) cell of the registry, on the single-pod and the
multi-pod mesh: the rule tables and input axes are equal; every
parameter's spec equals ``tuple(P)`` of the reference's
``pspecs_for_params``; on a (2, 4) mesh (multi-pod: (2, 2, 2)) every
parameter's local shard shape after the reference's ``_sanitize_pspec``
equals ``NamedSharding(...).shard_shape`` on an ``AbstractMesh``; the
``divisibility_check`` messages are equal.  ``info`` is compared on a 1x1
mesh (a JAX ``Mesh`` of the one CPU device; the port's cells take a mesh's
axis sizes).  No world is started and nothing is compiled.  All
comparisons are exact.
"""

from __future__ import annotations

import functools
import types

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, Mesh, NamedSharding, PartitionSpec as P

from repro.configs.registry import assigned_cells as ref_assigned_cells
from repro.configs.registry import get_arch as ref_get_arch
from repro.launch import tables as ref_tables
from repro.launch.cells import SkipCell as RefSkipCell
from repro.launch.cells import _abstract_params as ref_abstract_params
from repro.launch.cells import _sanitize_pspec as ref_sanitize
from repro.launch.cells import build_cell as ref_build_cell
from repro.sharding import rules as ref_rules
from repro.train.step import specialize_gnn_config as ref_specialize
from repro_torch.configs.registry import assigned_cells, get_arch
from repro_torch.launch import tables
from repro_torch.launch.cells import SkipCell, _abstract_params, build_cell
from repro_torch.sharding import rules
from repro_torch.train.step import specialize_gnn_config

CELLS = ref_assigned_cells(include_densest=True)
PARAM_CELLS = [(a, s) for a, s in CELLS if ref_get_arch(a).family != "densest"]
SMALL = {False: {"data": 2, "model": 4}, True: {"pod": 2, "data": 2, "model": 2}}


def _norm(spec) -> tuple:
    """``tuple(P)`` with a lone axis spelled as a 1-tuple (the port's form;
    JAX's PartitionSpec keeps ``('data',)`` as ``'data'``)."""
    return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e))
                 for e in spec)


def test_assigned_cells_equal():
    assert assigned_cells() == ref_assigned_cells()
    assert assigned_cells(include_densest=True) == CELLS
    assert len(assigned_cells()) == 40 and len(CELLS) == 44


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_rules_and_input_axes_equal(arch, shape, multi_pod):
    ref_spec, spec = ref_get_arch(arch), get_arch(arch)
    want = ref_tables.rules_for(ref_spec, ref_spec.shape(shape), multi_pod)
    got = tables.rules_for(spec, spec.shape(shape), multi_pod)
    assert dict(got.table) == dict(want.table)
    assert (tables.input_axes(spec, spec.shape(shape))
            == ref_tables.input_axes(ref_spec, ref_spec.shape(shape)))


def test_pspec_semantics_match_reference():
    """A mesh axis at most once, trailing Nones dropped, as the reference."""
    table = {"a": ("data",), "b": ("data", "model"), "c": "model"}
    for axes in [("a", "b"), ("b", None, "a"), (None, None), ("c", "b", None), ("x", "a")]:
        want = ref_rules.AxisRules(table).pspec(axes)
        assert rules.AxisRules(table).pspec(axes) == _norm(want)
    assert rules.make_rules({"a": None}, base=table).table == ref_rules.make_rules(
        {"a": None}, base=table).table


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, shape: str):
    spec = ref_get_arch(arch)
    cfg = spec.config
    if spec.family == "gnn":
        cfg = ref_specialize(cfg, dict(spec.shape(shape).params))
    return ref_abstract_params(spec, cfg)


def _port_params(arch: str, shape: str):
    spec = get_arch(arch)
    cfg = spec.config
    if spec.family == "gnn":
        cfg = specialize_gnn_config(cfg, dict(spec.shape(shape).params))
    return _abstract_params(spec, cfg)


def _ref_flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or hasattr(x, "shape"))
    return {ref_rules._path_str(path): leaf for path, leaf in leaves}


def _port_flat(tree, is_leaf=None):
    out = {}
    kw = {"is_leaf": is_leaf} if is_leaf else {}
    rules.map_with_path(lambda p, x: out.__setitem__(p, x), tree, **kw)
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", PARAM_CELLS)
def test_param_specs_shards_and_divisibility_equal(arch, shape, multi_pod):
    ref_spec, spec = ref_get_arch(arch), get_arch(arch)
    ref_params, params = _ref_params(arch, shape), _port_params(arch, shape)
    r = ref_tables.rules_for(ref_spec, ref_spec.shape(shape), multi_pod)
    g = tables.rules_for(spec, spec.shape(shape), multi_pod)
    want = _ref_flat(ref_rules.pspecs_for_params(ref_params, ref_spec.param_rules, r))
    got_tree = rules.pspecs_for_params(params, spec.param_rules, g)
    got = _port_flat(got_tree, is_leaf=rules._is_spec)
    assert sorted(got) == sorted(want)
    assert {k: _norm(v) for k, v in want.items()} == got

    sizes = SMALL[multi_pod]
    like = types.SimpleNamespace(shape=sizes)
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    shapes = {k: tuple(v.shape) for k, v in _ref_flat(ref_params).items()}
    port_shapes = {k: tuple(v.shape) for k, v in _port_flat(params).items()}
    assert port_shapes == shapes
    for path, shp in shapes.items():
        ref_spec_s = ref_sanitize(shp, want[path], like)
        port_spec_s = rules.fit(shp, got[path], sizes)
        assert port_spec_s == _norm(ref_spec_s), path
        assert (rules.local_shape(shp, port_spec_s, sizes)
                == tuple(NamedSharding(amesh, ref_spec_s).shard_shape(shp))), path
    ref_msgs = ref_rules.divisibility_check(
        ref_params, ref_rules.pspecs_for_params(ref_params, ref_spec.param_rules, r), like)
    assert sorted(rules.divisibility_check(params, got_tree, sizes)) == sorted(ref_msgs)


@functools.lru_cache(maxsize=None)
def _jax_mesh(multi_pod: bool):
    dev = np.asarray(jax.devices()[:1])
    if multi_pod:
        return Mesh(dev.reshape(1, 1, 1), ("pod", "data", "model"))
    return Mesh(dev.reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_info_equal(arch, shape, multi_pod):
    sizes = {"pod": 1, "data": 1, "model": 1} if multi_pod else {"data": 1, "model": 1}
    try:
        want = ref_build_cell(arch, shape, multi_pod=multi_pod, mesh=_jax_mesh(multi_pod))
    except RefSkipCell as e:
        with pytest.raises(SkipCell) as got:
            build_cell(arch, shape, multi_pod=multi_pod, mesh=sizes)
        assert str(got.value) == str(e)
        return
    got = build_cell(arch, shape, multi_pod=multi_pod, mesh=sizes)
    assert got.info == want.info


def test_shard_is_identity_outside_a_context_and_on_plain_tensors():
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert rules.shard(x, "batch", None) is x
    with rules.sharding_ctx({"data": 1}, rules.AxisRules({"batch": ("data",)})):
        assert rules.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank-2"):
            rules.shard(x, "batch")
    assert rules.current_mesh() is None and rules.current_rules() is None


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"pod": 2, "data": 16, "model": 16}
    assert rules.placements((("data", "model"), None), sizes) == (Replicate(), Shard(0),
                                                                   Shard(0))
    assert rules.placements((None, ("model",)), sizes) == (Replicate(), Replicate(), Shard(1))
    assert rules.placements((), sizes) == (Replicate(),) * 3
    assert rules.local_shape((256, 100), (("pod", "data"), ("model",)), sizes) == (8, 7)
