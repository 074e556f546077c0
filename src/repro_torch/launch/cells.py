"""Builds one dry-run cell (counterpart of ``repro.launch.cells``): the step
function and its abstract sharded inputs for an (architecture x input
shape x mesh) combination, and traces it.

:func:`build_cell` keeps the reference's builders, overrides and ``info``:
parameters, optimizer state and batch are meta tensors (nothing
allocated), each with its spec from the logical-axis rules, sanitized as
the reference sanitizes explicit input shardings (a dimension the mesh
axes do not divide evenly falls back toward replication).

:func:`trace_cell` replaces the reference's ``lower_cell``: on a fake
world it makes every input a DTensor whose local shard is a fake tensor,
runs the step under ``FakeTensorMode``, the cell's sharding context and
``implicit_replication`` (a plain constant in the step, a mask or an
``arange``, counts as replicated), and counts the local ops with
:class:`~repro_torch.launch.op_stats.OpStats`.  Loops are counted as the
reference counts its ``while`` loops, a body times its trip count:

* the LM layer stack (the reference's ``lax.scan`` over layers) is traced
  at depth 1 and 2; a layer is their difference, and the step at depth L
  is depth 1 plus L-1 layers (the same rule for the peak live bytes);
* the densest peel (a ``lax.while_loop`` counted at its ``max_passes``
  bound): every host read of the loop's continuation test is answered,
  first true and then false, so each loop runs one pass, and that pass is
  counted its bound times.

Train cells trace forward, backward and the AdamW update
(``optim.apply_updates`` on the local shards).  The densest cells run the
port's mesh programs (``core/mapreduce.py``) on each device's local edge
shard over the edge axes' process group, the counterpart of the
reference's ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.loops import counting
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import abstract_batch
from repro_torch.launch import tables
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import AdamWConfig, AdamWState, Quantized, abstract_state
from repro_torch.sharding.rules import (
    AxisRules,
    fit,
    local_shape,
    map_with_path,
    mesh_shape,
    placements,
    pspecs_for_params,
    sharding_ctx,
)
from repro_torch.sharding.local import whole_last
from repro_torch.train.step import (
    init_model_params,
    make_loss_fn,
    make_recsys_retrieval,
    make_recsys_serve,
    make_train_step,
    specialize_gnn_config,
)

# Per-arch optimizer-state dtype: int8 block-quantized Adam moments are what
# let the 774B-param llama4 cell approach one device's memory (8-bit Adam).
_MOMENT_DTYPE = {
    "llama4-maverick-400b-a17b": "int8",
    "qwen2-72b": "fp32",
}


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    spec: ArchSpec
    shape: ShapeSpec
    mesh: Any  # DeviceMesh
    rules: AxisRules
    fn: Callable
    args: Tuple[Any, ...]  # meta-tensor trees
    # Static metadata for the roofline report.
    info: Dict[str, Any]
    arg_names: Tuple[str, ...] = ()  # params, opt_state, batch, ...
    specs: Tuple[Any, ...] = ()  # a spec tree per argument (sanitized)
    loops: Tuple[int, ...] = ()  # trip counts of the step's data-dependent loops
    overrides: Mapping[str, Any] = {}


class SkipCell(Exception):
    pass


def _attach(tree, spec_tree, mesh):
    """Each meta leaf's spec, sanitized: explicit input shardings must tile
    exactly (``sharding.rules.fit``, the reference's ``_sanitize_pspec``)."""
    return map_with_path(lambda _p, t, s: fit(tuple(t.shape), s, mesh), tree, spec_tree)


def _batch_pspecs(batch, axes_map, rules: AxisRules):
    def one(key, leaf):
        axes = axes_map.get(key)
        if axes is None:
            return ()
        n = leaf.dim()
        axes = tuple(axes)[:n] + (None,) * max(0, n - len(axes))
        return rules.pspec(axes)

    return {k: one(k, v) for k, v in batch.items()}


def _opt_specs(opt: AdamWState, param_specs):
    """Moments take their parameter's spec.  An int8 moment's blocks are its
    parameter's local shard's (``optim.apply_updates`` quantizes each
    device's shard), so a ``Quantized`` leaf carries the parameter's spec
    and is laid out from it (:func:`_quantized_layout`)."""
    def mirror(tree):
        return map_with_path(lambda _p, _m, s: s, tree, param_specs,
                             is_leaf=lambda x: isinstance(x, Quantized) or hasattr(x, "shape"))

    return AdamWState(step=(), mu=mirror(opt.mu), nu=mirror(opt.nu))


# ---------------------------------------------------------------------------
# Family builders
# ---------------------------------------------------------------------------


def _abstract_params(spec: ArchSpec, cfg) -> Any:
    return init_model_params(spec, torch.Generator(), cfg=cfg, device="meta")


def _params_and_specs(spec, cfg, rules, mesh):
    params = _abstract_params(spec, cfg)
    pspecs = _attach(params, pspecs_for_params(params, spec.param_rules, rules), mesh)
    return params, pspecs


def _batch_and_specs(spec, shape, rules, mesh):
    batch = abstract_batch(spec, shape)
    axes_map = tables.input_axes(spec, shape)
    return batch, _attach(batch, _batch_pspecs(batch, axes_map, rules), mesh)


class _Built(NamedTuple):
    fn: Callable
    args: Dict[str, Any]  # name -> meta-tensor tree, in the step's argument order
    specs: Dict[str, Any]
    info: Dict[str, Any]
    loops: Tuple[int, ...] = ()


def _train(spec, cfg, kind, params, pspecs, batch, bspecs, info, moment_dtype) -> _Built:
    opt_cfg = AdamWConfig(moment_dtype=moment_dtype)
    opt = abstract_state(params, opt_cfg)
    return _Built(make_train_step(make_loss_fn(spec, kind, cfg=cfg), opt_cfg),
                  {"params": params, "opt_state": opt, "batch": batch},
                  {"params": pspecs, "opt_state": _opt_specs(opt, pspecs), "batch": bspecs},
                  info)


def _lm_cell(spec, shape, mesh, rules, overrides, depth: Optional[int]) -> _Built:
    cfg = dataclasses.replace(
        spec.config,
        attn_impl=overrides.get("attn_impl", "auto"),
        remat=overrides.get("remat", True),
        q_chunk=overrides.get("q_chunk", spec.config.q_chunk),
        kv_chunk=overrides.get("kv_chunk", spec.config.kv_chunk),
    )
    info = {
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    p = dict(shape.params)
    params, pspecs = _params_and_specs(spec, cfg, rules, mesh)
    batch, bspecs = _batch_and_specs(spec, shape, rules, mesh)
    info["tokens_per_step"] = p["global_batch"] * (p["seq_len"] if shape.kind == "train" else 1)

    if shape.kind == "train":
        info["flops_model"] = 6 * info["active_params"] * info["tokens_per_step"]
        return _train(spec, cfg, shape.kind, params, pspecs, batch, bspecs, info,
                      overrides.get("moment_dtype", _MOMENT_DTYPE.get(spec.arch_id, "fp32")))

    if shape.kind == "prefill":
        from repro_torch.models.transformer import prefill

        def step(params, batch):
            # no_grad, not inference_mode: a DTensor cannot wrap inference tensors
            with torch.no_grad():
                logits, cache, cur_len = prefill.__wrapped__(params, cfg, batch["tokens"])
            return {"logits": logits, "cache": cache, "cur_len": cur_len}

        info["tokens_per_step"] = p["global_batch"] * p["seq_len"]
        info["flops_model"] = 2 * info["active_params"] * info["tokens_per_step"]
        return _Built(step, {"params": params, "batch": batch},
                      {"params": pspecs, "batch": bspecs}, info)

    if shape.kind in ("decode", "decode_long"):
        from repro_torch.models.transformer import cache_spec, decode_step

        b = p["global_batch"]
        spec_c = cache_spec(cfg, b, p["seq_len"])
        shp = (cfg.n_layers, b, spec_c.max_len, cfg.n_kv_heads, cfg.d_head)
        cache = {k: torch.empty(shp, dtype=spec_c.dtype, device="meta") for k in ("k", "v")}
        cspec = rules.pspec((None, "batch", "kv_seq", None, None))
        cache_specs = {k: fit(shp, cspec, mesh) for k in cache}
        cur_len = torch.empty((), dtype=torch.int32, device="meta")

        def step(params, cache, tokens, cur_len):
            with torch.no_grad():  # not inference_mode (see prefill)
                logits, cache, cur_len = decode_step.__wrapped__(params, cfg, cache, tokens,
                                                                 cur_len)
            nxt = whole_last(logits).argmax(-1).to(torch.int32)
            return {"next": nxt, "logits": logits}, cache, cur_len

        full = spec.config.n_layers
        info["flops_model"] = 2 * info["active_params"] * b
        info["kv_cache_bytes"] = int(
            2 * np.prod([full, b, spec_c.max_len, cfg.n_kv_heads, cfg.d_head]) * 2)
        return _Built(step, {"params": params, "cache": cache, "tokens": batch["tokens"],
                             "cur_len": cur_len},
                      {"params": pspecs, "cache": cache_specs, "tokens": bspecs["tokens"],
                       "cur_len": ()}, info)

    raise ValueError(shape.kind)


def _gnn_flops_model(spec, cfg, shape) -> int:
    """Analytic 'useful' FLOPs: per-layer dense transforms x nodes (+edges),
    x3 for fwd+bwd.  Message passing adds O(E*d) adds counted at 2 flops."""
    p = dict(shape.params)
    d_h = cfg.d_hidden if hasattr(cfg, "d_hidden") else 128
    if shape.kind == "sampled_train" and spec.arch_id == "graphsage-reddit":
        r = p["batch_nodes"]
        f1, f2 = p["fanout"]
        n_eff = r * (1 + f1 + f1 * f2)
        e_eff = r * f1 + r * f1 * f2
    elif shape.kind == "molecule_train":
        n_eff = p["batch"] * p["n_nodes"]
        e_eff = p["batch"] * p["n_edges"]
    else:
        n_eff = p["n_nodes"]
        e_eff = p["n_edges"]
    d_in = p.get("d_feat", d_h)
    n_layers = getattr(cfg, "n_layers", 2)
    per_node = 2 * (d_in * d_h + (n_layers - 1) * d_h * d_h + d_h * d_h)
    per_edge = 2 * d_h * n_layers
    return 3 * (n_eff * per_node + e_eff * per_edge)


def _gnn_cell(spec, shape, mesh, rules, overrides, depth) -> _Built:
    cfg = specialize_gnn_config(spec.config, dict(shape.params))
    params, pspecs = _params_and_specs(spec, cfg, rules, mesh)
    batch, bspecs = _batch_and_specs(spec, shape, rules, mesh)
    info = {
        "params": int(sum(int(np.prod(x.shape)) for x in tree_util.leaves(params))),
        "flops_model": _gnn_flops_model(spec, cfg, shape),
    }
    return _train(spec, cfg, shape.kind, params, pspecs, batch, bspecs, info,
                  overrides.get("moment_dtype", "fp32"))


def _recsys_cell(spec, shape, mesh, rules, overrides, depth) -> _Built:
    cfg = spec.config
    params, pspecs = _params_and_specs(spec, cfg, rules, mesh)
    batch, bspecs = _batch_and_specs(spec, shape, rules, mesh)
    p = dict(shape.params)
    d = cfg.embed_dim
    tower, din = 0, 2 * d
    for t_d in cfg.tower_dims:
        tower += din * t_d
        din = t_d
    item_tower, din = 0, d
    for t_d in cfg.tower_dims:
        item_tower += din * t_d
        din = t_d
    info = {"params": int(sum(int(np.prod(x.shape)) for x in tree_util.leaves(params)))}
    if shape.kind == "train":
        b = p["batch"]
        info["flops_model"] = 3 * (b * 2 * (tower + item_tower) + 2 * b * b * cfg.tower_dims[-1])
        return _train(spec, cfg, shape.kind, params, pspecs, batch, bspecs, info,
                      overrides.get("moment_dtype", "fp32"))
    if shape.kind == "serve":
        step = make_recsys_serve(cfg)
        info["flops_model"] = p["batch"] * 2 * (tower + item_tower)
    elif shape.kind == "retrieval":
        step = make_recsys_retrieval(cfg, k=overrides.get("topk", 100))
        nc = p["n_candidates"]
        info["flops_model"] = 2 * tower + nc * 2 * item_tower + 2 * nc * cfg.tower_dims[-1]
    else:
        raise ValueError(shape.kind)
    return _Built(step, {"params": params, "batch": batch}, {"params": pspecs, "batch": bspecs},
                  info)


def _densest_cell(spec, shape, mesh, rules, overrides, depth) -> _Built:
    from repro_torch.core.density import max_passes_bound
    from repro_torch.core.mapreduce import (
        make_distributed_directed_peel,
        make_distributed_peel,
        make_distributed_peel_twophase,
        make_distributed_sketched_peel,
        make_distributed_topk_peel,
    )

    p = dict(shape.params)
    n, m = p["n_nodes"], p["n_edges"]
    eps = overrides.get("eps", spec.config.eps)
    max_passes = overrides.get("max_passes", spec.config.max_passes)
    edge_axes = tuple(mesh_shape(mesh))
    n_shards = int(np.prod([mesh_shape(mesh)[a] for a in edge_axes]))
    m_pad = ((m + n_shards - 1) // n_shards) * n_shards
    espec = rules.pspec(("edges",))
    batch = {
        "src": torch.empty((m_pad,), dtype=torch.int32, device="meta"),
        "dst": torch.empty((m_pad,), dtype=torch.int32, device="meta"),
        "weight": torch.empty((m_pad,), dtype=torch.float32, device="meta"),
        "mask": torch.empty((m_pad,), dtype=torch.bool, device="meta"),
    }
    # Every branch below is the same engine loop (core/engine.py) on each
    # device's edge shard; the override picks the policy / degree backend.
    policy = overrides.get("policy", "undirected")
    wants_sketch = shape.kind == "peel_sketched" or overrides.get("use_sketch")
    if policy != "undirected" and wants_sketch:
        raise ValueError(
            f"policy={policy!r} has no distributed Count-Sketch builder yet; "
            "drop the sketch config or use policy='undirected'")
    loops: Tuple[int, ...] = (max_passes,)
    if overrides.get("twophase") and policy == "undirected" and not wants_sketch:
        k1 = min(int(overrides["twophase"]), max_passes)
        mp = max_passes if max_passes is not None else max_passes_bound(n, eps)
        loops = (k1, max(mp - k1, 4))

    built: Dict[str, Any] = {}

    def program():
        """The mesh program, built on first use (it makes the edge axes'
        process groups, so a cell can be built without a running world)."""
        if "fn" not in built:
            built["fn"] = make()
        return built["fn"]

    def make():
        if policy == "topk":
            return make_distributed_topk_peel(mesh, edge_axes, k=int(overrides.get("k", 2)),
                                              eps=eps, max_passes=max_passes, n_nodes=n)
        if policy == "directed":
            dfn = make_distributed_directed_peel(mesh, edge_axes, eps=eps,
                                                 max_passes=max_passes, n_nodes=n)
            c = float(overrides.get("c", 1.0))
            return lambda src, dst, weight, mask: dfn(src, dst, weight, mask, c)
        if wants_sketch:
            return make_distributed_sketched_peel(
                mesh, edge_axes, eps=eps, max_passes=max_passes, n_nodes=n,
                t=p.get("t", overrides.get("t", 5)), b=p.get("b", overrides.get("b", 1 << 17)))
        if overrides.get("twophase"):
            return make_distributed_peel_twophase(
                mesh, edge_axes, eps=eps, max_passes=max_passes, n_nodes=n,
                phase1_passes=int(overrides["twophase"]),
                wire_dtype=overrides.get("wire_dtype", "f32"))
        return make_distributed_peel(mesh, edge_axes, eps=eps, max_passes=max_passes, n_nodes=n,
                                     wire_dtype=overrides.get("wire_dtype", "f32"))

    def step(src, dst, weight, mask):
        # The mesh program runs on this device's shard: shard_map's counterpart.
        return program()(*(x.to_local() for x in (src, dst, weight, mask)))

    step.prepare = program  # the tracer builds it before faking tensors

    # Per-pass useful work: one weighted degree count (2 adds per endpoint
    # per edge) + threshold scan; expected passes ~ log_{1+eps} n.
    exp_passes = min(max_passes, math.ceil(math.log(max(n, 2)) / math.log1p(eps)))
    info = {
        "params": 0,
        "flops_model": exp_passes * (4 * m + 4 * n),
        "expected_passes": exp_passes,
    }
    return _Built(step, batch, {k: fit((m_pad,), espec, mesh) for k in batch}, info, loops)


_FAMILY_BUILDERS = {
    "lm": _lm_cell,
    "gnn": _gnn_cell,
    "recsys": _recsys_cell,
    "densest": _densest_cell,
}


def build_cell(
    arch_id: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    overrides: Optional[Mapping[str, Any]] = None,
    mesh=None,
    depth: Optional[int] = None,
) -> Cell:
    """The cell of (arch, shape) on ``mesh`` (default: the production mesh,
    which starts a fake world; or a mapping of axis sizes, enough to build
    the cell's inputs and ``info``).  ``overrides`` are the reference's,
    plus ``shape_params`` (sizes of the shape to replace).  ``depth``
    builds an LM step with that many layers (the tracer's rule for the
    layer stack); ``info`` keeps the full model's figures."""
    overrides = dict(overrides or {})
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    if overrides.get("shape_params"):  # a cut of the shape's sizes (one card's runs)
        shape = dataclasses.replace(shape, params={**shape.params, **overrides["shape_params"]})
    if shape.skip_reason is not None and not overrides.get("force", False):
        raise SkipCell(shape.skip_reason)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    multi = "pod" in mesh_shape(mesh)
    rules = tables.rules_for(spec, shape, multi, extra=overrides.get("rules"))
    built = _FAMILY_BUILDERS[spec.family](spec, shape, mesh, rules, overrides, depth)
    info = built.info
    sizes = mesh_shape(mesh)
    info.update(
        mesh="x".join(f"{k}={v}" for k, v in sizes.items()),
        n_devices=int(np.prod(list(sizes.values()))),
        family=spec.family,
        kind=shape.kind,
    )
    return Cell(arch_id=arch_id, shape_name=shape_name, spec=spec, shape=shape, mesh=mesh,
                rules=rules, fn=built.fn, args=tuple(built.args.values()), info=info,
                arg_names=tuple(built.args), specs=tuple(built.specs[k] for k in built.args),
                loops=built.loops, overrides=overrides)


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, run = [], 1
    for s in reversed(tuple(shape)):
        stride.append(run)
        run *= max(int(s), 1)
    return tuple(reversed(stride))


def _dtensor(local: torch.Tensor, shape, spec, mesh):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _materialize(meta, spec, mesh):
    """A DTensor of ``meta``'s shape and dtype laid out by ``spec``, its
    local shard an empty tensor (a fake one under ``FakeTensorMode``)."""
    local = torch.empty(local_shape(tuple(meta.shape), spec, mesh), dtype=meta.dtype)
    return _dtensor(local, tuple(meta.shape), spec, mesh)


def _quantized_layout(pshape, pspec, block: int, mesh):
    """(global q shape, spec) of an int8 moment of a parameter laid out by
    ``pspec``: its local shard's blocks, stacked along dim 0 over the mesh
    axes that shard the parameter."""
    n_local = int(np.prod(local_shape(pshape, pspec, mesh)))
    blocks = -(-n_local // block)
    axes = tuple(a for entry in pspec if entry is not None for a in entry)
    names = tuple(mesh_shape(mesh))
    axes = tuple(a for a in names if a in axes)  # mesh order
    n_sh = int(np.prod([mesh_shape(mesh)[a] for a in axes])) if axes else 1
    return (n_sh * blocks, block), ((axes,) if axes else ())


def _materialize_tree(tree, specs, mesh):
    def leaf(_p, x, s):
        if isinstance(x, Quantized):
            qshape, qspec = _quantized_layout(tuple(x.shape), s, x.q.shape[1], mesh)
            q = _materialize(torch.empty(qshape, dtype=x.q.dtype, device="meta"), qspec, mesh)
            scale = _materialize(torch.empty(qshape[:1], dtype=x.scale.dtype, device="meta"),
                                 qspec, mesh)
            return Quantized(q=q, scale=scale, shape=tuple(x.shape))
        return _materialize(x, s, mesh)

    if isinstance(tree, AdamWState):
        step = _materialize(tree.step, (), mesh)
        return AdamWState(step=step, mu=_materialize_tree(tree.mu, specs.mu, mesh),
                          nu=_materialize_tree(tree.nu, specs.nu, mesh))
    return map_with_path(leaf, tree, specs,
                         is_leaf=lambda x: isinstance(x, Quantized) or hasattr(x, "shape"))


def arg_bytes(cell: Cell) -> Dict[str, int]:
    """Per-device bytes of the cell's arguments from their placements: the
    first device's local shards, by argument (``params``, ``opt_state``,
    ``batch``; a decode cell's ``cache``)."""
    def leaf_bytes(x, s) -> int:
        if isinstance(x, Quantized):
            qshape, qspec = _quantized_layout(tuple(x.shape), s, x.q.shape[1], cell.mesh)
            rows = local_shape(qshape, qspec, cell.mesh)[0]
            return rows * qshape[1] * x.q.element_size() + rows * x.scale.element_size()
        return int(np.prod(local_shape(tuple(x.shape), s, cell.mesh))) * x.element_size()

    def total(tree, specs) -> int:
        if isinstance(tree, AdamWState):
            return (tree.step.element_size() + total(tree.mu, specs.mu)
                    + total(tree.nu, specs.nu))
        out = []
        map_with_path(lambda _p, x, s: out.append(leaf_bytes(x, s)), tree, specs,
                      is_leaf=lambda x: isinstance(x, Quantized) or hasattr(x, "shape"))
        return sum(out)

    return {name: total(a, s) for name, a, s in zip(cell.arg_names, cell.args, cell.specs)}


@dataclasses.dataclass
class Trace:
    """What :func:`trace_cell` counted, per device."""

    stats: Dict[str, Any]  # op_stats' keys (flops, hbm_bytes, collective_bytes, ...)
    per_op: Dict[str, Dict[str, float]]
    arg_bytes: Dict[str, int]
    peak_bytes: float  # arguments + the peak of what the step allocated
    traces: int  # steps traced (2 for a layer stack)
    note: str = ""


def _run(cell: Cell, answer=None, sites: bool = False):
    """One traced step of ``cell``: ``(OpStats, output)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.op_stats import OpStats

    prepare = getattr(cell.fn, "prepare", None)
    if prepare is not None:
        prepare()
    fake = FakeTensorMode()
    with fake:
        args = tuple(_materialize_tree(a, s, cell.mesh) if not isinstance(a, torch.Tensor)
                     else _materialize(a, s, cell.mesh) for a, s in zip(cell.args, cell.specs))
    stats = OpStats(answer=answer, sites=sites)
    with fake, sharding_ctx(cell.mesh, cell.rules), implicit_replication(), counting(), stats:
        out = cell.fn(*args)
    return stats, out


def _alternate():
    """Answers host reads true, false, true, false, ...: each peel loop runs
    one pass and stops."""
    state = {"n": 0}

    def answer(_t):
        state["n"] += 1
        return state["n"] % 2 == 1

    return answer


def trace_cell(cell: Cell, sites: bool = False) -> Trace:
    """Traces the cell's step on its mesh (see the module docstring) and
    returns its per-device counts, the reference's ``hlo_stats.analyze``
    keys among them.  ``sites`` keys ``per_op`` by op and the line of the
    port's code that dispatched it (slower)."""
    from repro_torch.launch.op_stats import Totals

    ab = arg_bytes(cell)
    base = float(sum(ab.values()))
    if cell.spec.family == "lm":
        full = cell.spec.config.n_layers
        runs = []
        for depth in (1, 2):
            c = build_cell(cell.arch_id, cell.shape_name, overrides=cell.overrides,
                           mesh=cell.mesh, depth=depth)
            stats, _ = _run(c, sites=sites)
            runs.append((stats, float(sum(arg_bytes(c).values()))))
        (s1, b1), (s2, b2) = runs
        layer = s2.totals.minus(s1.totals)
        totals = s1.totals.copy().add(layer.scaled(full - 1))
        per_op = {}
        for name in set(s1.per_op) | set(s2.per_op):
            r1 = s1.per_op.get(name, {})
            r2 = s2.per_op.get(name, {})
            per_op[name] = {k: r1.get(k, 0) + (full - 1) * (r2.get(k, 0) - r1.get(k, 0))
                            for k in ("count", "flops", "bytes", "collective_bytes")}
        peak1, peak2 = s1.peak_bytes + b1, s2.peak_bytes + b2
        peak = peak1 + (full - 1) * (peak2 - peak1)
        return Trace(stats=totals.as_dict(), per_op=per_op, arg_bytes=ab, peak_bytes=peak,
                     traces=2, note=f"layer stack: depth 1 + {full - 1} x (depth 2 - depth 1)")
    if cell.loops:
        stats, _ = _run(cell, answer=_alternate(), sites=sites)
        reads = stats.reads
        if len(reads) != 2 * len(cell.loops):
            raise RuntimeError(
                f"expected {2 * len(cell.loops)} host reads (one pass a loop), got {len(reads)}")
        totals = stats.totals.copy()
        for i, trip in enumerate(cell.loops):
            body: Totals = reads[2 * i + 1].minus(reads[2 * i])
            totals.add(body.scaled(trip - 1))
        return Trace(stats=totals.as_dict(), per_op=stats.per_op, arg_bytes=ab,
                     peak_bytes=stats.peak_bytes + base, traces=1,
                     note=f"peel loops: one pass x {list(cell.loops)}")
    stats, _ = _run(cell, sites=sites)
    return Trace(stats=stats.result(), per_op=stats.per_op, arg_bytes=ab,
                 peak_bytes=stats.peak_bytes + base, traces=1)
