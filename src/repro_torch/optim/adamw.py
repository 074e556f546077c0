"""AdamW (counterpart of ``repro.optim.adamw``), updating in place.

  * decoupled weight decay, bias-corrected moments, global-norm clipping
    computed on the device (no host read);
  * moment dtype fp32 | bf16 | int8 block-quantized (8-bit-Adam style,
    arXiv:2110.02861), the second moment quantized in the sqrt domain;
  * :func:`apply_updates` CONSUMES its inputs: the parameters, the moments
    and the step count are updated in place and the gradients are scaled in
    place by the clip factor.  The reference returns new trees; at
    llama3.2-3b's full width (12.85 GB of f32 parameters, as much again in
    gradients and twice that in fp32 moments: 51.4 GB) a second copy of
    parameters and moments cannot sit beside the first on an 80 GB card.
    Every leaf is updated in flat chunks of :data:`CHUNK` elements (a
    multiple of the int8 block), so the temporaries stay near 0.3 GB; the
    arithmetic is elementwise (per block for int8), so the chunks change no
    value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

# Elements a chunk of an in-place update (a multiple of every block size
# that divides 2^24), and of a sum of squares in the global norm (whose
# reduction order it sets).
CHUNK = 1 << 24
NORM_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "fp32"  # fp32 | bf16 | int8
    block: int = 256  # int8 quantization block size


@dataclasses.dataclass
class Quantized:
    """An int8 block-quantized tensor: ``q`` int8 ``[n_blocks, block]`` (the
    flattened tensor zero-padded to a block multiple), ``scale`` f32
    ``[n_blocks]`` (each block's absmax / 127), ``shape`` the original
    shape (static: not a leaf of the tree)."""

    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]
    _tree_fields = ("q", "scale")


def _quantize(x: torch.Tensor, block: int) -> Quantized:
    """Per-block absmax int8, rounded half to even (``jnp.round``)."""
    shape = tuple(x.shape)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).view(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-12)[:, None]).to(torch.int8)
    return Quantized(q=q, scale=scale, shape=shape)


def _dequantize(z: Quantized) -> torch.Tensor:
    flat = (z.q.float() * z.scale[:, None]).reshape(-1)
    return flat[:int(np.prod(z.shape, dtype=np.int64))].reshape(z.shape)


def _encode_moment(x: torch.Tensor, cfg: AdamWConfig, nonneg: bool = False):
    if cfg.moment_dtype == "fp32":
        return x
    if cfg.moment_dtype == "bf16":
        return x.to(torch.bfloat16)
    if cfg.moment_dtype == "int8":
        # Second moments span many decades near 0: linear absmax int8 there
        # zeroes small nu and blows up 1/sqrt(nu).  sqrt-domain quantization
        # keeps the relative error of sqrt(nu) bounded by absmax/127.
        return _quantize(x.clamp_min(0.0).sqrt() if nonneg else x, cfg.block)
    raise ValueError(cfg.moment_dtype)


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    mu: Any  # tree matching the params (Quantized leaves for int8)
    nu: Any


def init_state(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype``, step 0, on each leaf's device."""
    def zeros(p):
        return _encode_moment(torch.zeros(p.shape, dtype=torch.float32, device=p.device), cfg)

    dev = tree_util.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_util.tree_map(zeros, params),
                      nu=tree_util.tree_map(zeros, params))


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    if flat.numel() <= NORM_CHUNK:
        return flat.float().square().sum()
    return torch.stack([flat[a:a + NORM_CHUNK].float().square().sum()
                        for a in range(0, flat.numel(), NORM_CHUNK)]).sum()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32, on the device)."""
    return torch.sqrt(torch.stack([_sum_squares(x) for x in tree_util.leaves(tree)]).sum())


def _read(m, a: int, b: int, nonneg: bool) -> torch.Tensor:
    """Elements [a, b) of a moment leaf, decoded to f32."""
    if isinstance(m, Quantized):
        block = m.q.shape[1]
        lo, hi = a // block, -(-b // block)
        y = (m.q[lo:hi].float() * m.scale[lo:hi, None]).reshape(-1)[:b - a]
        return y.square() if nonneg else y
    return m.view(-1)[a:b].float()


def _write(m, a: int, b: int, x: torch.Tensor, cfg: AdamWConfig, nonneg: bool) -> None:
    """Stores ``x`` (f32) as elements [a, b) of a moment leaf, encoded."""
    if isinstance(m, Quantized):
        block = m.q.shape[1]
        z = _quantize(x.clamp_min(0.0).sqrt() if nonneg else x, block)
        lo = a // block
        m.q[lo:lo + z.q.shape[0]] = z.q
        m.scale[lo:lo + z.q.shape[0]] = z.scale
    else:
        m.view(-1)[a:b] = x


def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step, IN PLACE: returns ``(params, state, {"grad_norm"})``,
    the same objects, updated.  ``grads`` (a tree like ``params``) is
    consumed: it is scaled in place by the clip factor.

    DTensor parameters (the dry-run's sharded steps) update each device's
    local shards: the update is elementwise (per block for int8 moments,
    whose blocks are the local shard's), so only the global norm crosses
    devices, one all-reduce of the local sums of squares per sharding
    pattern.  Gradients are first redistributed to their parameter's
    placements."""
    step = state.step
    step.add_(1)
    ps, gs = tree_util.leaves(params), tree_util.leaves(grads)
    mus, nus = _moment_leaves(state.mu), _moment_leaves(state.nu)
    if ps and _is_dtensor(ps[0]):
        gs = [g if tuple(g.placements) == tuple(p.placements)
              else g.redistribute(p.device_mesh, p.placements) for p, g in zip(ps, gs)]
        gnorm = _sharded_norm(gs)
        ps, gs, mus, nus = ([_local(x, p) for x, p in zip(xs, ps)] for xs in (ps, gs, mus, nus))
        step = step.to_local() if _is_dtensor(step) else step
    else:
        gnorm = global_norm(grads)
    factor = None
    if cfg.clip_norm is not None:
        factor = (cfg.clip_norm / gnorm.clamp_min(1e-9)).clamp_max(1.0)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    chunk = CHUNK // cfg.block * cfg.block
    for p, g, mu_e, nu_e in zip(ps, gs, mus, nus):
        n = p.numel()
        pf, gf = p.view(-1), g.view(-1)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            gc = gf[a:b]
            if factor is not None:
                gc.mul_(factor)
            gc = gc.float()
            mu = cfg.b1 * _read(mu_e, a, b, False) + (1 - cfg.b1) * gc
            nu = cfg.b2 * _read(nu_e, a, b, True) + (1 - cfg.b2) * gc.square()
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            p32 = pf[a:b].float()
            pf[a:b] = p32 - cfg.lr * (delta + cfg.weight_decay * p32)
            _write(mu_e, a, b, mu, cfg, False)
            _write(nu_e, a, b, nu, cfg, True)
    return params, state, {"grad_norm": gnorm}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x, like):
    """A leaf's local shard (a ``Quantized`` moment: its local blocks, over
    the local shape of its parameter ``like``)."""
    if isinstance(x, Quantized):
        return Quantized(q=x.q.to_local(), scale=x.scale.to_local(),
                         shape=tuple(like.to_local().shape))
    return x.to_local()


def _sharded_norm(gs) -> torch.Tensor:
    """The global norm of DTensor gradients: each leaf's local sum of
    squares, summed over the leaves that shard alike, then one all-reduce
    of each such sum over the mesh dimensions that shard it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    groups: dict = {}
    for g in gs:
        dims = tuple(i for i, pl in enumerate(g.placements) if isinstance(pl, Shard))
        ss = _sum_squares(g.to_local())
        prev = groups.get(dims)
        groups[dims] = (ss if prev is None else prev[0] + ss, g.device_mesh)
    total = None
    for dims, (ss, mesh) in groups.items():
        pl = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
        full = DTensor.from_local(ss, mesh, pl, run_check=False).full_tensor()
        total = full if total is None else total + full
    return torch.sqrt(total)


def abstract_state(params, cfg: AdamWConfig) -> AdamWState:
    """:func:`init_state` of ``params``' shapes on the meta device: the
    optimizer state's shapes and dtypes, nothing allocated."""
    meta = tree_util.tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"), params)
    return init_state(meta, cfg)


def _moment_leaves(tree):
    """Leaves of a moment tree, a ``Quantized`` counting as one."""
    return tree_util.leaves(tree, is_leaf=lambda x: isinstance(x, Quantized))


def opt_state_from_reference(tree, device=None) -> AdamWState:
    """The reference's ``AdamWState`` (numpy arrays, or anything
    ``numpy.asarray`` takes, e.g. ``jax.tree.map(np.asarray, state)``) as
    the port's, on ``device`` (default: the card): fp32 and bf16 leaves
    keep their dtype, ``Quantized`` leaves (anything with ``q``, ``scale``
    and ``shape``) become the port's."""
    from repro_torch.graph.edgelist import resolve_device

    dev = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    def moments(node):
        if hasattr(node, "q") and hasattr(node, "scale") and hasattr(node, "shape"):
            return Quantized(q=leaf(node.q), scale=leaf(node.scale), shape=tuple(node.shape))
        if isinstance(node, dict):
            return {k: moments(v) for k, v in node.items()}
        return leaf(node)

    return AdamWState(step=leaf(tree.step).to(torch.int32), mu=moments(tree.mu),
                      nu=moments(tree.nu))
