"""Gradient compression for a data-parallel reduction (counterpart of
``repro.optim.compression``):

  * bf16 cast (2x fewer wire bytes);
  * int8 block quantization with ERROR FEEDBACK (the residual carried to
    the next step, 1-bit-Adam style): 4x fewer wire bytes.

The reference's ``axis_name`` (a ``shard_map`` axis) is here an optional
``torch.distributed`` group: its ``psum`` is a SUM and its ``pmax`` a MAX
``all_reduce`` through ``repro_torch.collectives`` (counted there).  With no
group it is the quantize/dequantize alone, the same numbers as one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import collectives
from repro_torch import tree as tree_util


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | bf16 | int8_ef
    block: int = 256


def init_error_state(params) -> Any:
    return tree_util.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_decompress_psum(
    grads: Any,
    err: Optional[Any],
    cfg: CompressionConfig,
    group=None,
) -> Tuple[Any, Optional[Any], float]:
    """Compresses grads, sums them over ``group`` (if given), decompresses;
    returns (grads, new_err, wire_bytes_factor).  New trees: the inputs are
    not changed."""

    def maybe_sum(x):
        return collectives.all_reduce(x, group) if group is not None else x

    if cfg.kind == "none":
        return tree_util.tree_map(maybe_sum, grads), err, 1.0

    if cfg.kind == "bf16":
        out = tree_util.tree_map(lambda g: maybe_sum(g.to(torch.bfloat16)).float(), grads)
        return out, err, 0.5

    if cfg.kind == "int8_ef":
        if err is None:
            raise ValueError("int8_ef needs the error state (init_error_state)")

        def one(g, e):
            g = g.float() + e  # error feedback
            n = g.numel()
            pad = (-n) % cfg.block
            flat_p = torch.nn.functional.pad(g.reshape(-1), (0, pad)).view(-1, cfg.block)
            scale = flat_p.abs().amax(dim=1) / 127.0
            # One per-block scale shared by the ranks (a small MAX
            # collective), so the int8 payloads sum exactly in int32.
            if group is not None:
                scale = collectives.all_reduce(scale, group, op="max")
            scale = scale.clamp_min(1e-12)
            q = torch.round(flat_p / scale[:, None]).clamp(-127, 127)
            deq_local = q * scale[:, None]
            new_e = (flat_p - deq_local).reshape(-1)[:n].reshape(g.shape)
            # The wire payload: int8 values, summed in int32.
            q_sum = maybe_sum(q.to(torch.int32)).float()
            out = (q_sum * scale[:, None]).reshape(-1)[:n].reshape(g.shape)
            return out, new_e

        pairs = tree_util.tree_map(one, grads, err)
        leaves = tree_util.leaves(pairs)  # (out, new_e) pairs flatten to out, new_e, ...
        return (tree_util.unflatten_like(grads, leaves[0::2]),
                tree_util.unflatten_like(grads, leaves[1::2]), 0.26)

    raise ValueError(cfg.kind)
