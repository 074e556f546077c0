"""The port's collectives, counted (the mesh substrate's only traffic).

Every reduction and gather the mesh substrate makes goes through
:func:`all_reduce` or :func:`all_gather`, so ``all_reduce.count`` /
``all_gather.count`` are the number of collectives a solve launched and
``.bytes`` what each rank put on the wire (its input tensor's size).
``chip_smoke.py`` and the tests reset and read them, as they read
``hostsync.read.count``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduces ``x`` in place over ``group`` (``op`` 'sum' or 'max') and
    returns it."""
    all_reduce.count += 1
    all_reduce.bytes += x.numel() * x.element_size()
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


all_reduce.count = 0
all_reduce.bytes = 0


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated in their order in ``group`` (one
    ``all_gather_into_tensor``).  bool travels as uint8."""
    all_gather.count += 1
    all_gather.bytes += x.numel() * x.element_size()
    flat = x.view(torch.uint8) if x.dtype == torch.bool else x
    size = dist.get_world_size(group)
    out = flat.new_empty((size * flat.shape[0],) + tuple(flat.shape[1:]))
    dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


all_gather.count = 0
all_gather.bytes = 0


def reset() -> None:
    """Sets every count to 0."""
    all_reduce.count = all_reduce.bytes = 0
    all_gather.count = all_gather.bytes = 0
