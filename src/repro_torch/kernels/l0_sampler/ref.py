"""Plain PyTorch version of the ℓ0-sampler update kernel (K3).

Used on CPU tensors by the wrappers, by the CPU tests, and by
``chip_smoke.py`` as the kernel's comparator on the card.  It is the
reference's ``segment_sum`` over the flat (level, table, cell) index,
accumulated in int64 and then wrapped to int32, so no step relies on
signed int32 overflow.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import hashing
from repro_torch.kernels.l0_sampler.ops import L0Params, edge_fingerprint, flat_cells


def l0_delta_ref(
    u: torch.Tensor,  # int32[E] canonical min endpoint
    v: torch.Tensor,  # int32[E] canonical max endpoint
    sgn: torch.Tensor,  # int32[E] ±1 / 0
    params: L0Params,
) -> torch.Tensor:
    """Sketch delta int32[L, d, C, 4] (sums wrapped mod 2^32)."""
    L, d, C = params.n_levels, params.n_tables, params.n_cells
    flat = flat_cells(params, u, v)  # [d, E]
    fp = hashing.to_i32(edge_fingerprint(params, u, v)).to(torch.int64)
    s = sgn.to(torch.int64)
    vals = torch.stack([s, s * u.to(torch.int64), s * v.to(torch.int64), s * fp], dim=-1)
    delta = torch.zeros(L * d * C, 4, dtype=torch.int64, device=u.device)
    delta.index_add_(0, flat.reshape(-1), vals.repeat(d, 1))
    return hashing.to_i32(delta).reshape(L, d, C, 4)
