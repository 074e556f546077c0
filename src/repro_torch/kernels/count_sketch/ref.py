"""Plain PyTorch version of the Count-Sketch update kernel (K2).

Used on CPU tensors by the wrapper, by the CPU tests, and by
``chip_smoke.py`` as the kernel's comparator on the card.  It is the
reference's ``segment_sum`` over the flat ``t*b`` counter index, spelled as
one ``index_add_`` per table (the same sums, in the same edge order).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.countsketch import SketchParams
from repro_torch.kernels import hashing


def count_sketch_update_ref(
    endpoints: torch.Tensor,  # int32[E]
    w: torch.Tensor,  # float32[E] (float64 gives the comparator for float weights)
    params: SketchParams,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[t, b]`` counters in ``w``'s dtype: ``c[i, bucket_i(x)] +=
    sign_i(x)·w`` for every endpoint x; added into ``out`` when given."""
    t, b = params.n_tables, params.n_buckets
    if out is None:
        out = torch.zeros(t, b, dtype=w.dtype, device=w.device)
    x = hashing.as_u32(endpoints)
    for i in range(t):
        a_h, c_h, a_g, c_g = params.table(i)
        bucket = hashing.bucket32(hashing.mix32(a_h, c_h, x), b)
        sign = hashing.sign32(hashing.mix32(a_g, c_g, x)).to(w.dtype)
        out[i].index_add_(0, bucket, sign * w)
    return out


def sketch_edges_ref(
    src: torch.Tensor, dst: torch.Tensor, w_alive: torch.Tensor, params: SketchParams
) -> torch.Tensor:
    """Both endpoints of every edge, in the reference's ``concatenate([src,
    dst])`` order, without materializing the concatenation."""
    return count_sketch_update_ref(dst, w_alive, params,
                                   out=count_sketch_update_ref(src, w_alive, params))
