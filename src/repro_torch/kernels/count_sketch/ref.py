"""Plain PyTorch version of the Count-Sketch update kernel (K2).

Used on CPU tensors by the wrapper, by the CPU tests, and by
``chip_smoke.py`` as the kernel's comparator on the card.  It is the
reference's ``segment_sum`` over the flat ``t*b`` counter index, spelled as
one ``index_add_`` per table (the same sums, in the same edge order).
:func:`combine_runs` is the plain version of the rule by which the kernel
folds equal endpoints before it adds them.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


# Edges a warp of K2 reads in one step: one a lane.
STEP = 32


def combine_runs(endpoints: torch.Tensor, w: torch.Tensor,
                 step: int = STEP) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(x, Σw)`` stream K2 adds for one endpoint array: the array is
    cut into steps of ``step`` consecutive rows (row ``r`` in step
    ``r // step``), each maximal run of equal endpoints inside a step folds
    into one ``(x, sum of its weights)``, and a run whose sum is 0 is
    dropped.  Runs never cross a step boundary; zero-weight rows sit in
    their runs.  ``count_sketch_update_ref`` of this stream gives the
    counters of the raw stream, bitwise where every partial sum is an
    integer ≤ 2^24, and ``len(x)`` is the adds the kernel issues per table
    (one window).  Sums are taken in float64, then cast to ``w``'s dtype."""
    n = endpoints.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=endpoints.device)
    rows = torch.arange(n, device=endpoints.device)
    head[1:] = (endpoints[1:] != endpoints[:-1]) | (rows[1:] % step == 0)
    run = torch.cumsum(head, 0) - 1
    sums = torch.zeros(int(head.sum()), dtype=torch.float64, device=w.device)
    sums.index_add_(0, run, w.to(torch.float64))
    keep = sums != 0
    return endpoints[head][keep], sums[keep].to(w.dtype)
