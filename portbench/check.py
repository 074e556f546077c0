"""The comparison that decides ``correct``.

Every answer the window produced, lane by lane, is compared with the plain
reference's answer for the same graph and eps (``reference.py``).  The
peel is exact: its sets, sizes and passes are determined by the graph and
have the limit 0.  The density is the float32 quotient of |E(S)|, which
the reference counts exactly and rounds once, while the port sums |E(S)|
as float32 weights: above 2^24 edges the sum's last place depends on its
order, so ``density_gap`` has a limit of its own, set between the
program's readings and the control's (PERF.md).  The numbers:

* ``failed``: queries that raised;
* ``wrong_answers``: lanes of queries whose set, size or passes differ
  from the reference's, or whose density is past ``density_gap``'s limit;
* ``set_mismatch``: the most nodes in the symmetric difference between a
  lane's set and the reference's;
* ``density_gap``: the largest |rho - rho_ref| / rho_ref;
* ``passes_gap``: the largest |passes - passes_ref|;
* ``provenance_mismatch``: queries whose front door resolved another
  backend, substrate, compaction or batch axis than the traffic states.

The control, the reference in bfloat16 put in the program's place, reads
far past the limits of the first four answer numbers (PERF.md).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from portbench.queries import Result
from portbench.reference import Answer

LIMITS = {
    "failed": 0,
    "wrong_answers": 0,
    "set_mismatch": 0,
    "density_gap": 1e-5,
    "passes_gap": 0,
    "provenance_mismatch": 0,
}


def _set_diff(got: np.ndarray, ref_ids: np.ndarray, ref_masks: Dict[int, np.ndarray],
              lane: int) -> int:
    """Nodes in one set and not the other.  ``got`` is a bool mask over the
    nodes (the program's answer) or sorted node ids (the control's)."""
    if got.dtype == np.bool_:
        if lane not in ref_masks:
            ref_masks[lane] = np.zeros(len(got), dtype=np.bool_)
            ref_masks[lane][ref_ids] = True
        return int(np.count_nonzero(got != ref_masks[lane]))
    if len(got) == len(ref_ids) and np.array_equal(got, ref_ids):
        return 0
    return int(len(np.setxor1d(got, ref_ids, assume_unique=True)))


def compare(results: Sequence[Optional[Result]], want: List[Answer],
            expect: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value": v, "limit": l}}`` over every query of the window;
    a ``None`` result is a query that raised."""
    failed = wrong = set_mm = passes_gap = prov = 0
    dens_gap = 0.0
    ref_masks: Dict[int, np.ndarray] = {}
    for res in results:
        if res is None:
            failed += 1
            continue
        if res.provenance is not None and any(
                res.provenance.get(k) != v for k, v in expect.items()):
            prov += 1
        if len(res.answers) != len(want):
            wrong += len(want)
            continue
        for lane, (got, ref) in enumerate(zip(res.answers, want)):
            d = _set_diff(np.asarray(got.nodes), ref.nodes, ref_masks, lane)
            g = abs(got.density - ref.density) / abs(ref.density) if ref.density else (
                abs(got.density))
            p = abs(got.passes - ref.passes)
            if d or g > LIMITS["density_gap"] or p or got.size != ref.size:
                wrong += 1
            set_mm = max(set_mm, d)
            dens_gap = max(dens_gap, g)
            passes_gap = max(passes_gap, p)
    values = {
        "failed": failed,
        "wrong_answers": wrong,
        "set_mismatch": set_mm,
        "density_gap": dens_gap,
        "passes_gap": passes_gap,
        "provenance_mismatch": prov,
    }
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def is_correct(checks: Dict[str, Dict[str, float]], n_results: int) -> bool:
    return n_results > 0 and all(c["value"] <= c["limit"] for c in checks.values())
