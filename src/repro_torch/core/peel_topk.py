"""Algorithm 2 — (3+3eps)-approximate densest subgraph of size >= k
(counterpart of ``repro.core.peel_topk``).

A thin delegation through the front door: ``Problem.at_least_k`` on the
``AtLeastKFraction`` policy (remove only the eps/(1+eps)·|S|
lowest-degree candidates a pass, ranked by (degree, id)); only sets with
|S| >= k are eligible and the loop stops once |S| < k (Lemma 11).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.api import DenseSubgraphResult, Problem, solve
from repro_torch.graph.edgelist import EdgeList


def densest_subgraph_at_least_k(
    edges: EdgeList,
    k: int,
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    compaction: str = "off",
) -> DenseSubgraphResult:
    """``compaction='geometric'`` rides the ladder: stable relabeling keeps
    the (degree, id) order, so results stay bit-identical for
    integer-valued weights."""
    return solve(
        edges,
        Problem.at_least_k(k=k, eps=eps, max_passes=max_passes, compaction=compaction),
    )
