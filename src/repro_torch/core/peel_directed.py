"""Algorithm 3 — directed densest subgraph (counterpart of
``repro.core.peel_directed``).

A thin delegation through the front door: ``Problem.directed`` on the
``DirectedST`` policy (S and T bitmaps; when |S|/|T| >= c peel S by
out-degree, else T by in-degree).  A geometric grid of c values
(resolution delta) costs at most an extra delta factor in the
approximation (§6.4): ``densest_directed_search`` runs it as a host loop,
``densest_directed_search_vmapped`` as one ``solve_batch`` sweep.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.api import DenseSubgraphResult, Problem, c_grid, solve, solve_batch
from repro_torch.graph.edgelist import EdgeList

__all__ = [
    "c_grid",
    "densest_directed_search",
    "densest_directed_search_vmapped",
    "densest_subgraph_directed",
]


def densest_subgraph_directed(
    edges: EdgeList,
    c: float,
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    compaction: str = "off",
) -> DenseSubgraphResult:
    """Algorithm 3 for one value of c."""
    return solve(
        edges,
        Problem.directed(c=float(c), eps=eps, max_passes=max_passes, compaction=compaction),
    )


def densest_directed_search(
    edges: EdgeList,
    eps: float = 0.5,
    delta: float = 2.0,
    max_passes: Optional[int] = None,
    compaction: str = "off",
):
    """Grid search over c (the paper's practical recipe).  Returns
    ``(result, best_c, per_c_densities, per_c_passes)``."""
    res = solve(
        edges,
        Problem.directed(c=None, eps=eps, c_delta=delta, max_passes=max_passes,
                         compaction=compaction),
    )
    ex = res.extras
    return res, ex["best_c"], np.asarray(ex["c_density"]), np.asarray(ex["c_passes"])


def densest_directed_search_vmapped(
    edges: EdgeList,
    eps: float = 0.5,
    delta: float = 2.0,
    max_passes: Optional[int] = None,
):
    """The whole c grid as one sweep (``solve_batch(c=grid)``): every pass
    over the edges serves all c values, and the loop runs to the slowest
    c.  Returns ``(best_c, best_rho, rhos[n_c], passes[n_c])``."""
    cs = c_grid(edges.n_nodes, delta)
    res = solve_batch(edges, Problem.directed(eps=eps, max_passes=max_passes), c=cs)
    rhos = res.best_density.cpu().numpy()
    best_i = int(np.argmax(rhos))
    return float(cs[best_i]), float(rhos[best_i]), rhos, np.asarray(res.passes)
