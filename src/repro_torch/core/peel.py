"""Algorithm 1 — (2+2eps)-approximate densest subgraph for undirected
graphs (counterpart of ``repro.core.peel``).

A thin delegation through the front door: ``Problem.undirected(eps)`` on
the exact backend.  A ``degree_fn`` hook runs the same loop with custom
degrees through :class:`~repro_torch.core.engine.FnBackend` (one fixed
graph, so no ladder).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.api import DenseSubgraphResult, Problem, default_solver, run_cell, solve
from repro_torch.core.engine import FnBackend
from repro_torch.graph.edgelist import EdgeList


def densest_subgraph(
    edges: EdgeList,
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    degree_fn: Optional[Callable[[EdgeList, torch.Tensor], torch.Tensor]] = None,
    track_history: bool = True,
    compaction: str = "off",
) -> DenseSubgraphResult:
    """Runs Algorithm 1 and returns the best intermediate subgraph.

    ``compaction='geometric'`` runs the same loop through the compaction
    ladder (bit-identical for integer-valued weights); it cannot take a
    ``degree_fn``, which binds one fixed graph."""
    problem = Problem.undirected(
        eps=eps, max_passes=max_passes, track_history=track_history,
        compaction=compaction,
    )
    if degree_fn is None:
        return solve(edges, problem)
    if compaction not in ("off", "auto"):
        raise ValueError(
            "degree_fn hooks bind one fixed graph; compaction renumbers "
            "buffers per segment — use compaction='off'"
        )
    prob = dataclasses.replace(problem.resolve(edges.n_nodes), compaction="off")
    mp = prob.resolved_max_passes(edges.n_nodes)
    out = run_cell(edges, prob, backend=FnBackend(degree_fn), max_passes=mp)
    return default_solver._wrap(out, prob, edges.n_nodes, mp)


def densest_subgraph_sets(edges: EdgeList, eps: float = 0.5, **kw):
    """Host-side convenience: ``(node_index_array, density)``."""
    res = densest_subgraph(edges, eps=eps, **kw)
    return res.nodes(), float(res.best_density)
