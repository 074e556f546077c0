"""Density / induced-degree primitives (counterpart of ``repro.core.density``)."""

from __future__ import annotations

import math

import torch

from repro_torch.graph.edgelist import EdgeList


def alive_edge_weight(edges: EdgeList, alive: torch.Tensor) -> torch.Tensor:
    """float32[E]: weight for edges whose both endpoints are alive, else 0."""
    ok = edges.mask & alive[edges.src] & alive[edges.dst]
    return torch.where(ok, edges.weight, 0.0)


def exact_degrees(edges: EdgeList, w_alive: torch.Tensor) -> torch.Tensor:
    """Induced degrees; delegates to the engine's one exact count."""
    from repro_torch.core.engine import segment_degree_count

    deg, _ = segment_degree_count(edges.src, edges.dst, w_alive, edges.n_nodes)
    return deg


def max_passes_bound(n_nodes: int, eps: float, floor: int = 8) -> int:
    """Static trip-count bound: ceil(log_{1+eps} n) + slack (Lemma 4),
    capped at n+1 (the min-degree fallback removes a node every pass)."""
    if eps <= 0:
        return int(n_nodes) + 1
    bound = int(math.ceil(math.log(max(n_nodes, 2)) / math.log1p(eps))) + 4
    return max(floor, min(bound, int(n_nodes) + 1))
