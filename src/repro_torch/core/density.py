"""Density / induced-degree primitives (counterpart of ``repro.core.density``)."""

from __future__ import annotations

import math
from typing import NamedTuple

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


class GraphStats(NamedTuple):
    deg: torch.Tensor  # float32[N] induced (weighted) degree
    total_weight: torch.Tensor  # float32[] sum of alive edge weights |E(S)|
    n_alive: torch.Tensor  # int64[] |S|
    density: torch.Tensor  # float32[] rho(S); 0 when S is empty


def undirected_stats(edges: EdgeList, alive: torch.Tensor) -> GraphStats:
    """All per-pass statistics of Algorithm 1 for one node set."""
    w_alive = alive_edge_weight(edges, alive)
    deg = exact_degrees(edges, w_alive)
    total = w_alive.sum()
    n_alive = alive.sum()
    density = torch.where(n_alive > 0, total / torch.clamp(n_alive, min=1), 0.0)
    return GraphStats(deg=deg, total_weight=total, n_alive=n_alive, density=density)


class DirectedStats(NamedTuple):
    out_deg: torch.Tensor  # float32[N] |E(i, T)|
    in_deg: torch.Tensor  # float32[N] |E(S, j)|
    total_weight: torch.Tensor  # |E(S, T)|
    n_s: torch.Tensor
    n_t: torch.Tensor
    density: torch.Tensor  # |E(S,T)| / sqrt(|S| |T|)


def directed_stats(edges: EdgeList, s_alive: torch.Tensor, t_alive: torch.Tensor) -> DirectedStats:
    """Algorithm 3's statistics for one (S, T) pair."""
    from repro_torch.core.engine import DirectedST, ExactBackend

    ok = edges.mask & s_alive[edges.src] & t_alive[edges.dst]
    w = torch.where(ok, edges.weight, 0.0)
    out_deg, in_deg, total = ExactBackend().directed(edges, w)
    n_s, n_t = s_alive.sum(), t_alive.sum()
    density = DirectedST(eps=0.0, c=torch.ones(())).density(total, n_s, n_t)
    return DirectedStats(out_deg, in_deg, total, n_s, n_t, density)


def density_of(edges: EdgeList, alive: torch.Tensor) -> torch.Tensor:
    """rho(S) for a node subset, recomputed from scratch (for validation)."""
    return undirected_stats(edges, alive).density


def max_passes_bound(n_nodes: int, eps: float, floor: int = 8) -> int:
    """Static trip-count bound: ceil(log_{1+eps} n) + slack (Lemma 4),
    capped at n+1 (the min-degree fallback removes a node every pass)."""
    if eps <= 0:
        return int(n_nodes) + 1
    bound = int(math.ceil(math.log(max(n_nodes, 2)) / math.log1p(eps))) + 4
    return max(floor, min(bound, int(n_nodes) + 1))
