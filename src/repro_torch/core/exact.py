"""Exact densest-subgraph solvers, the paper's §6.2 quality oracle
(counterpart of ``repro.core.exact``, with its arithmetic).

Goldberg's max-flow characterization through
``scipy.sparse.csgraph.maximum_flow``, searched by Dinkelbach iteration:
every candidate density is |E(S)|/|S|, so capacities stay integral at about
m·n.  Brute-force enumerators (n <= 20 undirected, n <= 10 directed)
validate it.  Host-side numpy and scipy on the graph's edges.
"""

from __future__ import annotations

from itertools import combinations
from typing import Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_flow

from repro_torch.graph.edgelist import EdgeList


def _edges_numpy(edges: EdgeList) -> Tuple[np.ndarray, np.ndarray, int]:
    mask = edges.mask.cpu().numpy()
    src = edges.src.cpu().numpy()[mask].astype(np.int64)
    dst = edges.dst.cpu().numpy()[mask].astype(np.int64)
    return src, dst, edges.n_nodes


def densest_subgraph_exact(edges: EdgeList) -> Tuple[np.ndarray, float]:
    """Exact maximum-density subgraph of an unweighted undirected graph:
    ``(node_indices, density)``.  Goldberg's network: cap(s, v) = m,
    cap(v, t) = m + 2g - deg(v), cap(u<->v) = 1 per edge, scaled by the
    denominator q of g = p/q; some S has density > g iff the min cut is
    below m·n·q."""
    src, dst, n = _edges_numpy(edges)
    m = src.shape[0]
    if m == 0:
        return np.asarray([0]), 0.0
    deg = np.zeros(n, np.int64)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)

    s_id, t_id = n, n + 1

    def feasible(p: int, q: int) -> Tuple[bool, np.ndarray]:
        """Is there S with rho(S) > p/q?  Capacities scaled by q."""
        rows = np.concatenate([np.full(n, s_id), np.arange(n), src, dst])
        cols = np.concatenate([np.arange(n), np.full(n, t_id), dst, src])
        caps = np.concatenate([
            np.full(n, m * q, np.int64),
            m * q + 2 * p - q * deg,
            np.full(m, q, np.int64),
            np.full(m, q, np.int64),
        ])
        graph = csr_matrix((caps, (rows, cols)), shape=(n + 2, n + 2))
        res = maximum_flow(graph, s_id, t_id)
        if res.flow_value >= m * n * q:
            return False, np.asarray([], np.int64)
        # Source side of the min cut: a search of the residual graph.
        residual = graph - res.flow
        residual.data = np.maximum(residual.data, 0)
        seen = np.zeros(n + 2, bool)
        seen[s_id] = True
        frontier = [s_id]
        indptr, indices, data = residual.indptr, residual.indices, residual.data
        while frontier:
            u = frontier.pop()
            for e in range(indptr[u], indptr[u + 1]):
                v = indices[e]
                if data[e] > 0 and not seen[v]:
                    seen[v] = True
                    frontier.append(v)
        side = np.nonzero(seen[:n])[0]
        return side.size > 0, side

    # Dinkelbach: ask "is there S with rho(S) > p/q?" from rho(V), jumping
    # to each witness's own density; densities rise strictly, so it ends.
    best_side = np.arange(n)
    p_cur, q_cur = m, n  # rho(V)
    for _ in range(4 * n):
        ok, side = feasible(p_cur, q_cur)
        if not ok or side.size == 0:
            break
        inset = np.zeros(n, bool)
        inset[side] = True
        p_new = int(np.sum(inset[src] & inset[dst]))
        q_new = int(side.size)
        if p_new * q_cur <= p_cur * q_new:  # no strict improvement: done
            break
        best_side, p_cur, q_cur = side, p_new, q_new
    return best_side, _density_np(src, dst, best_side, n)


def _density_np(src: np.ndarray, dst: np.ndarray, nodes: np.ndarray, n: int) -> float:
    inset = np.zeros(n, bool)
    inset[nodes] = True
    m_in = int(np.sum(inset[src] & inset[dst]))
    return m_in / max(len(nodes), 1)


def densest_subgraph_brute(edges: EdgeList) -> Tuple[np.ndarray, float]:
    """Brute force over all non-empty subsets; n <= 20 only (a test oracle)."""
    src, dst, n = _edges_numpy(edges)
    assert n <= 20, "brute force limited to tiny graphs"
    best_nodes, best = np.asarray([0]), -1.0
    for size in range(1, n + 1):
        for comb in combinations(range(n), size):
            nodes = np.asarray(comb)
            d = _density_np(src, dst, nodes, n)
            if d > best:
                best, best_nodes = d, nodes
    return best_nodes, best


def densest_directed_brute(edges: EdgeList) -> Tuple[np.ndarray, np.ndarray, float]:
    """Brute force over (S, T) pairs for the directed density (n <= 10)."""
    src, dst, n = _edges_numpy(edges)
    assert n <= 10
    best = (-1.0, np.asarray([0]), np.asarray([0]))
    subsets = []
    for size in range(1, n + 1):
        subsets.extend(combinations(range(n), size))
    for S in subsets:
        s_mask = np.zeros(n, bool)
        s_mask[list(S)] = True
        for T in subsets:
            t_mask = np.zeros(n, bool)
            t_mask[list(T)] = True
            m_in = int(np.sum(s_mask[src] & t_mask[dst]))
            d = m_in / np.sqrt(len(S) * len(T))
            if d > best[0]:
                best = (d, np.asarray(S), np.asarray(T))
    return best[1], best[2], best[0]
