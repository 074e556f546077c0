"""Charikar's node-at-a-time greedy 2-approximation [10], the baseline the
paper builds on (counterpart of ``repro.core.charikar``): removes one
minimum-degree node a step with a lazy-deletion heap, O(m log n), on the
host.  It needs n passes in the streaming model, which is the paper's
motivation."""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

from repro_torch.graph.edgelist import EdgeList, to_csr


def charikar_greedy(edges: EdgeList) -> Tuple[np.ndarray, float]:
    """``(node_indices, density)`` of the best intermediate subgraph."""
    indptr, indices = to_csr(edges)
    n = edges.n_nodes
    deg = np.diff(indptr).astype(np.int64)
    m = int(deg.sum()) // 2
    alive = np.ones(n, bool)
    heap = [(int(deg[v]), v) for v in range(n)]
    heapq.heapify(heap)

    best_density = m / n if n else 0.0
    removal_order = np.empty(n, np.int64)
    cur_m, cur_n = m, n
    best_step = 0  # number of removals in the best prefix
    for step in range(n):
        while True:
            d, v = heapq.heappop(heap)
            if alive[v] and d == deg[v]:
                break
        alive[v] = False
        removal_order[step] = v
        cur_m -= int(deg[v])
        cur_n -= 1
        for u in indices[indptr[v] : indptr[v + 1]]:
            if alive[u]:
                deg[u] -= 1
                heapq.heappush(heap, (int(deg[u]), int(u)))
        deg[v] = 0
        if cur_n > 0 and cur_m / cur_n > best_density:
            best_density = cur_m / cur_n
            best_step = step + 1
    keep = np.ones(n, bool)
    keep[removal_order[:best_step]] = False
    return np.nonzero(keep)[0], float(best_density)
