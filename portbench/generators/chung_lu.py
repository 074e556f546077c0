"""Chung-Lu power-law graphs drawn on the device from a seed.

The arithmetic of the port's host generator
(``repro_torch/graph/generators.py::chung_lu_power_law``), drawn with a
``torch.Generator`` on the graph's device instead of numpy on the host:
node ``i`` (0-based) has weight ``(i + 1) ** (-1 / (exponent - 1))``, so
the hubs get the lowest ids; ``draws`` sources and ``draws`` destinations
are drawn independently with probability proportional to the weights, by
inverse transform of uniform float64 draws over the weights' cumulative
sum; self-loops are removed and each undirected edge is kept once, as
``(lo, hi)``, in increasing ``(lo, hi)`` order.  Weights are 1.

Configuration keys read: ``n_nodes``, ``draws``, ``exponent``.

``fit`` chooses ``exponent`` and ``draws`` from a graph's published
statistics: its node count, its edge count and its maximum degree.  With
the weights above the largest expected degree is node 0's, so the
exponent is the one at which node 0 expects ``max_degree`` distinct
neighbours, and ``draws`` the count at which ``edges`` distinct edges
remain.  ``expected`` gives both expectations for a configuration.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch


def edges(config: Dict[str, Any], seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)`` as int32 tensors on ``device``, ``src < dst``, sorted,
    no duplicates: the same seed on the same device gives the same arrays."""
    n = int(config["n_nodes"])
    m = int(config["draws"])
    exponent = float(config["exponent"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device).pow(-1.0 / (exponent - 1.0))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    del w

    def draw() -> torch.Tensor:
        u = torch.rand(m, dtype=torch.float64, device=device, generator=gen)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)

    a = draw()
    b = draw()
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    del a, b
    keep = lo != hi
    key = (lo * n + hi)[keep]
    del lo, hi, keep
    key, _ = torch.sort(key)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    return (key // n).to(torch.int32), (key % n).to(torch.int32)


def expected(n_nodes: int, exponent: float, draws: float, block: int = 2048) -> Dict[str, float]:
    """Node 0's expected distinct neighbours (``max_degree``) and the
    expected distinct edges (``edges``) of ``edges()``'s graph.

    A pair ``i < j`` is drawn a Poisson-like ``lam = 2 draws p_i p_j``
    times and kept once: ``1 - exp(-lam)``.  Pairs among the first nodes
    (``block`` or more, so that every other pair has ``lam <= 0.2``) are
    summed exactly; the rest by the series ``lam - (lam^2/2 - lam^3/6 +
    lam^4/24)``.  Raises ``ValueError`` where that would take more than
    32,768 nodes."""
    import numpy as np

    n = int(n_nodes)
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (float(exponent) - 1.0))
    p = w / w.sum()
    two_d = 2.0 * float(draws)
    max_degree = float(np.sum(-np.expm1(-two_d * p[0] * p[1:])))
    # the first k nodes, where every pair outside them has lam <= 0.2
    k = min(n, max(block, int(np.searchsorted(-p, -0.2 / (two_d * p[0])))))
    if k > 32768:
        raise ValueError("hubs too heavy for the series outside the block")
    q = p[:k]
    dup_block = 0.0
    for r0 in range(0, k, 256):  # rows of the upper triangle, a few at a time
        lam = two_d * np.outer(q[r0:r0 + 256], q)
        lam = np.where(np.arange(k)[None, :] > np.arange(r0, min(r0 + 256, k))[:, None], lam, 0.0)
        dup_block += float(np.sum(lam - 1.0 + np.exp(-lam)))

    def pairs_outside(power: int) -> float:
        # sum over i < j, not both under k, of (p_i p_j) ** power
        whole = float(np.sum(p ** power)) ** 2 - float(np.sum(p ** (2 * power)))
        part = float(np.sum(q ** power)) ** 2 - float(np.sum(q ** (2 * power)))
        return (whole - part) / 2.0

    dup_rest = sum((-1) ** r * two_d ** r * pairs_outside(r) / math.factorial(r)
                   for r in (2, 3, 4))
    loops = float(draws) * float(np.sum(p * p))
    return {"max_degree": max_degree, "edges": float(draws) - loops - dup_block - dup_rest}


def fit(n_nodes: int, edges_: int, max_degree: int, lo: float = 2.05, hi: float = 6.0,
        tol: float = 1e-7) -> Tuple[float, int]:
    """``(exponent, draws)`` at which ``expected`` gives ``max_degree`` and
    ``edges_``: bisection on the exponent (node 0's share falls as it
    rises), each with the draws that leave ``edges_`` distinct edges."""

    def draws_for(exponent: float) -> float:
        d = float(edges_)
        for _ in range(6):  # the lost draws are a small share: a fixed point
            d += edges_ - expected(n_nodes, exponent, d)["edges"]
        return d

    while hi - lo > tol:
        mid = (lo + hi) / 2.0
        try:
            heavier = expected(n_nodes, mid, draws_for(mid))["max_degree"] > max_degree
        except ValueError:  # hubs past the series: far heavier than wanted
            heavier = True
        if heavier:
            lo = mid
        else:
            hi = mid
    exponent = round((lo + hi) / 2.0, 6)
    return exponent, int(round(draws_for(exponent)))
