"""The plain reference peel against brute force on tiny graphs."""

import itertools
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from portbench import reference


def _graph(n, p, seed):
    rng = np.random.default_rng(seed)
    pairs = [(u, v) for u in range(n) for v in range(u + 1, n) if rng.random() < p]
    src = torch.tensor([u for u, _ in pairs], dtype=torch.int32)
    dst = torch.tensor([v for _, v in pairs], dtype=torch.int32)
    return pairs, src, dst


def _density(pairs, nodes):
    s = set(nodes)
    return Fraction(sum(u in s and v in s for u, v in pairs), len(s)) if s else Fraction(0)


def _slow_peel(pairs, n, eps, max_passes):
    """Algorithm 1 over Python sets, rho and the threshold in float32 as the
    reference states; the best set the first of the largest rho."""
    alive = set(range(n))
    best, best_rho, t = set(alive), -math.inf, 0
    factor = np.float32(2.0 * (1.0 + eps))
    while t < max_passes and alive:
        deg = {u: 0 for u in alive}
        e = 0
        for u, v in pairs:
            if u in alive and v in alive:
                deg[u] += 1
                deg[v] += 1
                e += 1
        rho = np.float32(np.float32(e) / np.float32(len(alive)))
        if float(rho) > best_rho:
            best, best_rho = set(alive), float(rho)
        thr = np.float32(factor * rho)
        least = min(deg.values())
        alive = {u for u in alive if not (deg[u] <= thr or deg[u] <= least)}
        t += 1
    return sorted(best), best_rho, t


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("eps", [0.125, 0.5, 1.0, 3.0])
def test_peel_matches_a_slow_peel_and_the_approximation_bound(seed, eps):
    n = 10
    pairs, src, dst = _graph(n, 0.45, seed)
    mp = reference.max_passes_bound(n, eps)
    got, _ = reference.peel(src, dst, n, eps, mp)
    nodes, rho, passes = _slow_peel(pairs, n, eps, mp)
    assert got.nodes.tolist() == nodes
    assert got.density == rho and got.passes == passes and got.size == len(nodes)
    # The answer's density is its set's, and within 2(1+eps) of the densest
    # subgraph found by trying every subset.
    assert abs(float(_density(pairs, got.nodes)) - got.density) < 1e-6
    best = max(_density(pairs, c) for r in range(1, n + 1)
               for c in itertools.combinations(range(n), r))
    assert got.density >= float(best) / (2 * (1 + eps)) - 1e-6


def test_work_counts_alive_edges_and_nodes_each_pass():
    pairs, src, dst = _graph(12, 0.5, 3)
    rep = reference.replay(src, dst, 12, [0.5, 1.0], 20)
    for lane, ans in zip(rep.work, rep.answers):
        assert len(lane) == ans.passes
        assert lane[0] == (len(pairs), 12)
        assert all(e2 <= e1 and n2 < n1 for (e1, n1), (e2, n2) in zip(lane, lane[1:]))


def test_bfloat16_control_departs_on_a_power_law_graph():
    from portbench.generators import chung_lu

    cfg = {"n_nodes": 3000, "draws": 15000, "exponent": 2.2}
    src, dst = chung_lu.edges(cfg, seed=1, device="cpu")
    ok, _ = reference.peel(src, dst, 3000, 0.5, 40)
    ctl, _ = reference.peel(src, dst, 3000, 0.5, 40, precision="bfloat16")
    assert ctl.density != ok.density


def test_eps_must_be_exact_in_float32():
    with pytest.raises(ValueError):
        reference.peel(torch.tensor([0], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
                       2, 0.1, 8)
