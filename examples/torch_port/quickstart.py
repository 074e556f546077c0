"""Quickstart on the port: the front-door API on a planted dense block
(counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_port/quickstart.py [--n 4000] [--k 80] [--device cpu]

Declare a :class:`Problem`, call :func:`solve`, get a
:class:`DenseSubgraphResult`; then sweep eps in one peel loop with
:func:`solve_batch`, and compare against the exact max-flow optimum and
Charikar's node-at-a-time greedy (the paper's Table 2 in miniature).  The
graph and the peels live on ``--device`` (default: the card).
"""

import argparse
import time

import numpy as np

from repro_torch.core import (
    Problem,
    charikar_greedy,
    densest_subgraph_exact,
    solve,
    solve_batch,
)
from repro_torch.graph.generators import planted_dense_subgraph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--avg-deg", type=float, default=5.0)
    ap.add_argument("--k", type=int, default=80)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' when asked")
    args = ap.parse_args(argv)

    edges, planted = planted_dense_subgraph(
        n=args.n, avg_deg=args.avg_deg, k=args.k, p_dense=0.6, seed=7, device=args.device
    )
    print(f"graph: n={edges.n_nodes} m={int(edges.num_real_edges())} "
          f"(planted {len(planted)}-node dense block)")

    _, rho_star = densest_subgraph_exact(edges)
    print(f"exact optimum rho* = {rho_star:.4f} (Goldberg max-flow)")

    _, rho_greedy = charikar_greedy(edges)
    print(f"charikar greedy    = {rho_greedy:.4f} "
          f"(ratio {rho_star / rho_greedy:.3f})")

    # --- one Problem, one solve ----------------------------------------------
    eps_grid = (0.1, 0.5, 1.0)
    for eps in eps_grid:
        t0 = time.time()
        res = solve(edges, Problem.undirected(eps=eps))
        nodes = res.nodes()
        rho = float(res.best_density)
        overlap = len(np.intersect1d(nodes, planted)) / len(planted)
        print(
            f"peel eps={eps:<4} rho={rho:.4f} ratio={rho_star / rho:.3f} "
            f"passes={int(res.passes)} |S|={len(nodes)} "
            f"planted-recall={overlap:.0%} ({time.time() - t0:.2f}s) "
            f"[{res.provenance.policy} x {res.provenance.backend} "
            f"x {res.provenance.substrate}]"
        )
        assert rho_star / rho <= 2 * (1 + eps) + 1e-6  # Lemma 3

    # --- the whole eps sweep as one peel loop (one host sync a pass) --------
    t0 = time.time()
    batch = solve_batch(edges, Problem.undirected(max_passes=64), eps=list(eps_grid))
    rhos = batch.best_density.cpu().numpy()
    print(
        f"solve_batch eps={eps_grid}: rho={np.round(rhos, 4).tolist()} "
        f"in one peel loop ({time.time() - t0:.2f}s)"
    )
    for eps, rho in zip(eps_grid, rhos):
        assert rho_star / rho <= 2 * (1 + eps) + 1e-6


if __name__ == "__main__":
    main()
