"""Directed densest subgraph (Algorithm 3) with the paper's geometric c
grid, on the port (counterpart of ``examples/directed_csweep.py``).

    PYTHONPATH=src python examples/torch_port/directed_csweep.py [--device cpu]

Builds a directed graph with a planted S->T dense block (|S|/|T| = 2.5) and
solves ``Problem.directed()``: c=None sweeps the c grid, and the whole
profile comes back in ``result.extras``.  The best c should land near the
planted ratio and recover the planted sets.
"""

import argparse

import numpy as np

from repro_torch.core import Problem, solve
from repro_torch.graph.generators import directed_planted


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' when asked")
    args = ap.parse_args(argv)

    ks, kt = 100, 40
    edges, s_ids, t_ids = directed_planted(
        n=20_000, avg_deg=6.0, ks=ks, kt=kt, p_dense=0.5, seed=3, device=args.device
    )
    print(f"graph: n={edges.n_nodes} m={int(edges.num_real_edges())} "
          f"planted |S|={ks} |T|={kt} (c* = {ks / kt:.2f})")

    best = solve(edges, Problem.directed(eps=0.5, c_delta=2.0))
    best_c = best.extras["best_c"]
    grid = best.extras["c_grid"]
    rhos = best.extras["c_density"]
    passes = best.extras["c_passes"]
    for c, rho, p in zip(grid, rhos, passes):
        bar = "#" * int(40 * rho / max(rhos.max(), 1e-9))
        marker = "  <== best" if abs(c - best_c) < 1e-9 else ""
        if 0.01 <= c <= 100:
            print(f"c={c:9.3f} rho={rho:8.3f} passes={p:2d} {bar}{marker}")

    s_found = best.nodes()
    t_found = best.t_nodes()
    s_rec = len(np.intersect1d(s_found, s_ids)) / ks
    t_rec = len(np.intersect1d(t_found, t_ids)) / kt
    print(
        f"\nbest: c={best_c:.3f} rho={float(best.best_density):.3f} "
        f"|S|={len(s_found)} |T|={len(t_found)} "
        f"planted recall S={s_rec:.0%} T={t_rec:.0%}"
    )


if __name__ == "__main__":
    main()
