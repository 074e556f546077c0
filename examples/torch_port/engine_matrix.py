"""The peel engine's policy x backend matrix on one graph, on the port
(counterpart of ``examples/engine_matrix.py``).

Every cell is the same pass body (``core/engine.py::run_peel``): only the
removal policy and the degree backend change.  ``exact`` counts with
``index_add_``, ``sketch`` builds its counters with the kernel K2, and
``pallas`` is the tiled kernel K1 (on the CPU both run their plain
versions).  The front door reaches the same cells declaratively, and the
closing lines prove it on one cell.  Run with::

    PYTHONPATH=src python examples/torch_port/engine_matrix.py [--n 1000] [--device cpu]
"""

import argparse

import torch

from repro_torch.core import densest_subgraph_exact
from repro_torch.core.countsketch import SketchBackend, make_sketch_params
from repro_torch.core.engine import (
    AtLeastKFraction,
    DirectedST,
    ExactBackend,
    UndirectedThreshold,
    run_peel,
)
from repro_torch.graph.generators import directed_planted, planted_dense_subgraph
from repro_torch.kernels.peel_degree.ops import degree_backend_from_tiling, tiling_for_edges


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' when asked")
    args = ap.parse_args(argv)

    eps, mp = 0.5, 64
    n = args.n
    edges, planted = planted_dense_subgraph(
        n, avg_deg=4, k=max(10, n // 25), p_dense=0.8, seed=0, device=args.device
    )
    dedges, _, _ = directed_planted(
        n, avg_deg=3, ks=max(8, n // 33), kt=max(6, n // 40), p_dense=0.9, seed=0,
        device=args.device,
    )
    _, rho_star = densest_subgraph_exact(edges)
    print(f"undirected n={edges.n_nodes} planted k={len(planted)} rho*={rho_star:.3f}")

    backends = {
        "exact": ExactBackend(),
        "sketch": SketchBackend(make_sketch_params(t=5, b=1 << 13, seed=1)),
        "pallas": degree_backend_from_tiling(tiling_for_edges(edges, tile_size=256)),
    }
    policies = {
        "undirected_threshold": (UndirectedThreshold(eps), edges),
        "at_least_k(100)": (AtLeastKFraction(k=100, eps=eps), edges),
        "directed_st(c=1)": (DirectedST(eps=eps, c=torch.tensor(1.0, device=dedges.device)),
                             dedges),
    }

    print(f"\n{'policy':<22} {'backend':<8} {'rho':>8} {'|S|':>6} {'passes':>7}")
    for pname, (policy, g) in policies.items():
        for bname, backend in backends.items():
            if policy.directed and bname == "pallas":
                continue  # the tiled kernel counts both endpoints (undirected)
            res = run_peel(g, policy, backend, mp)
            print(
                f"{pname:<22} {bname:<8} {float(res.best_density):8.3f} "
                f"{int(res.best_size):6d} {int(res.passes):7d}"
            )

    # The declarative route to the same cell (the front door, core/api.py).
    from repro_torch.core import Problem, solve

    front = solve(edges, Problem.undirected(eps=eps, max_passes=mp))
    direct = run_peel(edges, UndirectedThreshold(eps), ExactBackend(), mp)
    assert torch.equal(front.best_alive, direct.best_alive)
    print(
        f"\nsolve(Problem.undirected(eps={eps})) == engine cell "
        f"[{front.provenance.policy} x {front.provenance.backend}] ✓"
    )


if __name__ == "__main__":
    main()
