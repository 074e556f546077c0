"""Degree-backend benchmark for the port's peel engine (counterpart of
``benchmarks/bench_engine.py``): exact (``index_add_``) vs Count-Sketch
(the kernel K2 builds the counters) vs the tiled kernel K1 ('pallas'),
same policy and graph.  Run with::

    PYTHONPATH=src python -m benchmarks.torch_port.bench_engine [--n 200000] [--avg-deg 10]
    PYTHONPATH=src python -m benchmarks.torch_port.bench_engine --shape flickr_sm

``--shape`` draws the config's Chung-Lu graph (``configs/densest_mapreduce``
``SHAPES``, exponent 2.2, seed 0: the graph ``chip_smoke.py`` holds) in
place of ``--n``/``--avg-deg`` (exponent 2.0, as in the reference).

Writes experiments/bench/torch/engine_backends.json: one row per backend
(the reference's CSV columns), ``wall_s`` the least of 3 warm runs on the
host clock, ending in ``torch.cuda.synchronize()``.  Each row
adds ``kernel_launches``: the launches of its kernel in one run (K1 for
pallas, K2 for sketch, 0 on the CPU, where the plain versions run).  There
is no fallback: a kernel that fails on the card raises.
"""

from __future__ import annotations

import argparse
import sys

from benchmarks.torch_port import common
from repro_torch.configs.densest_mapreduce import chung_lu_args
from repro_torch.core.countsketch import SketchBackend, make_sketch_params
from repro_torch.core.engine import ExactBackend, UndirectedThreshold, run_peel
from repro_torch.graph.generators import chung_lu_power_law
from repro_torch.kernels.count_sketch.ops import count_sketch_update
from repro_torch.kernels.peel_degree.ops import (
    degree_backend_from_tiling,
    tiled_degrees,
    tiling_for_edges,
)

PEEL_SHAPES = ("flickr_sm", "livejournal_md")
REPEATS = 3  # warm runs timed per backend, as in the reference


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--avg-deg", type=float, default=10.0)
    ap.add_argument("--shape", choices=PEEL_SHAPES, default=None,
                    help="draw the config's graph of this shape instead of --n")
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--max-passes", type=int, default=64)
    ap.add_argument("--sketch-b", type=int, default=1 << 15)
    ap.add_argument("--tile-size", type=int, default=2048)
    ap.add_argument("--out", default=common.out_path("engine_backends.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def graph_for(args, dev):
    """The benchmark's graph: ``--shape``'s, or the reference's draw."""
    if args.shape is not None:
        return chung_lu_power_law(**chung_lu_args(args.shape), device=dev)
    return chung_lu_power_law(args.n, exponent=2.0, avg_deg=args.avg_deg, seed=0, device=dev)


def run(args, graph=None) -> dict:
    dev = common.device_of(args)
    edges = graph if graph is not None else graph_for(args, dev)
    n = edges.n_nodes
    m = int(edges.num_real_edges())
    policy = UndirectedThreshold(args.eps)
    mp = args.max_passes

    backends = {
        "exact": (ExactBackend(), None),
        "sketch": (SketchBackend(make_sketch_params(t=5, b=args.sketch_b, seed=1)),
                   count_sketch_update),
        "pallas": (degree_backend_from_tiling(tiling_for_edges(edges, tile_size=args.tile_size)),
                   tiled_degrees),
    }
    rows = []
    ref_rho = None
    for name, (backend, kernel) in backends.items():
        def once(b=backend):
            return run_peel(edges, policy, b, mp)

        wall, _ = common.best_of(once, dev, REPEATS)
        before = kernel.launches if kernel is not None else 0
        res = once()
        launches = (kernel.launches - before) if kernel is not None else 0
        passes = int(res.passes)
        rho = float(res.best_density)
        if name == "exact":
            ref_rho = rho
        rows.append({
            "backend": name,
            "nodes": n,
            "edges": m,
            "passes": passes,
            "wall_s": round(wall, 4),
            "s_per_pass": round(wall / max(passes, 1), 5),
            "edges_per_s": int(m * passes / wall) if wall > 0 else 0,
            "rho": round(rho, 4),
            "rho_vs_exact": round(rho / ref_rho, 4) if ref_rho else 1.0,
            "kernel_launches": launches,
        })
        print(rows[-1])
    return {
        "device": common.device_record(dev),
        "graph": {"family": "chung_lu_power_law", "shape": args.shape, "n_nodes": n,
                  "n_edges": m},
        "statistic": f"wall_s: least of {REPEATS} warm runs",
        "rows": rows,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    common.write_json(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
