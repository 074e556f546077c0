"""Front-door benchmark of the port (counterpart of
``benchmarks/bench_api.py``): first against warm ``solve`` latency, and
``solve_batch`` eps-sweep throughput against sequential per-eps ``solve``.

    PYTHONPATH=src python -m benchmarks.torch_port.bench_api [--n 100000] [--avg-deg 8]
    PYTHONPATH=src python -m benchmarks.torch_port.bench_api --shape flickr_sm

The reference measures XLA compiles and its program cache (cold compile,
cached latency, trace counts).  PyTorch runs eagerly and the port caches
no traced program, so those fields have no counterpart here.  In their
place:

* ``solve``: the first call in this process against warm calls on the
  same graph and on a same-shape permuted graph, and the host syncs of one
  solve (``hostsync.read.count``: one a pass);
* ``kernel_load``: the same for ``backend='pallas'``, whose first call
  loads K1 through ``kernels.load_library`` (``core/progcache.py``; the
  process's handle to the library is dropped first, so the load is timed),
  with the builds this process made (``kernels.BUILD_LOG``: empty when the
  cache of built kernels was warm) and the cache's lookups during it; on
  the CPU the plain version runs and nothing loads;
* ``solve_batch``: one peel loop over the eps grid against a solve per
  eps, host syncs of each, and whether each lane equals its solve (lanes
  are bit-identical for eps exactly representable in float32, ``f32_exact``).

Times are seconds on the host clock ending in ``torch.cuda.synchronize()``;
warm figures are the least of ``--repeats`` calls.  Writes
experiments/bench/torch/BENCH_api.json.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from benchmarks.torch_port import common
from benchmarks.torch_port.bench_engine import PEEL_SHAPES
from repro_torch import hostsync, kernels
from repro_torch.configs.densest_mapreduce import chung_lu_args
from repro_torch.core import Problem, Solver
from repro_torch.graph.edgelist import EdgeList
from repro_torch.graph.generators import chung_lu_power_law
from repro_torch.kernels.peel_degree import ops as k1_ops


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--shape", choices=PEEL_SHAPES, default=None,
                    help="draw the config's graph of this shape instead of --n")
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--max-passes", type=int, default=48)
    ap.add_argument("--grid", type=int, default=8, help="eps sweep size")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=common.out_path("BENCH_api.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _warm(fn, dev, repeats: int) -> float:
    return min(common.timed(fn, dev)[0] for _ in range(repeats))


def _syncs(fn) -> int:
    hostsync.read.count = 0
    fn()
    return hostsync.read.count


def run(args, graph=None) -> dict:
    dev = common.device_of(args)
    if graph is not None:
        edges = graph
    elif args.shape is not None:
        edges = chung_lu_power_law(**chung_lu_args(args.shape), device=dev)
    else:
        edges = chung_lu_power_law(args.n, exponent=2.0, avg_deg=args.avg_deg, seed=0,
                                   device=dev)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(edges.src.shape[0]),
                           device=edges.device)
    other = EdgeList(
        src=edges.src[perm], dst=edges.dst[perm], weight=edges.weight[perm],
        mask=edges.mask[perm], n_nodes=edges.n_nodes,
    )
    # compaction pinned off, as in the reference: one pass loop, no ladder.
    prob = Problem.undirected(eps=args.eps, max_passes=args.max_passes, compaction="off")
    report = {
        "device": common.device_record(dev),
        "n_nodes": edges.n_nodes,
        "n_edges": int(edges.num_real_edges()),
        "eps": args.eps,
        "max_passes": args.max_passes,
        "statistic": f"first: one call; warm: least of {args.repeats} calls",
    }

    # ---- first vs warm solve ---------------------------------------------
    solver = Solver()
    first_s, res = common.timed(lambda: solver.solve(edges, prob), dev)
    warm = _warm(lambda: solver.solve(edges, prob), dev, args.repeats)
    same_shape = _warm(lambda: solver.solve(other, prob), dev, args.repeats)
    report["solve"] = {
        "first_call_s": round(first_s, 4),
        "warm_same_graph_s": round(warm, 4),
        "warm_same_shape_new_graph_s": round(same_shape, 4),
        "first_call_overhead_x": round(first_s / max(warm, 1e-9), 1),
        "passes": int(res.passes),
        "rho": round(float(res.best_density), 4),
        "host_syncs": _syncs(lambda: solver.solve(edges, prob)),
    }
    print("solve:", report["solve"])

    # ---- first pallas call: K1's library loaded through the cache --------
    on_card = dev.type == "cuda"
    built_before = set(kernels.BUILD_LOG)
    counters = kernels.PROCESS_COUNTERS  # a Solver without cache_dir counts here
    hits0, misses0 = counters.disk_hits, counters.disk_misses
    k1_ops._kernel.cache_clear()
    kprob = Problem.undirected(eps=args.eps, max_passes=args.max_passes, compaction="off",
                               backend="pallas")
    ksolver = Solver()
    kfirst, kres = common.timed(lambda: ksolver.solve(edges, kprob), dev)
    kwarm = _warm(lambda: ksolver.solve(edges, kprob), dev, args.repeats)
    report["kernel_load"] = {
        "library_loaded": on_card,
        "first_call_s": round(kfirst, 4),
        "warm_s": round(kwarm, 4),
        "first_call_overhead_x": round(kfirst / max(kwarm, 1e-9), 1),
        "builds_this_process": sorted(set(kernels.BUILD_LOG) - built_before),
        "build_log": {k: round(v["seconds"], 3) for k, v in kernels.BUILD_LOG.items()},
        "disk_hits": counters.disk_hits - hits0,
        "disk_misses": counters.disk_misses - misses0,
        "equal_to_exact": (torch.equal(kres.best_alive, res.best_alive)
                           and float(kres.best_density) == float(res.best_density)),
    }
    print("kernel_load:", report["kernel_load"])

    # ---- batched sweep vs sequential ----------------------------------------
    eps_grid = [round(0.1 + 0.1 * i, 3) for i in range(args.grid)]
    batch_solver = Solver()
    sweep = Problem.undirected(max_passes=args.max_passes)
    batch_first, batch = common.timed(
        lambda: batch_solver.solve_batch(edges, sweep, eps=eps_grid), dev)
    batch_warm = _warm(lambda: batch_solver.solve_batch(edges, sweep, eps=eps_grid), dev,
                       args.repeats)
    seq_solver = Solver()
    probs = [Problem.undirected(eps=e, max_passes=args.max_passes, compaction="off")
             for e in eps_grid]
    seq = [seq_solver.solve(edges, p) for p in probs]
    seq_warm = _warm(lambda: [seq_solver.solve(edges, p) for p in probs], dev, args.repeats)
    lane_equal = [
        bool(torch.equal(batch.best_alive[i], r.best_alive)
             and float(batch.best_density[i]) == float(r.best_density)
             and int(batch.passes[i]) == int(r.passes))
        for i, r in enumerate(seq)
    ]
    report["solve_batch"] = {
        "eps_grid": eps_grid,
        "passes": [int(p) for p in batch.passes],
        "batch_first_s": round(batch_first, 4),
        "batch_warm_s": round(batch_warm, 4),
        "sequential_warm_s": round(seq_warm, 4),
        "batch_speedup_x": round(seq_warm / max(batch_warm, 1e-9), 2),
        "batch_host_syncs": _syncs(lambda: batch_solver.solve_batch(edges, sweep,
                                                                    eps=eps_grid)),
        "sequential_host_syncs": _syncs(lambda: [seq_solver.solve(edges, p) for p in probs]),
        "lane_equal_to_solve": lane_equal,
        "f32_exact": [float(np.float32(e)) == e for e in eps_grid],
    }
    print("solve_batch:", report["solve_batch"])
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    common.write_json(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
