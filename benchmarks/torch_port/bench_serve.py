"""Serving-tier benchmark of the port (counterpart of
``benchmarks/bench_serve.py``): the seed-batched query engine and the cache
of built kernels.

    PYTHONPATH=src python -m benchmarks.torch_port.bench_serve [--n 30000] [--queries 64]

* **batched vs sequential** — the same per-seed query stream answered by
  the engine (pow2 buckets + one ``solve_batch`` a bucket group), by one
  exact-shape ``solve()`` a query (``sequential_exact``) and by one solve a
  bucketed query (``sequential_bucketed``): p50/p99 latency and qps.  The
  reference's ``programs_compiled`` counts XLA programs; the port compiles
  none, so the fields are left out.
* **bit-identity** — every batched answer equals a standalone ``solve()``
  of its extracted buffer before any number is reported.
* **cold start** — the first query of a fresh process (``_CHILD``, which
  imports neither JAX nor the JAX package) with its kernels loaded from a
  ``kernels.kernel_cache(dir)``: K1, K2 and K3, the kernels of the densest
  paths a replica serves (the exact query itself launches none).  The
  reference runs an uncached child and a populating child; here both are
  one child on a fresh directory (it builds with ``nvcc`` and publishes),
  then a warm child on the same directory must run ``nvcc`` 0 times
  (``BUILD_LOG`` empty) and answer the same density.  On the CPU the
  kernels are not loaded (they build for the card), so the children time
  the query alone.
* **local-vs-BFS sweep** — per-query work of ``extraction='local'`` stays
  flat across graph sizes while the radius-2 BFS ego-net grows.

Times are the host clock (each query's latency is the engine's clock; a
batch's wall ends in ``torch.cuda.synchronize()``); the engine figures are
the least-wall of ``--repeats`` warm streams.  Writes
experiments/bench/torch/BENCH_serve.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from benchmarks.torch_port import common
from repro_torch.core import Problem, Solver
from repro_torch.graph.edgelist import EdgeList
from repro_torch.graph.generators import chung_lu_power_law
from repro_torch.serve.densest import DensestQueryEngine

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src")

# A fresh process: the same graph, problem and engine from the same knobs.
_CHILD = """
import json, time
import torch
from repro_torch import kernels
from repro_torch.core import Problem
from repro_torch.graph.generators import chung_lu_power_law
from repro_torch.serve.densest import DensestQueryEngine

cfg = json.loads({cfg!r})
dev = torch.device(cfg["device"])
edges = chung_lu_power_law(cfg["n"], exponent=2.0, avg_deg=cfg["avg_deg"], seed=0, device=dev)
prob = Problem.undirected(eps=cfg["eps"], max_passes=cfg["max_passes"], compaction="off")
eng = DensestQueryEngine(edges, prob, cache_dir=cfg["cache_dir"], radius=cfg["radius"],
                         max_ego_nodes=cfg["max_ego_nodes"], max_wait_ms=0.0)
# The card's context is made at replica start either way: keep it out of
# the first query, so cold vs warm isolates acquiring the kernels.
torch.zeros(4, device=dev).sum().item()
counters = kernels.CacheCounters()
t0 = time.perf_counter()
with kernels.kernel_cache(cfg["cache_dir"], counters):
    if dev.type == "cuda":
        from repro_torch.kernels.count_sketch import ops as k2
        from repro_torch.kernels.l0_sampler import ops as k3
        from repro_torch.kernels.peel_degree import ops as k1
        for ops in (k1, k2, k3):
            ops._kernel()
acquire = time.perf_counter() - t0
r = eng.query(cfg["seed"])
first = time.perf_counter() - t0
if cfg["expect_warm"]:
    assert not kernels.BUILD_LOG, "warm-cache child ran nvcc: %s" % list(kernels.BUILD_LOG)
print("BENCH_CHILD " + json.dumps({{
    "first_query_s": first,
    "kernel_acquire_s": acquire,
    "density": r.density,
    "nvcc_runs": len(kernels.BUILD_LOG),
    "disk_hits": counters.disk_hits,
    "disk_misses": counters.disk_misses,
}}))
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--radius", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-ego-nodes", type=int, default=128)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--max-passes", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cache-dir", default=None,
                    help="cache of built kernels for the cold-start protocol "
                         "(default: a fresh temp dir)")
    ap.add_argument("--skip-cold-start", action="store_true",
                    help="skip the subprocess cold-start measurements")
    ap.add_argument("--skip-sweep", action="store_true",
                    help="skip the local-vs-BFS extraction scaling sweep")
    ap.add_argument("--sweep-sizes", default="30000,95000,300000",
                    help="comma-separated graph sizes for the scaling sweep")
    ap.add_argument("--sweep-queries", type=int, default=32)
    ap.add_argument("--skip-naive", action="store_true",
                    help="skip the exact-shape sequential_exact baseline")
    ap.add_argument("--out", default=common.out_path("BENCH_serve.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _run_child(cfg) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(cfg=json.dumps(cfg))],
        capture_output=True, text=True, env=env, timeout=1200,
    )
    if out.returncode != 0:
        raise RuntimeError(f"bench child failed:\n{out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BENCH_CHILD ")]
    return json.loads(line[-1][len("BENCH_CHILD "):])


def _stream(solve_one, seeds, dev):
    """Latencies and wall of one query stream answered one solve a query."""
    lat = []
    common.sync(dev)
    t0 = time.perf_counter()
    for s in seeds:
        q0 = time.perf_counter()
        float(solve_one(s).best_density)  # the answer on the host
        lat.append(time.perf_counter() - q0)
    return lat, time.perf_counter() - t0


def cold_start(args, dev, seed) -> dict:
    cache_dir = args.cache_dir or tempfile.mkdtemp(prefix="bench_serve_")
    owns_dir = args.cache_dir is None
    try:
        base = {
            "n": args.n, "avg_deg": args.avg_deg, "eps": args.eps,
            "max_passes": args.max_passes, "radius": args.radius,
            "max_ego_nodes": args.max_ego_nodes, "seed": seed,
            "device": str(dev), "cache_dir": cache_dir,
        }
        t0 = time.perf_counter()
        cold = _run_child(dict(base, expect_warm=False))
        cold_wall = time.perf_counter() - t0
        warm = _run_child(dict(base, expect_warm=True))
        assert warm["density"] == cold["density"], "cold/warm mismatch"
        return {
            "kernels": ["peel_degree.cu", "count_sketch.cu", "l0_sampler.cu"]
            if dev.type == "cuda" else [],
            "uncached_first_query_s": round(cold["first_query_s"], 4),
            "uncached_kernel_acquire_s": round(cold["kernel_acquire_s"], 4),
            "uncached_nvcc_runs": cold["nvcc_runs"],
            "uncached_child_wall_s": round(cold_wall, 4),
            "warm_disk_first_query_s": round(warm["first_query_s"], 4),
            "warm_disk_kernel_acquire_s": round(warm["kernel_acquire_s"], 4),
            "warm_disk_nvcc_runs": warm["nvcc_runs"],
            "warm_disk_hits": warm["disk_hits"],
            "cold_start_speedup_x": round(
                cold["first_query_s"] / max(warm["first_query_s"], 1e-9), 1),
        }
    finally:
        if owns_dir:
            shutil.rmtree(cache_dir, ignore_errors=True)


def run(args, graph=None) -> dict:
    dev = common.device_of(args)
    edges = graph if graph is not None else chung_lu_power_law(
        args.n, exponent=2.0, avg_deg=args.avg_deg, seed=0, device=dev)
    # compaction pinned off: solve_batch's lanes need it, and the
    # sequential baselines must run the same peel.
    prob = Problem.undirected(eps=args.eps, max_passes=args.max_passes, compaction="off")
    seeds = np.random.default_rng(7).integers(0, edges.n_nodes, args.queries).tolist()

    report = {
        "device": common.device_record(dev),
        "config": {
            "n_nodes": edges.n_nodes,
            "n_edges": int(edges.num_real_edges()),
            "queries": args.queries,
            "radius": args.radius,
            "max_batch": args.max_batch,
            "max_ego_nodes": args.max_ego_nodes,
            "eps": args.eps,
            "max_passes": args.max_passes,
        },
        "statistic": f"the least-wall stream of {args.repeats} warm streams; p50/p99 in it",
    }

    # ---- batched engine (the serving path) ----------------------------------
    eng = DensestQueryEngine(edges, prob, radius=args.radius, max_batch=args.max_batch,
                             max_ego_nodes=args.max_ego_nodes, max_wait_ms=0.0)
    eng.query_many(seeds)  # warm every bucket once
    best = None
    for _ in range(args.repeats):
        wall, results = common.timed(lambda: eng.query_many(seeds), dev)
        if best is None or wall < best[0]:
            best = (wall, results)
    wall, results = best
    report["batched"] = common.lat_stats([r.latency_s for r in results], wall, args.queries)
    report["batched"].update(
        distinct_buckets=len(eng.bucket_histogram),
        lanes_solved=eng.lanes_solved,
        pad_lanes=eng.pad_lanes,
    )
    print("batched:", report["batched"])

    # ---- bit-identity gate -------------------------------------------------
    check = Solver()
    for r in results:
        padded, nodes = eng.extract(r.seed)
        ref = check.solve(padded, prob)
        assert float(ref.best_density) == r.density, (r.seed, r.density)
        ba = np.nonzero(ref.best_alive.cpu().numpy())[0]
        assert np.array_equal(nodes[ba[ba < len(nodes)]], r.nodes), r.seed
    report["bit_identical_to_solve"] = True
    print(f"bit-identity: {len(results)} answers == sequential solve()")

    # ---- sequential_exact: one exact-shape solve a query ----------------------
    if not args.skip_naive:
        def exact_subgraph(seed):
            padded, nodes = eng.extract(seed)
            m = max(int(padded.mask.sum()), 1)
            return EdgeList(src=padded.src[:m], dst=padded.dst[:m], weight=padded.weight[:m],
                            mask=padded.mask[:m], n_nodes=max(len(nodes), 1))

        naive = Solver()
        lat, wall = _stream(lambda s: naive.solve(exact_subgraph(s), prob), seeds, dev)
        report["sequential_exact"] = common.lat_stats(lat, wall, args.queries)
        print("sequential_exact:", report["sequential_exact"])

    # ---- sequential_bucketed: bucketing without batching ------------------------
    seq = Solver()
    for s in seeds:
        seq.solve(eng.extract(s)[0], prob)
    best = None
    for _ in range(args.repeats):
        lat, wall = _stream(lambda s: seq.solve(eng.extract(s)[0], prob), seeds, dev)
        if best is None or wall < best[0]:
            best = (wall, lat)
    wall, lat = best
    report["sequential_bucketed"] = common.lat_stats(lat, wall, args.queries)
    print("sequential_bucketed:", report["sequential_bucketed"])
    if "sequential_exact" in report:
        report["batched_vs_sequential_qps_x"] = round(
            report["batched"]["qps"] / report["sequential_exact"]["qps"], 2)
    report["batched_vs_bucketed_qps_x"] = round(
        report["batched"]["qps"] / report["sequential_bucketed"]["qps"], 2)

    if not args.skip_cold_start:
        report["cold_start"] = cold_start(args, dev, seeds[0])
        print("cold_start:", report["cold_start"])

    # ---- local-vs-BFS extraction scaling sweep ----------------------------------
    if not args.skip_sweep:
        sizes = [int(s) for s in args.sweep_sizes.split(",")]
        sweep = {"sizes": sizes, "queries": args.sweep_queries, "bfs_radius": 2,
                 "local_budget": None, "bfs": [], "local": []}
        for n in sizes:
            g = chung_lu_power_law(n, exponent=2.0, avg_deg=args.avg_deg, seed=1, device=dev)
            ss = np.random.default_rng(11).integers(0, n, args.sweep_queries).tolist()
            for mode in ("bfs", "local"):
                kw = ({"radius": 2, "max_ego_nodes": None} if mode == "bfs"
                      else {"extraction": "local"})
                e = DensestQueryEngine(g, prob, max_batch=args.max_batch, max_wait_ms=0.0, **kw)
                e.query_many(ss)
                wall, rs = common.timed(lambda: e.query_many(ss), dev)
                point = {
                    "n": n,
                    "mean_extracted_nodes": round(float(np.mean([r.n_ego for r in rs])), 1),
                    "p50_ms": round(common.pct([r.latency_s for r in rs], 50) * 1e3, 3),
                    "qps": round(len(ss) / wall, 2),
                }
                if mode == "local":
                    sweep["local_budget"] = e.local_budget
                    point["mean_nodes_touched"] = round(
                        e.local_nodes_touched / (2 * len(ss)), 1)
                    point["mean_edges_scanned"] = round(
                        e.local_edges_scanned / (2 * len(ss)), 1)
                sweep[mode].append(point)
                print(f"sweep n={n} {mode}: {point}")
        first, last = sweep["local"][0], sweep["local"][-1]
        sweep["local_work_growth_x"] = round(
            last["mean_nodes_touched"] / max(first["mean_nodes_touched"], 1e-9), 2)
        fb, lb = sweep["bfs"][0], sweep["bfs"][-1]
        sweep["bfs_work_growth_x"] = round(
            lb["mean_extracted_nodes"] / max(fb["mean_extracted_nodes"], 1e-9), 2)
        report["local_vs_bfs_sweep"] = sweep
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    common.write_json(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
