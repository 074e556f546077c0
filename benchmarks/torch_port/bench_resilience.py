"""Resilience-layer benchmark of the port (counterpart of
``benchmarks/bench_resilience.py``): fault-free overhead and fault-storm
behavior of the seed-batched query engine.

    PYTHONPATH=src python -m benchmarks.torch_port.bench_resilience [--n 30000] [--queries 64]

* **fault-free overhead** — the bench_serve query stream answered by a
  plain engine and by one with a full ``ResilienceConfig`` and no
  ``FaultPlan`` installed (least wall of ``--repeats`` warm streams each,
  host clock ending in ``torch.cuda.synchronize()``), the answers bitwise
  equal; plus the cost of an uninstalled ``faults.fire`` hook.
* **fault storm** — the same stream under a seeded ``FaultPlan`` that
  fails ``--storm-prob`` of all ``serve.solve`` dispatches: the outcome
  histogram, p50/p99, ``answered_fraction``, and zero fabricated results
  (every answer re-derived by an independent solve: ok from its bucket
  buffer, ``radius:r`` from the smaller ego-net, ``last_good`` from the
  healthy pass).  ``main`` exits 1 if any answer was fabricated.

No kernel runs here: the engine's lanes use ``index_add_`` (no turnstile
service is attached).  Writes experiments/bench/torch/BENCH_resilience.json.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmarks.torch_port import common
from repro_torch import faults
from repro_torch.core import Problem, Solver
from repro_torch.faults import FaultPlan
from repro_torch.graph.generators import chung_lu_power_law
from repro_torch.serve.densest import DensestQueryEngine
from repro_torch.serve.resilience import ResilienceConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-ego-nodes", type=int, default=128)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--max-passes", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--storm-prob", type=float, default=0.35)
    ap.add_argument("--storm-seed", type=int, default=1202)
    ap.add_argument("--out", default=common.out_path("BENCH_resilience.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _best_wall(engine, seeds, repeats, dev):
    best = None
    for _ in range(repeats):
        wall, results = common.timed(lambda: engine.query_many(seeds), dev)
        if best is None or wall < best[0]:
            best = (wall, results)
    return best


def _members_of(res, nodes):
    alive = np.nonzero(res.best_alive.cpu().numpy())[0]
    return nodes[alive[alive < len(nodes)]]


def run(args, graph=None) -> dict:
    dev = common.device_of(args)
    edges = graph if graph is not None else chung_lu_power_law(
        args.n, exponent=2.0, avg_deg=args.avg_deg, seed=0, device=dev)
    prob = Problem.undirected(eps=args.eps, max_passes=args.max_passes, compaction="off")
    seeds = np.random.default_rng(7).integers(0, edges.n_nodes, args.queries).tolist()
    cfg = ResilienceConfig(deadline_ms=250.0, max_retries=2, backoff_base_ms=0.5,
                           breaker_threshold=8, breaker_cooldown_s=5.0, max_queue=4096)

    def fresh_engine(**kw):
        return DensestQueryEngine(edges, prob, radius=args.radius, max_batch=args.max_batch,
                                  max_ego_nodes=args.max_ego_nodes, max_wait_ms=0.0, **kw)

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
            "resilience": {
                "deadline_ms": cfg.deadline_ms,
                "max_retries": cfg.max_retries,
                "breaker_threshold": cfg.breaker_threshold,
                "max_queue": cfg.max_queue,
            },
        },
        "statistic": f"fault-free: the least-wall stream of {args.repeats} warm streams",
    }

    # ---- raw hook cost: an uninstalled fire() is one global read ----------
    assert faults.installed() is None
    reps = 1_000_000
    t0 = time.perf_counter()
    for _ in range(reps):
        faults.fire("bench.site", key=0)
    report["uninstalled_fire_ns_per_call"] = round((time.perf_counter() - t0) / reps * 1e9, 1)

    # ---- fault-free overhead: plain vs resilience-enabled -------------------
    plain = fresh_engine()
    resilient = fresh_engine(resilience=cfg)
    plain.query_many(seeds)
    resilient.query_many(seeds)
    wall_p, res_p = _best_wall(plain, seeds, args.repeats, dev)
    wall_r, res_r = _best_wall(resilient, seeds, args.repeats, dev)
    report["fault_free_plain"] = common.lat_stats([r.latency_s for r in res_p], wall_p,
                                                  args.queries)
    report["fault_free_resilient"] = common.lat_stats([r.latency_s for r in res_r], wall_r,
                                                      args.queries)
    report["fault_free_overhead_pct"] = round((wall_r - wall_p) / wall_p * 100.0, 2)
    for a, b in zip(res_p, res_r):
        assert a.density == b.density and b.status == "ok", a.seed
        assert np.array_equal(a.nodes, b.nodes), a.seed
    report["fault_free_bit_identical"] = True
    print("fault_free overhead %:", report["fault_free_overhead_pct"])

    # ---- fault storm ----------------------------------------------------------
    storm_eng = fresh_engine(resilience=cfg)
    healthy = {r.seed: r for r in storm_eng.query_many(seeds)}
    check = Solver()
    plan = FaultPlan(seed=args.storm_seed).fail_prob("serve.solve", args.storm_prob)
    with faults.active(plan):
        storm_wall, storm = common.timed(lambda: storm_eng.query_many(seeds), dev)

    def verified(r, radius) -> bool:
        padded, nodes = storm_eng.extract(r.seed, radius)
        ref = check.solve(padded, prob)
        return (float(ref.best_density) == r.density
                and np.array_equal(_members_of(ref, nodes), r.nodes))

    outcomes = {}
    fabricated = answered = 0
    for r in storm:
        key = r.fallback if r.status == "degraded" else r.status
        key = key.split(":")[0] if key and key.startswith("radius") else key
        outcomes[key] = outcomes.get(key, 0) + 1
        answered += bool(r.answered)
        if r.status == "ok":
            fabricated += not verified(r, args.radius)
        elif r.status == "degraded" and r.fallback.startswith("radius:"):
            fabricated += not verified(r, int(r.fallback.split(":")[1]))
        elif r.status == "degraded" and r.fallback == "last_good":
            h = healthy[r.seed]
            fabricated += not (h.density == r.density and np.array_equal(h.nodes, r.nodes))
    report["fault_storm"] = {
        "storm_seed": args.storm_seed,
        "fail_prob": args.storm_prob,
        "injected_failures": plan.failures_at("serve.solve"),
        "solve_hits": plan.hits_at("serve.solve"),
        "outcomes": outcomes,
        "answered_fraction": round(answered / len(storm), 4),
        "fabricated_results": fabricated,
        "solve_retries": storm_eng.solve_retries,
        "deadline_stops": storm_eng.deadline_stops,
        "breaker_open_skips": storm_eng.breaker_open_skips,
        "latency": common.lat_stats([r.latency_s for r in storm], storm_wall, len(storm)),
    }
    print("fault_storm:", json.dumps(report["fault_storm"]))
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run(args)
    common.write_json(report, args.out)
    return 0 if report["fault_storm"]["fabricated_results"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
