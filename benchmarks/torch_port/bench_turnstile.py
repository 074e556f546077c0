"""Turnstile runtime benchmark of the port (counterpart of
``benchmarks/bench_turnstile.py``): sketch update throughput, query latency
and sampled-peel accuracy on churned dynamic streams.

    PYTHONPATH=src python -m benchmarks.torch_port.bench_turnstile [--n 100000] [--trials 12]

The same protocol as the reference: per seeded trial, a power-law graph
with a planted dense block is inserted in ``--batch``-edge batches, then
``--delete-frac`` of it deleted; ``TurnstileDensest.query()`` (host
recovery + sample peel) is timed against the from-scratch repeel it
replaces (``apply_updates`` of the recorded stream, then an exact
``solve()`` of the survivors), and its density held to the MTVV envelope
(1+eps)(2+2eps) around the exact peel's.  A density sweep shows the query
flat while the repeel grows with the live edges.

The reference's ``update_trace_count`` counts compilations of its update
program; nothing compiles here.  In its place each trial records
``k3_launches``, the launches of the kernel K3 (``l0_delta``) during its
updates, beside ``batches_applied`` (so does each sweep point): one launch
a batch on the card, 0 on the CPU (the plain version).  Times are the host clock ending in
``torch.cuda.synchronize()``; the query and repeel figures are the least of
``--query-repeats`` warm runs, the summary their p50 over trials 2+, as in
the reference.  Writes experiments/bench/torch/BENCH_turnstile.json.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from benchmarks.torch_port import common
from repro_torch.core import Problem, Solver
from repro_torch.core.turnstile import TurnstileDensest
from repro_torch.graph.edgelist import apply_updates, from_numpy
from repro_torch.graph.generators import planted_dense_subgraph
from repro_torch.kernels.l0_sampler.ops import l0_delta


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--planted-k", type=int, default=300)
    ap.add_argument("--planted-p", type=float, default=0.4)
    ap.add_argument("--delete-frac", type=float, default=0.25,
                    help="churn: fraction of the stream deleted (>= 0.2)")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--eps", type=float, default=0.3)
    ap.add_argument("--sample-edges", type=int, default=1 << 14,
                    help="l0 sample budget tau (per-query peel size)")
    ap.add_argument("--batch", type=int, default=1 << 16,
                    help="update batch size fed to the sketch")
    ap.add_argument("--query-repeats", type=int, default=3)
    ap.add_argument("--scaling-deg", default="8,16,32",
                    help="comma list of avg degrees for the scaling sweep "
                         "(query flat, repeel linear in m)")
    ap.add_argument("--out", default=common.out_path("BENCH_turnstile.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _churn(args, deg: float, seed: int, del_seed: int, dev):
    """The stream's host arrays, its deletes and the inserted graph on ``dev``."""
    g, _ = planted_dense_subgraph(args.n, deg, args.planted_k, args.planted_p, seed=seed,
                                  device="cpu")
    m = int(g.mask.sum())
    src = g.src[:m].numpy().copy()
    dst = g.dst[:m].numpy().copy()
    rng = np.random.default_rng(del_seed)
    del_idx = rng.choice(m, size=int(args.delete_frac * m), replace=False)
    deletes = np.stack([src[del_idx], dst[del_idx]], axis=1)
    return src, dst, deletes, from_numpy(src, dst, args.n, device=dev)


def _feed(args, td, src, dst, deletes, dev) -> float:
    """Inserts the stream, then the deletes, in ``--batch`` batches; seconds."""
    common.sync(dev)
    t0 = time.perf_counter()
    for lo in range(0, len(src), args.batch):
        td.apply(insert_edges=(src[lo:lo + args.batch], dst[lo:lo + args.batch]))
    for lo in range(0, len(deletes), args.batch):
        td.apply(delete_edges=(deletes[lo:lo + args.batch, 0],
                               deletes[lo:lo + args.batch, 1]))
    common.sync(dev)
    return time.perf_counter() - t0


def _best(fn, dev, repeats: int):
    best, out = None, None
    for _ in range(repeats):
        wall, out = common.timed(fn, dev)
        best = wall if best is None else min(best, wall)
    return best, out


def run(args, graph=None) -> dict:
    dev = common.device_of(args)
    envelope = (1 + args.eps) * (2 + 2 * args.eps)
    prob_exact = Problem.undirected(eps=args.eps, compaction="off")
    solver = Solver()

    def sketch(seed):
        return TurnstileDensest(
            args.n,
            Problem.undirected(eps=args.eps, compaction="off", stream_mode="turnstile",
                               sample_edges=args.sample_edges, sketch_seed=seed),
            solver=solver, device=dev,
        )

    trials = []
    update_walls, query_walls, repeel_walls, ratios = [], [], [], []
    for trial in range(args.trials):
        src, dst, deletes, base = _churn(args, args.avg_deg, trial, 10_000 + trial, dev)
        m, n_del = len(src), len(deletes)
        final, stats = apply_updates(base, deletes=deletes)
        assert stats["missing_deletes"] == 0
        td = sketch(trial)
        launches0 = l0_delta.launches
        upd_wall = _feed(args, td, src, dst, deletes, dev)
        k3 = l0_delta.launches - launches0
        q_best, res = _best(td.query, dev, args.query_repeats)

        def repeel():
            survivors, _ = apply_updates(base, deletes=deletes)
            out = solver.solve(survivors, prob_exact)
            float(out.best_density)
            return out

        r_best, exact = _best(repeel, dev, args.query_repeats)
        info = res.extras["turnstile"]
        ratio = float(res.best_density) / float(exact.best_density)
        trials.append({
            "seed": trial,
            "m_inserted": m,
            "m_deleted": n_del,
            "m_live": int(final.mask.sum()),
            "update_wall_s": round(upd_wall, 4),
            "query_s": round(q_best, 4),
            "exact_repeel_s": round(r_best, 4),
            "sample_level": info["level"],
            "sample_edges_recovered": info["sample_edges_recovered"],
            "recovery_failures": info["recovery_failures"],
            "density_turnstile": round(float(res.best_density), 4),
            "density_exact_peel": round(float(exact.best_density), 4),
            "ratio": round(ratio, 4),
            "in_envelope": bool(1.0 / envelope <= ratio <= envelope),
            "batches_applied": td.sketch.batches_applied,
            "k3_launches": k3,
        })
        print(f"trial {trial}: {trials[-1]}")
        if trial > 0:  # as in the reference: trial 0 pays the first-use costs
            update_walls.append((upd_wall, m + n_del))
            query_walls.append(q_best)
            repeel_walls.append(r_best)
        ratios.append(ratio)

    scaling = []
    for deg in [float(x) for x in args.scaling_deg.split(",") if x]:
        src, dst, deletes, base = _churn(args, deg, 0, 77, dev)
        td = sketch(0)
        launches0 = l0_delta.launches
        _feed(args, td, src, dst, deletes, dev)
        k3 = l0_delta.launches - launches0
        q_best, _ = _best(td.query, dev, args.query_repeats)

        def repeel():
            survivors, _ = apply_updates(base, deletes=deletes)
            return float(solver.solve(survivors, prob_exact).best_density)

        r_best, _ = _best(repeel, dev, args.query_repeats)
        scaling.append({
            "avg_deg": deg,
            "m_live": len(src) - len(deletes),
            "query_s": round(q_best, 4),
            "exact_repeel_s": round(r_best, 4),
            "speedup_x": round(r_best / max(q_best, 1e-9), 1),
            "batches_applied": td.sketch.batches_applied,
            "k3_launches": k3,
        })
        print(f"scaling: {scaling[-1]}")

    q50 = common.pct(query_walls, 50) if query_walls else float("nan")
    r50 = common.pct(repeel_walls, 50) if repeel_walls else float("nan")
    top = max(scaling, key=lambda s: s["m_live"]) if scaling else None
    report = {
        "device": common.device_record(dev),
        "config": {
            "n_nodes": args.n,
            "avg_deg": args.avg_deg,
            "planted_k": args.planted_k,
            "planted_p": args.planted_p,
            "delete_frac": args.delete_frac,
            "trials": args.trials,
            "eps": args.eps,
            "sample_edges": args.sample_edges,
            "batch": args.batch,
            "scaling_deg": args.scaling_deg,
        },
        "statistic": (f"per trial: least of {args.query_repeats} warm runs; "
                      "summary: p50 over trials 2+"),
        "update_throughput": {
            "edges_per_s": round(sum(k for _, k in update_walls)
                                 / max(sum(w for w, _ in update_walls), 1e-9), 1),
            "steady_state_trials": len(update_walls),
        },
        "query": {
            "p50_s": round(q50, 4),
            "exact_repeel_p50_s": round(r50, 4),
            "trial_speedup_x": round(r50 / max(q50, 1e-9), 1),
            "query_speedup_x": (top["speedup_x"] if top
                                else round(r50 / max(q50, 1e-9), 1)),
        },
        "scaling": scaling,
        "accuracy": {
            "envelope": round(envelope, 4),
            "envelope_pass_rate": round(sum(t["in_envelope"] for t in trials) / len(trials), 4),
            "ratio_min": round(min(ratios), 4),
            "ratio_max": round(max(ratios), 4),
        },
        "trials": trials,
    }
    print("update_throughput:", report["update_throughput"])
    print("query:", report["query"])
    print("accuracy:", report["accuracy"])
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    common.write_json(run(args), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
