"""Compaction-runtime benchmark of the port (counterpart of
``benchmarks/bench_peel_compaction.py``): passes x edge slots scanned and
wall-clock for ``compaction in (off, twophase, geometric)`` on power-law
graphs, then the mesh substrate's two geometric schedules (the host
gather/reshard ladder, ``Solver._run_compacted`` with a mesh, vs the
collective-only ladder ``Solver._mesh_ladder``).  Run with::

    PYTHONPATH=src python -m benchmarks.torch_port.bench_peel_compaction [--n 200000]
    PYTHONPATH=src python -m benchmarks.torch_port.bench_peel_compaction --shape flickr_sm

Writes experiments/bench/torch/BENCH_peel.json with, per eps, each mode's
passes, slots scanned, warm wall (least of ``--repeats`` runs, host clock
ending in ``torch.cuda.synchronize()``), the reduction factors against
'off' and a bit-identity flag (best set, density and passes equal to
'off'), and a ``mesh`` block.

The reference's collective ladder is one XLA program and reports
``host_round_trips: 0``.  The port's reads one host sync a pass (the pass
loop's continuation test), so the mesh block reports, for one run of each
ladder, ``host_syncs`` (``hostsync.read.count``) and the collectives
(``repro_torch.collectives``: calls and bytes on the wire) in its place.
The mesh is the caller's (``run(args, mesh=...)``) or one that this
module starts over the running world (one rank outside ``torchrun``) and
destroys before it returns.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

from benchmarks.torch_port import common
from benchmarks.torch_port.bench_engine import PEEL_SHAPES
from repro_torch import collectives, hostsync
from repro_torch.configs.densest_mapreduce import chung_lu_args
from repro_torch.core import Problem, Solver, make_mesh
from repro_torch.graph.generators import chung_lu_power_law


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--avg-deg", type=float, default=10.0)
    ap.add_argument("--exponent", type=float, default=2.0)
    ap.add_argument("--shape", choices=PEEL_SHAPES, default=None,
                    help="draw the config's graph of this shape instead of --n")
    ap.add_argument("--eps", type=float, nargs="+", default=[0.1, 0.5])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=common.out_path("BENCH_peel.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _same(a, b) -> bool:
    return (torch.equal(a.best_alive.cpu(), b.best_alive.cpu())
            and float(a.best_density) == float(b.best_density)
            and int(a.passes) == int(b.passes))


def _counted(fn):
    """One call of ``fn`` with the host syncs and collectives it made."""
    hostsync.read.count = 0
    collectives.reset()
    out = fn()
    return out, {
        "host_syncs": hostsync.read.count,
        "collectives": {
            "all_reduce": collectives.all_reduce.count,
            "all_reduce_bytes": collectives.all_reduce.bytes,
            "all_gather": collectives.all_gather.count,
            "all_gather_bytes": collectives.all_gather.bytes,
        },
    }


def _mesh_block(args, dev, edges, eps, ref, solver, mesh) -> dict:
    prob_mesh = Problem.undirected(eps=eps, substrate="mesh", compaction="geometric")
    resolved = prob_mesh.resolve(edges.n_nodes, have_mesh=True)
    held = {}

    def host_ladder():
        out, held["ladder"] = solver._run_compacted(edges, resolved, mesh=mesh)
        return out

    wall_host, out_host = common.best_of(host_ladder, dev, args.repeats)
    host_ladder_report = held["ladder"]
    wall_prog, res_prog = common.best_of(
        lambda: solver.solve(edges, prob_mesh, mesh=mesh), dev, args.repeats)
    wall_moff, _ = common.best_of(
        lambda: solver.solve(edges, Problem.undirected(eps=eps, substrate="mesh",
                                                        compaction="off"), mesh=mesh),
        dev, args.repeats)
    _, host_counts = _counted(host_ladder)
    _, prog_counts = _counted(lambda: solver.solve(edges, prob_mesh, mesh=mesh))
    lad_prog = res_prog.extras["compaction"]
    return {
        "ranks": int(mesh.size()),
        "off": {"wall_s": round(wall_moff, 4)},
        "host_ladder": {
            "wall_s": round(wall_host, 4),
            "host_round_trips": host_ladder_report["host_round_trips"],
            "segments": len(host_ladder_report["segments"]),
            **host_counts,
        },
        "collective_ladder": {
            "wall_s": round(wall_prog, 4),
            "segments": len(lad_prog["segments"]),
            "edge_slots_scanned": int(lad_prog["edge_slots_scanned"]),
            **prog_counts,
        },
        "wall_vs_host_ladder_x": round(wall_host / max(wall_prog, 1e-9), 2),
        "wall_vs_mesh_off_x": round(wall_moff / max(wall_prog, 1e-9), 2),
        "bit_identical_to_off": (_same(res_prog, ref)
                                 and torch.equal(out_host.best_alive.cpu(),
                                                 res_prog.best_alive.cpu())),
    }


def run(args, graph=None, mesh=None) -> dict:
    dev = common.device_of(args)
    if graph is not None:
        edges = graph
    elif args.shape is not None:
        edges = chung_lu_power_law(**chung_lu_args(args.shape), device=dev)
    else:
        edges = chung_lu_power_law(args.n, exponent=args.exponent, avg_deg=args.avg_deg,
                                   seed=0, device=dev)
    m_pad = edges.n_edges_padded
    report = {
        "device": common.device_record(dev),
        "graph": {
            "family": "chung_lu_power_law",
            "shape": args.shape,
            "n_nodes": edges.n_nodes,
            "n_edges": int(edges.num_real_edges()),
            "n_edges_padded": m_pad,
            "exponent": args.exponent if args.shape is None else None,
            "avg_deg": args.avg_deg if args.shape is None else None,
        },
        "backend": "exact",
        "substrate": "jit",
        "statistic": f"wall_s: least of {args.repeats} warm runs",
        "eps": {},
    }
    started = mesh is None and not dist.is_initialized()
    if mesh is None:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        mesh = make_mesh((world,), ("data",), device=dev)
    try:
        for eps in args.eps:
            solver = Solver()
            rows = {}
            ref = None
            for mode in ("off", "twophase", "geometric"):
                prob = Problem.undirected(eps=eps, compaction=mode)
                wall, res = common.best_of(lambda p=prob: solver.solve(edges, p), dev,
                                           args.repeats)
                passes = int(res.passes)
                if mode == "off":
                    slots, segments = passes * m_pad, 1
                else:
                    lad = res.extras["compaction"]
                    slots = int(lad["edge_slots_scanned"])
                    segments = len(lad["segments"])
                identical = ref is None or _same(res, ref)
                ref = ref if ref is not None else res
                rows[mode] = {
                    "passes": passes,
                    "segments": segments,
                    "edge_slots_scanned": slots,
                    "wall_s": round(wall, 4),
                    "rho": round(float(res.best_density), 4),
                    "bit_identical_to_off": identical,
                }
                print(f"eps={eps} {mode}: {rows[mode]}")
            off = rows["off"]
            for mode in ("twophase", "geometric"):
                rows[mode]["slots_reduction_x"] = round(
                    off["edge_slots_scanned"] / max(rows[mode]["edge_slots_scanned"], 1), 2)
                rows[mode]["wall_speedup_x"] = round(
                    off["wall_s"] / max(rows[mode]["wall_s"], 1e-9), 2)
            rows["mesh"] = _mesh_block(args, dev, edges, eps, ref, solver, mesh)
            print(f"eps={eps} mesh: {rows['mesh']}")
            report["eps"][str(eps)] = rows
    finally:
        if started:
            dist.destroy_process_group()
    return report


def identical(report: dict) -> bool:
    """Every mode and the mesh ladders bit-identical to 'off', every eps."""
    return all(r[m]["bit_identical_to_off"] for r in report["eps"].values()
               for m in ("off", "twophase", "geometric", "mesh"))


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run(args)
    common.write_json(report, args.out)
    return 0 if identical(report) else 1


if __name__ == "__main__":
    sys.exit(main())
