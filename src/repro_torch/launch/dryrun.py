"""Multi-pod dry-run (counterpart of ``repro.launch.dryrun``): trace every
(architecture x input-shape) cell on the production mesh and record
per-device FLOPs, bytes, collectives, argument bytes and the roofline
terms under one H100's constants.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses.  The port starts a fake world
of 256 or 512 ranks (``launch/mesh.py``), places parameters, optimizer
state and batch as DTensors by the logical-axis rules, traces one step
under ``FakeTensorMode`` and counts what each device dispatches
(``launch/op_stats.py``).  Per-device argument bytes come from the
placements; the peak is the arguments plus the most the traced step held
live at once.  A world is one process's, so ``--both-meshes`` runs the
multi-pod cells in a child process (``--multi-pod`` there), and ``--jobs``
spreads the cells over more children.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--include-densest] [--both-meshes] [--jobs N]
  python -m repro_torch.launch.dryrun --arch ... --shape ... --overrides '{"remat": false}'

Records go to ``--out-dir`` (default ``experiments/dryrun/torch``), one
JSON file a cell and mesh, each naming the chip its constants describe.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    overrides=None,
    out_dir: str = "experiments/dryrun/torch",
    variant: str = "baseline",
):
    from repro_torch.launch import roofline
    from repro_torch.launch.cells import SkipCell, build_cell, trace_cell

    t0 = time.time()
    chip = roofline.H100_SXM
    rec = {
        "arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
        "variant": variant, "overrides": overrides or {},
        "chip": {"name": chip.name, "source": chip.source},
    }
    try:
        cell = build_cell(arch, shape, multi_pod=multi_pod, overrides=overrides)
    except SkipCell as e:
        rec.update(status="skipped", skip_reason=str(e))
        return _write(rec, out_dir, variant)
    try:
        tr = trace_cell(cell)
        t_trace = time.time() - t0
        stats = tr.stats
        rl = roofline.from_stats(
            arch, shape, rec["mesh"], cell.info["n_devices"], stats,
            model_flops=float(cell.info.get("flops_model", 0)), peak_memory=tr.peak_bytes,
            chip=chip,
        )
        rec.update(
            status="ok",
            trace_s=round(t_trace, 1),
            traces=tr.traces,
            trace_note=tr.note,
            memory={
                "argument_bytes": int(sum(tr.arg_bytes.values())),
                "argument_bytes_by_arg": tr.arg_bytes,
                "peak_bytes": int(tr.peak_bytes),
                "fits_device": bool(tr.peak_bytes <= chip.hbm_bytes),
            },
            op_stats={k: v for k, v in stats.items() if k != "by_collective"},
            by_collective=stats.get("by_collective", {}),
            info=cell.info,
            roofline=rl.to_dict(),
        )
    except Exception as e:  # noqa: BLE001 - a cell's failure is its record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-20000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return _write(rec, out_dir, variant)


def _write(rec: dict, out_dir: str, variant: str) -> dict:
    if out_dir:
        from repro_torch.ioutil import atomic_write_file

        os.makedirs(out_dir, exist_ok=True)
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        if variant != "baseline":
            tag += f"__{variant}"
        path = os.path.join(out_dir, tag + ".json")
        atomic_write_file(path, lambda f: json.dump(rec, f, indent=1, default=str), mode="w")
        rec["path"] = path
    return rec


def format_line(rec: dict) -> str:
    status = rec["status"]
    line = (f"[{status:>7}] {rec['arch']} x {rec['shape']} ({rec['mesh']}) "
            f"{rec.get('wall_s', 0)}s")
    if status == "ok":
        rl = rec["roofline"]
        line += (f"  bound={rl['bound']} c/m/x={rl['compute_s']*1e3:.1f}/"
                 f"{rl['memory_s']*1e3:.1f}/{rl['collective_s']*1e3:.1f}ms "
                 f"frac={rl['roofline_fraction']:.1%}")
    elif status == "error":
        line += f"  {rec['error'][:200]}"
    elif status == "skipped":
        line += f"  {rec['skip_reason'][:80]}"
    return line


def _children(args, cells, meshes) -> int:
    """Runs the (cell, mesh) pairs in ``args.jobs`` children, each one
    world; returns the number of errors."""
    work = [(a, s, mp) for mp in meshes for a, s in cells]
    jobs = max(1, min(args.jobs, len(work)))
    groups = [work[i::jobs] for i in range(jobs)]
    procs = []
    for g in groups:
        for mp in sorted({m for _, _, m in g}):
            mine = [f"{a}:{s}" for a, s, m in g if m == mp]
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells", ",".join(mine),
                   "--out-dir", args.out_dir, "--variant", args.variant]
            if mp:
                cmd.append("--multi-pod")
            if args.overrides:
                cmd += ["--overrides", args.overrides]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True))
    failures = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        sys.stdout.flush()
        failures += sum(1 for line in out.splitlines() if line.startswith("[  error]"))
        if p.returncode not in (0, 1):
            failures += 1
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-densest", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--overrides", type=str, default=None)
    ap.add_argument("--variant", type=str, default="baseline")
    ap.add_argument("--out-dir", type=str, default="experiments/dryrun/torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="child processes (each a world of its own)")
    ap.add_argument("--cells", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    overrides = json.loads(args.overrides) if args.overrides else None

    from repro_torch.configs.registry import assigned_cells

    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    elif args.all:
        cells = assigned_cells(include_densest=args.include_densest)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if len(meshes) > 1 or args.jobs > 1:
        sys.exit(1 if _children(args, cells, meshes) else 0)
    failures = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, meshes[0], overrides=overrides, out_dir=args.out_dir,
                       variant=args.variant)
        failures += rec["status"] == "error"
        print(format_line(rec), flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
