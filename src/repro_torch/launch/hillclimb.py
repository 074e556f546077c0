"""Perf-iteration driver (counterpart of ``repro.launch.hillclimb``): trace
one cell (with overrides), print the three roofline terms and the top
ops by executed bytes, FLOPs and wire bytes, each op with the line of the
port's code that dispatched it: the evidence each hypothesis -> change ->
measure cycle reads.

  python -m repro_torch.launch.hillclimb --arch qwen2-72b --shape train_4k \
      [--overrides '{"rules": {"embed": null}}'] [--top 12]

Like the dry-run, it starts a fake world, so it runs in a process of its
own (``launch/mesh.py``).
"""

from __future__ import annotations

import argparse
import json


def top_ops(per_op, top: int = 12, key: str = "bytes"):
    """(name @ site, row) of the ``top`` ops by ``key`` ('bytes', 'flops'
    or 'collective_bytes'), loop trip counts included."""
    from repro_torch.launch import op_stats

    return op_stats.top_ops(per_op, top, key)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--overrides", type=str, default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--save", default=None, help="also persist a dry-run record under this variant")
    args = ap.parse_args(argv)

    overrides = json.loads(args.overrides) if args.overrides else None
    from repro_torch.launch import roofline
    from repro_torch.launch.cells import build_cell, trace_cell

    cell = build_cell(args.arch, args.shape, multi_pod=args.multi_pod, overrides=overrides)
    tr = trace_cell(cell, sites=True)
    rl = roofline.from_stats(
        args.arch, args.shape, cell.info["mesh"], cell.info["n_devices"], tr.stats,
        model_flops=float(cell.info.get("flops_model", 0)), peak_memory=tr.peak_bytes,
    )
    print(f"chip constants: {rl.chip.name}")
    print(
        f"terms_s compute={rl.compute_s:.3f} memory={rl.memory_s:.3f} "
        f"collective={rl.collective_s:.3f} bound={rl.bound} "
        f"model/counted={rl.model_flops_ratio:.3f} frac={rl.roofline_fraction:.2%}"
    )
    print(f"mem/dev GiB: args={sum(tr.arg_bytes.values()) / 2**30:.2f} "
          f"peak={tr.peak_bytes / 2**30:.2f}")
    print("by_collective GB/dev:",
          {k: round(v / 1e9, 1) for k, v in tr.stats["by_collective"].items()})
    for key, unit, scale in (("collective_bytes", "GB", 1e9), ("bytes", "GB", 1e9),
                             ("flops", "GFLOP", 1e9)):
        print(f"top ops by {key} ({unit}/dev):")
        for name, row in top_ops(tr.per_op, args.top, key):
            print(f"  {row[key] / scale:10.2f} x{row['count']:<7.0f} {name}")
    if args.save:
        from repro_torch.launch.dryrun import run_cell

        run_cell(args.arch, args.shape, args.multi_pod, overrides=overrides, variant=args.save)


if __name__ == "__main__":
    main()
