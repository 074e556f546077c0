"""Markdown tables from the dry-run's records (counterpart of
``repro.launch.report``), ``experiments/dryrun/torch/*.json``.

``python -m repro_torch.launch.report`` prints the dry-run table (both
meshes), the single-pod roofline table under the records' chip constants,
and a sorted summary used to pick the hillclimb cells.  The figures are
predictions from the traced step's counts and the chip's published rates,
not measurements.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from repro_torch.ioutil import atomic_write_file


def load(out_dir: str = "experiments/dryrun/torch", variant: str | None = "baseline") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if variant is not None and r.get("variant", "baseline") != variant:
            continue
        recs.append(r)
    return recs


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def roofline_table(recs: List[Dict], mesh: str = "16x16") -> str:
    head = (
        "| arch | shape | compute_s | memory_s | collective_s | bound | "
        "GFLOP/dev | coll GB/dev | peak GiB/dev | model/counted FLOPs | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|"
    )
    lines = [head]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | — | — | — | — | — |"
            )
            continue
        rl = r["roofline"]
        peak = r.get("memory", {}).get("peak_bytes")
        lines.append(
            "| {a} | {s} | {c:.3f} | {m:.3f} | {x:.3f} | {b} | {gf:.0f} | {cb:.2f} | {pk} | {ra:.2f} | {fr:.1%} |".format(
                a=r["arch"], s=r["shape"],
                c=rl["compute_s"], m=rl["memory_s"], x=rl["collective_s"],
                b=rl["bound"], gf=rl["flops_per_dev"] / 1e9,
                cb=rl["coll_bytes_per_dev"] / 1e9,
                pk=fmt_bytes(peak), ra=rl["model_flops_ratio"],
                fr=rl["roofline_fraction"],
            )
        )
    return "\n".join(lines)


def compact_table(recs: List[Dict], mesh: str = "16x16") -> str:
    """One row an arch, one column a shape: each cell's bound and its
    compute / memory / collective terms in ms ("skip" for a skipped
    cell), the roofline table in a page."""
    rows: Dict[str, Dict[str, str]] = {}
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "ok":
            rl = r["roofline"]
            cell = (f"{rl['bound'][:4]} {rl['compute_s']*1e3:.3g}/{rl['memory_s']*1e3:.3g}/"
                    f"{rl['collective_s']*1e3:.3g}")
        else:
            cell = "skip" if r["status"] == "skipped" else "ERROR"
        rows.setdefault(r["arch"], {})[r["shape"]] = cell
    lines = ["| arch | cells: shape bound c/m/x ms |", "|---|---|"]
    for arch, cells in rows.items():
        lines.append(f"| {arch} | " + "; ".join(f"{k} {v}" for k, v in cells.items()) + " |")
    return "\n".join(lines)


def dryrun_table(recs: List[Dict]) -> str:
    head = (
        "| arch | shape | mesh | status | trace_s | args GiB/dev | peak GiB/dev | "
        "collectives (count) |\n|---|---|---|---|---|---|---|---|"
    )
    lines = [head]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped ({r['skip_reason'][:40]}…) | — | — | — | — |"
            )
            continue
        mem = r.get("memory", {})
        hs = r.get("op_stats", {})
        lines.append(
            "| {a} | {s} | {m} | {st} | {cs} | {ag} | {tp} | {cc:.0f} |".format(
                a=r["arch"], s=r["shape"], m=r["mesh"], st=r["status"],
                cs=r.get("trace_s", "-"),
                ag=fmt_bytes(mem.get("argument_bytes")),
                tp=fmt_bytes(mem.get("peak_bytes")),
                cc=hs.get("collective_count", 0),
            )
        )
    return "\n".join(lines)


def pick_hillclimb(recs: List[Dict]) -> List[Dict]:
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "16x16"]
    by_frac = sorted(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    by_coll = sorted(
        ok,
        key=lambda r: -(
            r["roofline"]["collective_s"]
            / max(r["roofline"]["step_time_s"], 1e-12)
        ),
    )
    return {
        "worst_fraction": [
            (r["arch"], r["shape"], f"{r['roofline']['roofline_fraction']:.2%}")
            for r in by_frac[:8]
        ],
        "most_collective_bound": [
            (r["arch"], r["shape"],
             f"coll/total={r['roofline']['collective_s']/max(r['roofline']['step_time_s'],1e-12):.2f}",
             f"frac={r['roofline']['roofline_fraction']:.2%}")
            for r in by_coll[:8]
        ],
    }


def generate(out_dir: str = "experiments/dryrun/torch") -> str:
    recs = load(out_dir)
    variants = load(out_dir, variant=None)
    named = [r for r in variants if r.get("variant", "baseline") != "baseline"]
    parts = [
        "### Dry-run: all cells x both meshes\n",
        dryrun_table(recs),
        "\n### Roofline terms (single-pod 16x16, current defaults)\n",
        roofline_table(recs, "16x16"),
    ]
    if named:
        parts.append("\n### Saved perf variants\n")
        parts.append(roofline_table(named, "16x16").replace(
            "| arch |", "| arch(variant) |"
        ))
        # annotate variant names
        lines = parts[-1].splitlines()
        out = lines[:2]
        vi = 0
        for r in named:
            if r["mesh"] != "16x16":
                continue
            row = lines[2 + vi]
            out.append(row.replace(
                f"| {r['arch']} |", f"| {r['arch']} ({r['variant']}) |", 1
            ))
            vi += 1
        parts[-1] = "\n".join(out)
    return "\n".join(parts)


def inject(path: str, out_dir: str = "experiments/dryrun/torch"):
    begin, end = "<!-- GENERATED:BEGIN -->", "<!-- GENERATED:END -->"
    with open(path) as f:
        doc = f.read()
    pre = doc.split(begin)[0]
    post = doc.split(end)[1]
    body = pre + begin + "\n" + generate(out_dir) + "\n" + end + post
    atomic_write_file(path, lambda f: f.write(body), mode="w")
    print(f"injected tables into {path}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="experiments/dryrun/torch")
    ap.add_argument("--inject", default=None, help="a markdown file with GENERATED markers")
    ap.add_argument("--compact", action="store_true",
                    help="only the single-pod roofline, one row an arch")
    args = ap.parse_args(argv)
    if args.inject:
        inject(args.inject, args.out_dir)
        return
    recs = load(args.out_dir)
    if args.compact:
        print(compact_table(recs))
        return
    chips = sorted({r.get("chip", {}).get("name", "?") for r in recs if r["status"] == "ok"})
    print(f"## Dry-run (both meshes); roofline constants: {', '.join(chips)}\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16), a prediction\n")
    print(roofline_table(recs, "16x16"))
    print("\n## Hillclimb candidates\n")
    print(json.dumps(pick_hillclimb(recs), indent=1))


if __name__ == "__main__":
    main()
