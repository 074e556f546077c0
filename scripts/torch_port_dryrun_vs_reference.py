"""The port's dry-run counts against the reference's compiled HLO, cell by
cell, on a small mesh.

    PYTHONPATH=src python scripts/torch_port_dryrun_vs_reference.py \
        [--mesh 2,4] [--cells llama3.2-3b:train_4k,...] [--out FILE]

Runs the reference (``repro.launch.cells.lower_cell`` compiled on forced
host devices, ``hlo_stats.analyze``; JAX on the CPU) and the port
(``repro_torch.launch.cells.trace_cell`` on a fake world) each in a child
process, and prints per cell and device: FLOPs (all of the reference's,
and its dot FLOPs alone, the port's figure's counterpart), HBM bytes and
collective bytes of both, and their ratios.  Nothing runs on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_CELLS = ("llama3.2-3b:train_4k,graphsage-reddit:ogb_products,"
                 "two-tower-retrieval:serve_p99,densest-mapreduce:flickr_sm")

_REF = r"""
import os, sys
shape = tuple(int(x) for x in sys.argv[1].split(","))
n = 1
for s in shape:
    n *= s
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import json
from repro.launch import hlo_stats
from repro.launch.cells import build_cell, lower_cell
from repro.launch.mesh import make_mesh

def dot_flops(hlo):
    comps = hlo_stats.parse_computations(hlo)
    entry = [ln for ln in hlo.splitlines() if ln.startswith("ENTRY")][0]
    entry = hlo_stats._COMP_RE.match(entry.strip()).group(1)
    mult, order = {entry: 1.0}, [entry]
    while order:
        comp = order.pop(0)
        for ins in comps.get(comp, []):
            subs, k = [], mult[comp]
            if ins.opcode == "while":
                m = hlo_stats._COND_BODY_RE.search(ins.line)
                if m:
                    k *= hlo_stats._trip_count(comps.get(m.group(1), []), comps) or 1
                    subs = [m.group(2)]
            elif ins.opcode in ("call", "fusion", "conditional"):
                m = hlo_stats._TO_APPLY_RE.search(ins.line) or hlo_stats._CALLS_RE.search(ins.line)
                subs = [m.group(1)] if m else []
            for s in subs:
                if s not in mult:
                    order.append(s)
                mult[s] = mult.get(s, 0.0) + k
    return sum(mult.get(c, 0.0) * sum(hlo_stats._dot_flops(i, {j.name: j.result_dims for j in ins})
                                      for i in ins if i.opcode == "dot")
               for c, ins in comps.items())

axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
mesh = make_mesh(shape, axes)
out = {}
for cell in sys.argv[2].split(","):
    arch, sh = cell.split(":")
    hlo = lower_cell(build_cell(arch, sh, mesh=mesh)).compile().as_text()
    st = hlo_stats.analyze(hlo, n)
    out[cell] = {"flops": st["flops"], "dot_flops": dot_flops(hlo), "hbm": st["hbm_bytes"],
                 "coll": st["collective_bytes"]}
print("RESULT=" + json.dumps(out))
"""

_PORT = r"""
import json, sys
from repro_torch.launch.cells import build_cell, trace_cell
from repro_torch.launch.mesh import make_mesh
shape = tuple(int(x) for x in sys.argv[1].split(","))
mesh = make_mesh(shape, ("data", "model") if len(shape) == 2 else ("pod", "data", "model"))
out = {}
for cell in sys.argv[2].split(","):
    arch, sh = cell.split(":")
    st = trace_cell(build_cell(arch, sh, mesh=mesh)).stats
    out[cell] = {"flops": st["flops"], "hbm": st["hbm_bytes"], "coll": st["collective_bytes"]}
print("RESULT=" + json.dumps(out))
"""


def _child(code: str, *argv: str) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                         env=env)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT=")]
    if not line:
        raise RuntimeError(res.stderr[-4000:])
    return json.loads(line[-1][len("RESULT="):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,4")
    ap.add_argument("--cells", default=DEFAULT_CELLS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ref = _child(_REF, args.mesh, args.cells)
    port = _child(_PORT, args.mesh, args.cells)
    rows = {}
    for cell in args.cells.split(","):
        r, p = ref[cell], port[cell]
        ratio = lambda a, b: (a / b) if b else None  # noqa: E731
        rows[cell] = {"reference": r, "port": p,
                      "dot_flops_ratio": ratio(p["flops"], r["dot_flops"]),
                      "hbm_ratio": ratio(p["hbm"], r["hbm"]),
                      "coll_ratio": ratio(p["coll"], r["coll"])}
        print(f"{cell}: port/ref dot FLOPs {rows[cell]['dot_flops_ratio']}, "
              f"HBM bytes {rows[cell]['hbm_ratio']}, collective bytes "
              f"{rows[cell]['coll_ratio']}  (ref {r}, port {p})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mesh": args.mesh, "cells": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
