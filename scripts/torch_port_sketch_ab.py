#!/usr/bin/env python3
"""K2 (Count-Sketch update) and K3 (l0-sketch update) against their parent
versions on one NVIDIA GPU, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_port_sketch_ab.py --parent build/parent

1. Generates flickr_sm and livejournal_md (chip_smoke.py's shapes) once,
   into ``--out`` (default ``build/sketch_ab``).
2. Kernel variants, timed by CUDA events at the main path's shapes
   (chip_smoke.py's), in turns: K3 parent, this, this, parent; K2 parent
   and this tree's kernel, and cuts of this K2 made by editing a copy of
   its source: ``noflush`` (no flush: the shared adds alone),
   ``flushonly`` (no edge loop; every counter flushed), ``noqueue``
   (folded adds issued where they fold, not queued) and ``nofold`` (no
   run scan: every endpoint adds).  K2 on livejournal_md's first pass in
   stream order, shuffled, and with one hub as every lower endpoint.
   Each variant's atomic instruction forms from its SASS.
3. End to end, each tree in its own process, in turns parent, this, this,
   parent: the flickr_sm churn stream through ``TurnstileDensest`` (apply
   and query, 5 runs) and the livejournal_md ``backend='auto'`` solve (3
   runs, then one under ``torch.profiler`` for K2's device time).

Prints ``nvidia-smi``'s name and power limit first; needs ``nvcc`` and
``cuobjdump`` (as chip_smoke.py does).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K2_SOURCE = Path("src/repro_torch/kernels/count_sketch/csrc/count_sketch.cu")
K3_SOURCE = Path("src/repro_torch/kernels/l0_sampler/csrc/l0_sampler.cu")


def time_ms(fn, n: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[n // 2]


def generate(out: Path) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from repro_torch.graph import generators

    out.mkdir(parents=True, exist_ok=True)
    for name, kw in (("flickr", chip_smoke.FLICKR), ("livejournal", chip_smoke.LIVEJOURNAL)):
        g = generators.chung_lu_power_law(**kw, device="cpu")
        np.savez(out / f"{name}.npz", src=g.src.numpy(), dst=g.dst.numpy(), n=g.n_nodes)


def _load(out: Path, name: str):
    import numpy as np

    from repro_torch.graph.edgelist import from_numpy

    z = np.load(out / f"{name}.npz")
    return from_numpy(z["src"], z["dst"], int(z["n"]), device="cuda")


def _k2_cuts(source: str) -> dict:
    """This K2's source, cut four ways (see the module docstring)."""
    flush = """  for (int i = threadIdx.x; i < win.hi - win.lo; i += kThreads) {
    const float v = cnt[i];
    if (v != 0.0f) atomicAdd(&out[win.lo + i], v);
  }"""
    ballot = "  const uint32_t lead = __ballot_sync(kFull, adds);\n"
    for piece in (flush, ballot, "c < n_chunks;", "if (heads != kFull) {"):
        if piece not in source:
            raise RuntimeError(f"count_sketch.cu has changed: no {piece!r} to cut")
    return {
        "noflush": source.replace(flush, ""),
        "flushonly": source.replace("c < n_chunks;", "c < 0;").replace(
            "if (v != 0.0f) atomicAdd", "atomicAdd"),
        "noqueue": source.replace(
            ballot, "  if (adds) add_endpoint(cnt, p, x, w, win);\n  return;\n" + ballot),
        "nofold": source.replace("if (heads != kFull) {", "if (false) {"),
    }


def kernel_variants(parent: Path, out: Path) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import concurrent.futures

    import torch

    import chip_smoke
    from repro_torch.core.countsketch import make_sketch_params
    from repro_torch.kernels import library_path, load_library
    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.count_sketch.ref import sketch_edges_ref
    from repro_torch.kernels.l0_sampler import ops as l0_ops

    cut_dir = out / "k2_cuts"
    cut_dir.mkdir(parents=True, exist_ok=True)
    k2 = {"parent": parent / K2_SOURCE, "this": cs_ops.SOURCE}
    for name, text in _k2_cuts(cs_ops.SOURCE.read_text()).items():
        k2[name] = cut_dir / f"count_sketch_{name}.cu"
        k2[name].write_text(text)
    k3 = {"parent": parent / K3_SOURCE, "this": l0_ops.SOURCE}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(load_library, [*k2.values(), *k3.values()]))
    pattern = r"\b(?:ATOMS|REDG?|ATOMG?)\.[\w.]+"
    for kernel, paths in (("k2", k2), ("k3", k3)):
        for name, path in paths.items():
            print(f"[sass] {kernel}_{name} {chip_smoke.sass_counts(library_path(path), pattern)}",
                  flush=True)

    def use(ops, path):
        ops.SOURCE = Path(path)
        ops._kernel.cache_clear()

    flickr = _load(out, "flickr")
    rows = chip_smoke.TURNSTILE_BATCH
    src, dst = flickr.src[:rows].contiguous(), flickr.dst[:rows].contiguous()
    ones = torch.ones(rows, dtype=torch.int32, device="cuda")
    p = l0_ops.make_l0_params(n_levels=32, n_cells=1 << 14, n_tables=3, seed=0)
    want = chip_smoke._l0_plain(src, dst, ones, p)
    tables = torch.zeros(l0_ops.l0_sketch_shape(p), dtype=torch.int32, device="cuda")
    u, v, s = l0_ops.canonicalize_edges(src, dst, ones)
    flat = l0_ops.flat_cells(p, u, v)
    fp = l0_ops.hashing.to_i32(l0_ops.edge_fingerprint(p, u, v))
    vals = torch.stack([s, s * u, s * v, s * fp], -1).repeat(p.n_tables, 1)
    flat_tables = tables.view(-1, 4)
    for name in ("parent", "this", "this", "parent"):
        use(l0_ops, k3[name])
        if not torch.equal(l0_ops.l0_delta(src, dst, ones, p), want):
            raise AssertionError(f"K3 {name} != plain version")
        print(f"[k3] {name} kernel_ms={time_ms(lambda: l0_ops.l0_update(tables, src, dst, ones, p))}"
              f" index_add_ms={time_ms(lambda: flat_tables.index_add_(0, flat.reshape(-1), vals))}",
              flush=True)
    use(l0_ops, k3["this"])
    del flickr, tables, flat, vals

    lj = _load(out, "livejournal")
    sp = make_sketch_params(5, 8192, 0)
    w0 = torch.where(lj.mask, lj.weight, 0.0)
    want = sketch_edges_ref(lj.src, lj.dst, w0, sp)
    perm = torch.randperm(lj.n_edges_padded, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
    streams = {"stream": (lj.src, lj.dst, w0),
               "shuffled": (lj.src[perm], lj.dst[perm], w0[perm]),
               "hub": (torch.full_like(lj.src, 7), lj.dst, w0)}
    for name in ("parent", "this", "noqueue", "nofold", "noflush", "flushonly", "this",
                 "parent"):
        use(cs_ops, k2[name])
        if name not in ("noflush", "flushonly") and not torch.equal(
                cs_ops.sketch_edges(lj.src, lj.dst, w0, sp), want):
            raise AssertionError(f"K2 {name} != plain version")
        times = {k: time_ms(lambda: cs_ops.sketch_edges(*st, sp)) for k, st in streams.items()}
        print(f"[k2] {name} " + " ".join(f"{k}_ms={t}" for k, t in times.items()), flush=True)
    use(cs_ops, k2["this"])


def end_to_end(tree: Path, label: str, out: Path) -> None:
    """One tree's churn stream and livejournal_md solve (imports that
    tree's ``repro_torch`` only)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Problem, solve
    from repro_torch.core.turnstile import TurnstileDensest

    res = {"tree": label}
    flickr = _load(out, "flickr")
    m, batch = flickr.n_edges_padded, 1 << 20
    rng = np.random.default_rng(0)
    del_idx = torch.from_numpy(np.sort(rng.choice(m, size=m // 10, replace=False))).cuda()
    dels = (flickr.src[del_idx].contiguous(), flickr.dst[del_idx].contiguous())
    prob = Problem.undirected(eps=0.5, stream_mode="turnstile", backend="pallas")

    def stream():
        td = TurnstileDensest(flickr.n_nodes, prob, device="cuda")
        for i in range(0, m, batch):
            td.apply(insert_edges=(flickr.src[i:i + batch], flickr.dst[i:i + batch]))
        td.apply(delete_edges=dels)
        return td

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        return out_, (time.perf_counter() - t0) * 1e3

    applies, queries = [], []
    for _ in range(5):  # the first run builds the kernels
        td, ms = wall(stream)
        applies.append(ms)
        queries.append(wall(td.query)[1])
    res.update(turnstile_updates=td.sketch.updates_applied, turnstile_apply_ms=applies,
               turnstile_query_ms=queries)
    del flickr, td

    lj = _load(out, "livejournal")
    auto = Problem.undirected(eps=0.5, backend="auto")
    walls = [wall(lambda: solve(lj, auto))[1] for _ in range(3)]  # the first builds K2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = solve(lj, auto)
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)

    rows = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    res.update(livejournal_wall_ms=walls, livejournal_passes=r.passes,
               livejournal_busy_ms=sum(dev_us(ev) for ev in rows) / 1e3,
               livejournal_k2_device_ms=sum(dev_us(ev) for ev in rows
                                            if "count_sketch_kernel" in ev.key) / 1e3)
    print("[e2e] " + json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the parent commit")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sketch_ab")
    ap.add_argument("--phase", choices=["generate", "kernels", "parent", "this"])
    args = ap.parse_args()
    parent, out = args.parent.resolve(), args.out.resolve()
    if args.phase == "generate":
        generate(out)
    elif args.phase == "kernels":
        kernel_variants(parent, out)
    elif args.phase is not None:
        end_to_end(parent if args.phase == "parent" else ROOT, args.phase, out)
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        for phase in ("generate", "kernels", "parent", "this", "this", "parent"):
            subprocess.run([sys.executable, __file__, "--parent", str(parent), "--out", str(out),
                            "--phase", phase], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
