#!/usr/bin/env python3
"""K1 (tiled degrees) and the rung tiling that feeds it against their parent
versions on one NVIDIA GPU, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_port_k1_ab.py --parent build/parent

1. Generates flickr_sm (chip_smoke.py's shape) once, into ``--out``
   (default ``build/k1_ab``).
2. Kernel variants at flickr_sm's first rung (pass-0 weights), timed by
   CUDA events through the wrapper, in turns: parent, this, ``nofold``,
   ``onecopy``, ``alwaysmatch``, ``nocarve``, ``carve75``, ``loadonly``,
   this, parent.
   The parent's kernel gets the
   parent's plan (4,096-slot chunks of every tile, unpadded); this tree's
   kernel and its cuts get this tree's.  The cuts are made by editing a
   copy of this tree's source: ``nofold`` (every slot adds itself; lanes
   that share a bin still add once), ``onecopy`` (all warps of a CTA add
   into one shared histogram with the f32 shared atomic), ``alwaysmatch``
   (steps whose targets never decrease also hold their bins against each
   other with ``__match_any_sync``), ``nocarve``
   (CUDA's default split of shared memory and L1), ``carve75`` (75%
   of the SM as shared memory instead of 50%) and ``loadonly`` (the loads
   and gathers alone: no fold, no adds; its result is wrong by design and
   not checked).  Each variant in stream order and with each tile's slots
   shuffled (a control where runs do not fold), checked bitwise against
   the plain version; each also as the C call alone.  Each variant's atomic and
   warp-exchange instruction forms from its SASS.
3. End to end, each tree in its own process, in turns parent, this, this,
   parent: the rung tiling at the first rung (CUDA events), then the
   flickr_sm ``backend='pallas'`` solve (5 runs: wall and host syncs, then
   one under ``torch.profiler``: device busy, K1's and the tiling's device
   time).

Prints ``nvidia-smi``'s name and power limit first; needs ``nvcc`` and
``cuobjdump`` (as chip_smoke.py does).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K1_SOURCE = Path("src/repro_torch/kernels/peel_degree/csrc/peel_degree.cu")
PARENT_CHUNK_SLOTS = 4096


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
    g = generators.chung_lu_power_law(**chip_smoke.FLICKR, device="cpu")
    np.savez(out / "flickr.npz", src=g.src.numpy(), dst=g.dst.numpy(), n=g.n_nodes)


def _load(out: Path):
    import numpy as np

    from repro_torch.graph.edgelist import from_numpy

    z = np.load(out / "flickr.npz")
    return from_numpy(z["src"], z["dst"], int(z["n"]), device="cuda")


def _k1_cuts(source: str) -> dict:
    """This K1's source, cut six ways (see the module docstring)."""
    always_match = {"const bool distinct = __all_sync(kFull, rising);":
                    "const bool distinct = false;"}
    nofold = {
        "for (int j = 1; j < 4; ++j) s[j] = (k[j] == k[j - 1] ? s[j - 1] : 0.0f) + w[j];":
            "for (int j = 1; j < 4; ++j) s[j] = w[j];",
        "const bool p1 = k[1] == k[0], p2 = p1 && k[2] == k[1], p3 = p2 && k[3] == k[2];":
            "const bool p1 = false, p2 = false, p3 = false;",
        "const bool cont = lane > 0 && k[0] == prev;": "const bool cont = false;",
        "const bool ends[4] = {k[0] != k[1], k[1] != k[2], k[2] != k[3], "
        "lane == 31 || next != k[3]};": "const bool ends[4] = {true, true, true, true};",
        **always_match,  # unfolded runs repeat a bin inside a step's round
    }
    onecopy = {
        "float* h = hist + warp * stride;": "float* h = hist;",
        "if (k >= 0) h[k] += v;": "if (k >= 0) atomicAdd(&h[k], v);",
    }
    carve = "constexpr int kCarveoutPercent = 50;"
    loadonly = {"    add_step(h, k, w, lane);":
                "    h[lane] += w[0] + w[1] + w[2] + w[3] + (float)(k[0] + k[1] + k[2] + k[3]);"}
    cuts = {}
    for name, edits in (("nofold", nofold), ("onecopy", onecopy), ("alwaysmatch", always_match),
                        ("nocarve", {carve: carve.replace("50", "-1")}),
                        ("carve75", {carve: carve.replace("50", "75")}), ("loadonly", loadonly)):
        text = source
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"peel_degree.cu has changed: no {old!r} to cut")
            text = text.replace(old, new)
        cuts[name] = text
    return cuts


def _parent_plan(tiling):
    """The parent's chunk list for the same layout: every tile cut into
    4,096-slot chunks, no padding entries."""
    import torch

    counts = tiling.tile_ptr[1:] - tiling.tile_ptr[:-1]
    n_chunks = (counts + PARENT_CHUNK_SLOTS - 1) // PARENT_CHUNK_SLOTS
    tiles = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), n_chunks)
    rank = torch.arange(tiles.numel(), device=counts.device) - (
        torch.cumsum(n_chunks, 0) - n_chunks)[tiles]
    return dataclasses.replace(
        tiling, chunk_tile=tiles.to(torch.int32).contiguous(),
        chunk_start=(tiling.tile_ptr[tiles] + rank * PARENT_CHUNK_SLOTS).contiguous(),
        chunk_slots=PARENT_CHUNK_SLOTS)


def kernel_variants(parent: Path, out: Path) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import concurrent.futures

    import torch

    import chip_smoke
    from repro_torch.graph.partition import TiledEdges
    from repro_torch.kernels import library_path, load_library
    from repro_torch.kernels.peel_degree import ops as pd_ops
    from repro_torch.kernels.peel_degree.ref import fold_runs, tiled_degrees_ref

    cut_dir = out / "k1_cuts"
    cut_dir.mkdir(parents=True, exist_ok=True)
    k1 = {"parent": parent / K1_SOURCE, "this": pd_ops.SOURCE}
    for name, text in _k1_cuts(pd_ops.SOURCE.read_text()).items():
        k1[name] = cut_dir / f"peel_degree_{name}.cu"
        k1[name].write_text(text)
    with concurrent.futures.ThreadPoolExecutor(len(k1)) as pool:
        list(pool.map(load_library, k1.values()))
    for name, path in k1.items():
        print(f"[sass] k1_{name} " + str(chip_smoke.sass_counts(
            library_path(path), r"\b(?:ATOMS|MATCH|SHFL|VOTE|REDG?|ATOMG?)\.[\w.]+")), flush=True)

    flickr = _load(out)
    n = flickr.n_nodes
    w0 = torch.where(flickr.mask, flickr.weight, 0.0)
    tiling = pd_ops.tiling_for_edges(flickr, tile_size=1024)
    perm = torch.argsort(tiling.tile_of_slot() * tiling.n_slots + torch.randperm(
        tiling.n_slots, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0)))
    shuffled = TiledEdges.from_ragged(
        tiling.tile_ptr, tiling.target_local[perm], tiling.source[perm], tiling.edge_index[perm],
        tile_size=tiling.tile_size, n_nodes=n, n_edges=tiling.n_edges)
    layouts = {"stream": tiling, "shuffled": shuffled}
    print("[plan] " + json.dumps({
        k: {"slots": t.n_slots, "chunk_slots": t.chunk_slots,
            "ctas": int((t.chunk_tile >= 0).sum().item()),
            "parent_ctas": _parent_plan(t).chunk_tile.numel(),
            "fold_adds": int(fold_runs(t, w0)[0].numel())} for k, t in layouts.items()}),
        flush=True)
    want = tiled_degrees_ref(tiling, w0)[:n]
    deg = torch.zeros(tiling.n_tiles * tiling.tile_size, device="cuda")
    for name in ("parent", "this", "nofold", "onecopy", "alwaysmatch", "nocarve", "carve75",
                 "loadonly", "this", "parent"):
        pd_ops.SOURCE = Path(k1[name])
        pd_ops._kernel.cache_clear()
        times = {}
        for lay, t in layouts.items():
            if name == "parent":
                t = _parent_plan(t)
            if name != "loadonly" and not torch.equal(pd_ops.tiled_degrees(t, w0, n_nodes=n),
                                                      want):
                raise AssertionError(f"K1 {name} ({lay}) != plain version")
            times[f"{lay}_ms"] = time_ms(lambda: pd_ops.tiled_degrees(t, w0, n_nodes=n))
            times[f"{lay}_alone_ms"] = time_ms(lambda: pd_ops._launch(t, w0, deg))
        print(f"[k1] {name} " + " ".join(f"{k}={v}" for k, v in times.items()), flush=True)
    pd_ops.SOURCE = Path(k1["this"])
    pd_ops._kernel.cache_clear()


def end_to_end(tree: Path, label: str, out: Path) -> None:
    """One tree's rung tiling and flickr_sm pallas solve (imports that
    tree's ``repro_torch`` only)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import hostsync
    from repro_torch.core import Problem, solve
    from repro_torch.kernels.peel_degree.ops import tiling_for_edges

    res = {"tree": label}
    flickr = _load(out)
    res["tiling_ms"] = time_ms(lambda: tiling_for_edges(flickr, tile_size=1024), n=10)
    prob = Problem.undirected(eps=0.5, backend="pallas", track_history=True)
    walls, syncs = [], []
    for _ in range(5):  # the first run builds K1
        torch.cuda.synchronize()
        hostsync.read.count = 0
        t0 = time.perf_counter()
        r = solve(flickr, prob)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        syncs.append(hostsync.read.count)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(flickr, prob)
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)

    rows = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    res.update(
        flickr_wall_ms=walls, flickr_host_syncs=syncs, passes=r.passes,
        segments=len(r.extras["compaction"]["segments"]),
        busy_ms=sum(dev_us(ev) for ev in rows) / 1e3,
        k1_device_ms=sum(dev_us(ev) for ev in rows if "tiled_degree_kernel" in ev.key) / 1e3,
        top=[(ev.key[:60], ev.count, dev_us(ev) / 1e3)
             for ev in sorted(rows, key=dev_us, reverse=True)[:8]])
    print("[e2e] " + json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the parent commit")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_ab")
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
