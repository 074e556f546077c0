#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, then drives the port's main
path, ``solve(edges, Problem.undirected(eps, backend='pallas'))`` on the
geometric compaction ladder, on the README quickstart graph, on a 200k-node
Chung-Lu graph and at FLICKR scale (976k nodes, 7.6M edges drawn, Chung-Lu
with exponent 2.2, seed 0).  Answers are checked against the exact backend,
the port on the CPU and the JAX package's golden fixture
(tests/fixtures/torch_port/golden.json).  Any failed check raises, so the
exit code is not 0.

Output: the torch/CUDA versions and ``nvidia-smi``'s name and power limit
first; then one line per phase; then, on the line before the last, the
kernels' JSON record (launches on the FLICKR main-path run, error against
the plain version, median times from CUDA events, the memory bound); last,
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
EPS = 0.5
FLICKR = dict(n=976_000, exponent=2.2, avg_deg=2 * 7.6e6 / 976_000, seed=0)
TIMED_LAUNCHES = 30


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def time_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def check_equal(what: str, got, want) -> float:
    """Bitwise equality of two float tensors; returns the max abs error (0)."""
    import torch

    if not torch.equal(got, want):
        err = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{what}: kernel != plain version (max abs err {err})")
    return 0.0


def check_close(what: str, got, want) -> float:
    """rtol/atol 1e-5: float weights are summed in another order."""
    import torch

    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=what)
    return (got.double() - want.double()).abs().max().item()


def kernel_bound_ms(tiling, n_edges: int) -> float:
    """Least time on the card: every input byte read once (target_local,
    edge_index, the chunk list, tile_ptr, w_alive), the output written once,
    over HBM bandwidth.  The adds are far below the compute peak."""
    bytes_moved = (
        tiling.n_slots * 8
        + tiling.chunk_tile.numel() * 12
        + tiling.tile_ptr.numel() * 8
        + n_edges * 4
        + tiling.n_tiles * tiling.tile_size * 4
    )
    return bytes_moved / HBM_BYTES_PER_S * 1e3


def phase_environment() -> str:
    import torch

    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, devices=torch.cuda.device_count())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import BUILD_LOG, load_library
    from repro_torch.kernels.peel_degree import ops

    t0 = time.perf_counter()
    load_library(ops.SOURCE)
    info = BUILD_LOG.get(ops.SOURCE.name, {"seconds": 0.0, "ptxas": "(cached build)"})
    log("build", source=ops.SOURCE.relative_to(ROOT), seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(info["seconds"], 3))
    for line in str(info["ptxas"]).splitlines():
        print(f"  {line}", flush=True)


def _adversarial_cases(dev):
    """(name, tiling, w, n_nodes) layouts the kernel must get right."""
    import numpy as np
    import torch

    from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile

    rng = np.random.default_rng(1)
    cases = []

    def add(name, src, dst, n, tile_size):
        s = torch.from_numpy(src.astype(np.int32)).to(dev)
        d = torch.from_numpy(dst.astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(0, 4, len(src)).astype(np.float32)).to(dev)
        cases.append((name, bucket_edges_by_tile(s, d, n, tile_size=tile_size), w, n))

    for tile_size in (128, 1024):
        n = 50_000
        hub = rng.integers(0, 8, 400_000)  # one hub tile holds most slots
        add(f"hub_tile_t{tile_size}", hub, rng.integers(0, n, 400_000), n, tile_size)
        lo, hi = rng.integers(0, 1000, 20_000), rng.integers(n - 1000, n, 20_000)
        add(f"empty_tiles_t{tile_size}", lo, hi, n, tile_size)
        n_odd = 10_007  # not a multiple of the tile size
        add(f"ragged_n_t{tile_size}", rng.integers(0, n_odd, 30_000),
            rng.integers(0, n_odd, 30_000), n_odd, tile_size)
    # The reference's dense layout, padding slots included, under both of
    # its padding conventions.
    name, base, w, n = cases[-1]
    for pad_tl, pad_ei in ((0, -1), (-1, -1), (-1, 0)):
        tl, sg, ei = base.to_dense(512)
        pad = ei < 0
        tl[pad], ei[pad] = pad_tl, pad_ei
        n_tiles, width = tl.shape
        dense = TiledEdges.from_ragged(
            torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) * width,
            tl.reshape(-1), sg.reshape(-1), ei.reshape(-1),
            tile_size=base.tile_size, n_nodes=n, n_edges=base.n_edges,
        )
        cases.append((f"dense_pad_tl{pad_tl}_ei{pad_ei}", dense, w, n))
    return cases


def phase_kernel(flickr) -> dict:
    """K1 against its plain version on the card, at the main path's shapes
    (FLICKR's first rung) and on adversarial layouts."""
    import numpy as np
    import torch

    from repro_torch.core.engine import segment_degree_count, undirected_pass_step
    from repro_torch.kernels.peel_degree.ops import tiled_degrees, tiling_for_edges
    from repro_torch.kernels.peel_degree.ref import tiled_degrees_ref

    dev = flickr.device
    n, e = flickr.n_nodes, flickr.n_edges_padded
    t0 = time.perf_counter()
    tiling = tiling_for_edges(flickr, tile_size=1024)
    torch.cuda.synchronize()
    log("kernel.tiling", n_nodes=n, n_edges=e, slots=tiling.n_slots, tiles=tiling.n_tiles,
        chunks=tiling.chunk_tile.numel(),
        hub_tile_slots=int((tiling.tile_ptr[1] - tiling.tile_ptr[0]).item()),
        build_ms=round((time.perf_counter() - t0) * 1e3, 3))

    def kernel(w):
        return tiled_degrees(tiling, w, n_nodes=n)

    def plain(w):
        return tiled_degrees_ref(tiling, w)[:n]

    errs = []
    # (a) the main path's first two passes: alive-masked unit weights.
    w0 = torch.where(flickr.mask, flickr.weight, 0.0)
    deg0, total0 = segment_degree_count(flickr.src, flickr.dst, w0, n)
    alive1, _ = undirected_pass_step(torch.ones(n, dtype=torch.bool, device=dev), deg0, total0, EPS)
    w1 = torch.where(flickr.mask & alive1[flickr.src] & alive1[flickr.dst], flickr.weight, 0.0)
    for name, w in (("pass0", w0), ("pass1", w1)):
        got = kernel(w)
        errs.append(check_equal(f"flickr {name}", got, plain(w)))
        check_equal(f"flickr {name} vs index_add_", got,
                    segment_degree_count(flickr.src, flickr.dst, w, n)[0])
        log("kernel.check", case=f"flickr_{name}", equal="bitwise", alive_edges=int(w.sum().item()))
    # (b) random float weights.  The f32 sums depend on the order of the
    # atomics; the plain version's own f32 index_add_ adds the hub's 144k
    # terms one by one into one float and strays by up to ~1e-5 relative,
    # so the kernel is held against the plain version evaluated in float64.
    wf = torch.from_numpy(np.random.default_rng(0).random(e).astype(np.float32)).to(dev)
    got_f = kernel(wf)
    want_f = plain(wf.double()).float()
    err_f = check_close("flickr float weights", got_f, want_f)
    errs.append(err_f)
    plain_f32_err = (plain(wf).double() - want_f.double()).abs().max().item()
    log("kernel.check", case="flickr_float", tolerance="rtol=atol=1e-5 vs plain in f64",
        max_abs_err=err_f, plain_f32_max_abs_err=plain_f32_err)
    # (c) adversarial layouts.
    for name, t, w, nn in _adversarial_cases(dev):
        errs.append(check_equal(name, tiled_degrees(t, w, n_nodes=nn), tiled_degrees_ref(t, w)[:nn]))
        log("kernel.check", case=name, equal="bitwise", slots=t.n_slots, tiles=t.n_tiles)
    torch.cuda.synchronize()

    # Timing at the main path's shapes (first rung, pass-0 weights).
    endpoints = torch.cat([flickr.src, flickr.dst]).long()
    w2 = torch.cat([w0, w0])
    ms = time_ms(lambda: kernel(w0))
    plain_ms = time_ms(lambda: plain(w0))
    library_ms = time_ms(
        lambda: torch.zeros(n, dtype=torch.float32, device=dev).index_add_(0, endpoints, w2)
    )
    bound_ms = kernel_bound_ms(tiling, e)
    log("kernel.time", kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_us=bound_ms * 1e3, roofline_share=bound_ms / ms)
    return {
        "name": "tiled_degrees",
        "route": "cuda",
        "source": "src/repro_torch/kernels/peel_degree/csrc/peel_degree.cu",
        "replaces": "src/repro/kernels/peel_degree/kernel.py:59",
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


def _same_answer(what: str, a, b) -> None:
    import torch

    for f in ("best_alive", "best_density", "best_size", "alive",
              "history_n", "history_m", "history_rho"):
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: {f} differs")
    if a.passes != b.passes:
        raise AssertionError(f"{what}: passes {a.passes} != {b.passes}")


def _golden_check(name: str, backend: str, res) -> None:
    import torch_port_golden as golden

    with open(golden.GOLDEN) as f:
        want = json.load(f)["answers"][name][backend]
    got = golden.record(res.best_alive.cpu().numpy(), res.best_density.cpu().numpy(),
                        res.best_size.cpu(), res.passes)
    if got != want:
        raise AssertionError(f"{name}/{backend}: {got} != JAX golden {want}")


def phase_quickstart() -> None:
    """The README quickstart graph and a 200k Chung-Lu graph: CUDA pallas ==
    CUDA exact == the port on the CPU == the JAX golden fixture."""
    import numpy as np

    import torch_port_golden as golden
    from repro_torch.core import Problem, solve
    from repro_torch.graph import generators

    for name, (gen, kw) in golden.GRAPHS.items():
        answers = {}
        for dev in ("cuda", "cpu"):
            out = getattr(generators, gen)(**kw, device=dev)
            edges = out[0] if isinstance(out, tuple) else out
            for backend in golden.BACKENDS:
                res = solve(edges, Problem.undirected(eps=golden.EPS, backend=backend,
                                                      track_history=True))
                answers[dev, backend] = res
        ref = answers["cuda", "pallas"]
        for key, res in answers.items():
            _same_answer(f"{name} cuda/pallas vs {key}", ref, res)
        for backend in golden.BACKENDS:
            _golden_check(name, backend, answers["cuda", backend])
        extra = {}
        if name == "quickstart":
            planted = np.arange(kw["k"])
            recall = len(np.intersect1d(ref.nodes(), planted)) / len(planted)
            if not recall > 0.9:
                raise AssertionError(f"quickstart recall {recall} <= 0.9")
            extra["recall"] = recall
        log("solve", graph=name, equal="cuda pallas == cuda exact == cpu == JAX golden",
            rho=float(ref.best_density), size=int(ref.best_size), passes=ref.passes, **extra)


def phase_flickr(flickr) -> dict:
    """The main path at FLICKR scale: pallas (counted) against exact."""
    import torch

    from repro_torch import hostsync
    from repro_torch.core import Problem, solve
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    runs = {}
    for backend in ("pallas", "exact", "pallas", "exact"):
        prob = Problem.undirected(eps=EPS, backend=backend, track_history=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tiled_degrees.launches = 0
        hostsync.read.count = 0
        t0 = time.perf_counter()
        res = solve(flickr, prob)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, syncs = tiled_degrees.launches, hostsync.read.count
        peak = torch.cuda.max_memory_allocated() - base
        first = backend not in runs
        runs.setdefault(backend, (res, launches))
        segs = res.extras["compaction"]["segments"]
        log("flickr", backend=backend, run="first" if first else "second", wall_ms=wall * 1e3,
            passes=res.passes, segments=len(segs), host_syncs=syncs, kernel_launches=launches,
            peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
            peak_above_graph_mb=peak / 2**20, rho=float(res.best_density),
            size=int(res.best_size))
        if first:
            print("  segments: " + json.dumps(
                [{k: s[k] for k in ("n_buf", "m_buf", "passes")} for s in segs]), flush=True)
    (res_p, launches_p), (res_e, launches_e) = runs["pallas"], runs["exact"]
    _same_answer("flickr pallas vs exact", res_p, res_e)
    if launches_p != res_p.passes or launches_e != 0:
        raise AssertionError(
            f"kernel launches {launches_p} (pallas) / {launches_e} (exact) "
            f"for {res_p.passes} passes"
        )
    log("flickr", equal="pallas == exact bitwise (sets, density, passes, history)",
        kernel_launches=launches_p, passes=res_p.passes)
    return {"launches": launches_p}


def phase_profile(flickr) -> None:
    """Where the FLICKR pallas solve's device time goes, by kernel name
    (torch.profiler), and the device's busy share of the solve's wall time
    (measured without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Problem, solve

    prob = Problem.undirected(eps=EPS, backend="pallas")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve(flickr, prob)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(flickr, prob)
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)

    rows = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(ev) for ev in rows) / 1e3
    if busy_ms == 0:
        log("profile", device_time="not measured (the profiler recorded no device events)",
            wall_ms=wall_ms)
        return
    log("profile", wall_ms=wall_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
        device_idle_share=1 - busy_ms / wall_ms)
    for ev in sorted(rows, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(ev) / 1e3:9.4f} ms  x{ev.count:<4d} {ev.key[:110]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.graph import generators

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    t0 = time.perf_counter()
    flickr = generators.chung_lu_power_law(**FLICKR, device="cuda")
    log("flickr.graph", nodes=flickr.n_nodes, edges=flickr.n_edges_padded,
        gen_seconds=round(time.perf_counter() - t0, 3))
    k1 = phase_kernel(flickr)
    phase_quickstart()
    k1.update(phase_flickr(flickr))
    phase_profile(flickr)
    log("done", seconds=round(time.perf_counter() - t_start, 3))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: k1[k] for k in keys}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
