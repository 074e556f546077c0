#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from the sources in this checkout (one
``nvcc`` each, all started together), holds each against its plain PyTorch
version on the card, then drives the port's eight paths through the
entry points a user calls:

* Algorithm 1 on the geometric ladder, ``solve(edges,
  Problem.undirected(eps, backend='pallas'))`` (K1, tiled degrees), on the
  README quickstart graph, a 200k-node Chung-Lu graph and at FLICKR scale
  (976k nodes, 7.6M edges drawn, Chung-Lu exponent 2.2, seed 0);
* the §5.1 Count-Sketch backend that ``backend='auto'`` picks above 1M
  nodes (K2, the counter update), at LIVEJOURNAL scale (4.84M nodes,
  68.9M edges drawn, Chung-Lu exponent 2.2, seed 0);
* the turnstile runtime, ``TurnstileDensest`` (K3, the l0-sketch update;
  K1 again on the sample peel), on a churn stream over the FLICKR graph;
* Algorithms 2 and 3 and the sweep driver (K1 and K2 again): at_least_k
  with k=100,000 on the FLICKR graph (pallas against exact), a 3-lane eps
  sweep under pallas (each lane against its standalone solve), the c grid
  and a 41-lane c sweep on a planted 2,000 x 500 S->T block in a directed
  graph of FLICKR's scale, and the directed ``backend='auto'`` (sketch)
  query on the same generator at LIVEJOURNAL's scale, against the peel
  over the plain counters;
* per-seed serving: ``DensestQueryEngine`` over the FLICKR graph in both
  extraction modes (256 seeds; every lane against its standalone solve and
  the engine on the CPU; 4 seeds against the local front door ``solve(...,
  seed=)``), local mode over the LIVEJOURNAL graph (64 seeds), the
  resilience ladder under a seeded fault storm with a turnstile density
  service attached (K3 on every update batch, K1 on its sample peel), a
  fresh process that loads the four libraries from the cache of built
  kernels with no ``nvcc``, and the golden fixture's serve entries;
* the semi-streaming substrate: livejournal_md written to a memmap store
  on disk and streamed in 2^20-edge chunks by ``StreamingDensest`` with its
  node state on the card (no kernel of K1-K4; ``index_add_``), against the
  in-memory exact ladder, with the spill ladder, a kill and resume, and a
  seeded fault storm; the front door on flickr_sm against the CPU driver;
* the §5.2 mesh substrate on a one-rank NCCL mesh (``make_mesh``):
  livejournal_md on the collective ladder against the in-memory jit
  ladder and with ``backend='sketch'`` (K2 once a pass on the rank's
  shard) against the jit sketch solve, flickr_sm with compaction off,
  twophase and the bf16 wire against the same on a one-rank gloo mesh on
  the CPU, and the directed 976k graph at c=4 against its jit solve, each
  run's collectives counted;
* the LM path at the full width of llama3.2-3b (28 layers, random weights
  from a seeded ``torch.Generator``): ``prefill`` of an 8,192-token prompt
  with ``attn_impl='pallas'`` (K4, flash attention, once per layer)
  against ``'xla'``, and the ``ServeEngine`` answering 6 requests.

Answers are checked against the exact backend, the plain versions, the
port on the CPU and the JAX package's golden fixture
(tests/fixtures/torch_port/golden.json), the LM's against its ``'xla'``
path, its full forward and the golden fixture's REDUCED-config entries.
Any failed check raises, so the exit code is not 0.

Output: the torch/CUDA versions and ``nvidia-smi``'s name and power limit
first; then one line per phase; then, on the line before the last, the
kernels' JSON record (launches on each path's run, error against the plain
version, median times from CUDA events, the memory bound, a library call's
time); last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
F32_FLOPS = 67e12  # outside the tensor cores
EPS = 0.5
FLICKR = dict(n=976_000, exponent=2.2, avg_deg=2 * 7.6e6 / 976_000, seed=0)
# src/repro/configs/densest_mapreduce.py SHAPES["livejournal_md"].
LIVEJOURNAL = dict(n=4_840_000, exponent=2.2, avg_deg=2 * 68.9e6 / 4_840_000, seed=0)
TURNSTILE_BATCH = 1 << 20
TIMED_LAUNCHES = 30
DEV = "cuda"  # every tensor of the run lives here


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


def check_close(what: str, got, want, tol: float = 1e-5) -> float:
    """rtol/atol ``tol``: float weights are summed in another order."""
    err = (got.double() - want.double()).abs()
    bad = err > tol + tol * want.double().abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values outside rtol=atol={tol} "
                             f"(max abs err {err.max().item()})")
    return err.max().item()


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
    """Builds K1, K2, K3 and K4 from this checkout's sources, one ``nvcc``
    per source, all started together.  Then K4's kernels as ``ptxas`` built
    them (registers, spills, shared memory) and the count of ``wgmma``
    (HGMMA) and TMA load (UTMALDG) instructions in its library's SASS;
    K1's, K2's and K3's atomic and warp-exchange instructions by form (K1
    must have no shared atomic and a global reduction)."""
    from repro_torch.kernels import BUILD_LOG, library_path, load_library
    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.peel_degree import ops as pd_ops

    sources = [pd_ops.SOURCE, cs_ops.SOURCE, l0_ops.SOURCE, fa_ops.SOURCE]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load_library, sources))
    wall = time.perf_counter() - t0
    for src in sources:
        info = BUILD_LOG.get(src.name, {"seconds": 0.0, "ptxas": "(cached build)"})
        log("build", source=src.relative_to(ROOT), nvcc_seconds=round(info["seconds"], 3),
            all_builds_wall_seconds=round(wall, 3))
        for line in str(info["ptxas"]).splitlines():
            print(f"  {line}", flush=True)
    ptxas = str(BUILD_LOG.get(fa_ops.SOURCE.name, {}).get("ptxas", ""))
    for name, props in _ptxas_kernels(ptxas).items():
        log("build.k4", kernel=name, **props)
    found = sass_counts(library_path(fa_ops.SOURCE), r"\b(?:HGMMA|UTMALDG|MUFU\.EX2|HMMA)\b")
    counts = {op: found.get(op, 0) for op in ("HGMMA", "UTMALDG", "MUFU.EX2", "HMMA")}
    log("build.k4", sass_instructions=counts, bf16_dynamic_smem_bytes={
        dp: fa_ops.bf16_smem_bytes(dp) for dp in (64, 128)})
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        raise AssertionError(f"K4's library has no wgmma or no TMA load: {counts}")
    # K1's and K2's shared-memory atomics (a compare-and-swap loop shows as
    # ATOMS.CAST.SPIN) and warp exchange; K1's and K3's global reductions.
    warp_ops = r"\b(?:ATOMS|MATCH|SHFL|VOTE|REDG?|ATOMG?)\.[\w.]+"
    for label, ops, pattern in (("k1", pd_ops, warp_ops), ("k2", cs_ops, warp_ops),
                                ("k3", l0_ops, r"\b(?:REDG?|ATOMG?)\.[\w.]+")):
        counts = sass_counts(library_path(ops.SOURCE), pattern)
        log(f"build.{label}", sass_instructions=counts)
        if not counts:
            raise AssertionError(f"{label}'s library has no atomic: {counts}")
        if label == "k1" and (any(op.startswith("ATOMS") for op in counts)
                              or not any(op.startswith("RED") for op in counts)):
            raise AssertionError(f"K1 should add with plain shared stores and reds: {counts}")


def sass_counts(library: Path, pattern: str) -> dict:
    """{instruction form: count} of the regex ``pattern`` in ``library``'s
    SASS (``cuobjdump -sass``)."""
    import collections
    import re

    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    return dict(sorted(collections.Counter(re.findall(pattern, sass)).items()))


def _cuda_tool(name: str) -> str:
    import shutil

    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def _ptxas_kernels(ptxas: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, static_smem}} from
    ``ptxas -v`` output, by the demangled-enough kernel name."""
    import re

    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            kern = re.search(r"(flash_fwd_bf16|flash_fwd_f32|flash_plan)(?:ILi(\d+)E)?", raw)
            name = raw if kern is None else kern.group(1) + (
                f"<{kern.group(2)}>" if kern.group(2) else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


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
    # The redesign's cases: runs across a lane's 4 slots, a 128-slot warp
    # step and a chunk (also through views 4 bytes past a 16-byte boundary),
    # one node holding every slot, tiles of chunk_slots slots and one more,
    # and tile sizes at which 8, 2 and 1 histogram copies fit.
    lens = [3, 5, 130, 1500, 1, 7, 300, 2049, 4, 129, 128]
    runs = np.repeat(np.arange(len(lens)) * 7 % 64, lens)

    def ragged(name, counts, targets, tile_size, offset=0):
        s_ = int(np.sum(counts))
        ptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64, device=dev)
        tl = torch.zeros(s_ + offset, dtype=torch.int32, device=dev)
        tl[offset:] = torch.as_tensor(np.asarray(targets, np.int32), device=dev)
        ei = torch.arange(-offset, s_, dtype=torch.int32, device=dev)
        t = TiledEdges.from_ragged(ptr, tl[offset:], torch.zeros_like(tl[offset:]), ei[offset:],
                                   tile_size=tile_size, n_nodes=len(counts) * tile_size,
                                   n_edges=s_)
        w = torch.from_numpy(rng.integers(0, 4, s_).astype(np.float32)).to(dev)
        cases.append((name, t, w, t.n_nodes))

    ragged("k1_runs", [1, len(runs) - 1], runs, 64)
    ragged("k1_runs_misaligned_view", [3, len(runs) - 3], runs, 64, offset=1)
    ragged("k1_one_node", [0, 50_000, 3], [5] * 50_000 + [1, 1, 2], 64)
    for extra in (0, 1):  # chunk_slots is 1,024 below 1M slots
        ragged(f"k1_tile_at_chunk_plus{extra}", [7, 1024 + extra, 3000 - 1034 - extra, 3],
               rng.integers(0, 64, 3000), 64)
    for tile_size in (1024, 20_000, 58_112):
        n = 3 * tile_size - 5
        add(f"k1_tile_size_{tile_size}", rng.integers(0, n, 200_000),
            np.sort(rng.integers(0, n, 200_000)), n, tile_size)
    # The reference's dense layout, padding slots included, under both of
    # its padding conventions.
    name, base, w, n = [c for c in cases if c[0] == "ragged_n_t1024"][0]
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

    from repro_torch import hostsync
    from repro_torch.core.engine import segment_degree_count, undirected_pass_step
    from repro_torch.graph.partition import TiledEdges
    from repro_torch.kernels.peel_degree import ops as pd_ops
    from repro_torch.kernels.peel_degree.ops import tiled_degrees, tiling_for_edges
    from repro_torch.kernels.peel_degree.ref import fold_runs, tiled_degrees_ref

    dev = flickr.device
    n, e = flickr.n_nodes, flickr.n_edges_padded
    torch.cuda.synchronize()
    syncs = hostsync.read.count
    t0 = time.perf_counter()
    tiling = tiling_for_edges(flickr, tile_size=1024)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    build_syncs = hostsync.read.count - syncs
    if build_syncs:
        raise AssertionError(f"building a tiling made {build_syncs} host syncs")
    w0 = torch.where(flickr.mask, flickr.weight, 0.0)
    counts = tiling.tile_ptr[1:] - tiling.tile_ptr[:-1]
    cs = tiling.chunk_slots
    split = counts > cs
    split_pieces = int(((counts[split] + cs - 1) // cs).sum().item())
    fold_adds = int(fold_runs(tiling, w0)[0].numel())
    live_slots = int((w0[tiling.edge_index.long()] != 0).sum().item())
    log("kernel.tiling", n_nodes=n, n_edges=e, slots=tiling.n_slots, tiles=tiling.n_tiles,
        chunk_slots=cs, plan_entries=tiling.chunk_tile.numel(),
        ctas=int((tiling.chunk_tile >= 0).sum().item()), split_tiles=int(split.sum().item()),
        split_pieces=split_pieces, global_reds_at_most=split_pieces * tiling.tile_size,
        fold_adds=fold_adds, live_slots=live_slots, fold_adds_per_live_slot=fold_adds / live_slots,
        hub_tile_slots=int(counts[0].item()), build_ms=build_ms, build_host_syncs=build_syncs,
        tiling_ms=time_ms(lambda: tiling_for_edges(flickr, tile_size=1024), n=10))

    def kernel(w):
        return tiled_degrees(tiling, w, n_nodes=n)

    def plain(w):
        return tiled_degrees_ref(tiling, w)[:n]

    errs = []
    # (a) the main path's first two passes: alive-masked unit weights.
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
    # (c) adversarial layouts; the redesign's cases also launched twice and
    # with float weights.
    for name, t, w, nn in _adversarial_cases(dev):
        want = tiled_degrees_ref(t, w)[:nn]
        errs.append(check_equal(name, tiled_degrees(t, w, n_nodes=nn), want))
        extra = {}
        if name.startswith("k1_"):
            errs.append(check_equal(f"{name} again", tiled_degrees(t, w, n_nodes=nn), want))
            rand = np.random.default_rng(2).random(t.n_edges).astype(np.float32)
            wf = torch.from_numpy(rand).to(dev)
            extra["float_max_abs_err"] = check_close(f"{name} float", tiled_degrees(
                t, wf, n_nodes=nn), tiled_degrees_ref(t, wf.double())[:nn])
            errs.append(extra["float_max_abs_err"])
        log("kernel.check", case=name, equal="bitwise", slots=t.n_slots, tiles=t.n_tiles,
            chunk_slots=t.chunk_slots, **extra)
    torch.cuda.synchronize()

    # Timing at the main path's shapes (first rung, pass-0 weights).
    endpoints = torch.cat([flickr.src, flickr.dst]).long()
    w2 = torch.cat([w0, w0])
    ms = time_ms(lambda: kernel(w0))
    deg = torch.zeros(tiling.n_tiles * tiling.tile_size, dtype=torch.float32, device=dev)
    launches = tiled_degrees.launches
    alone_ms = time_ms(lambda: pd_ops._launch(tiling, w0, deg))  # the C call alone
    tiled_degrees.launches = launches
    # A control where runs do not fold: each tile's slots in a seeded
    # random order (the tiling's contract allows any order within a tile).
    perm = torch.argsort(tiling.tile_of_slot() * tiling.n_slots + torch.randperm(
        tiling.n_slots, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    shuffled = TiledEdges.from_ragged(
        tiling.tile_ptr, tiling.target_local[perm], tiling.source[perm], tiling.edge_index[perm],
        tile_size=tiling.tile_size, n_nodes=n, n_edges=e)
    errs.append(check_equal("flickr pass0 shuffled", tiled_degrees(shuffled, w0, n_nodes=n),
                            plain(w0)))
    shuffled_ms = time_ms(lambda: tiled_degrees(shuffled, w0, n_nodes=n))
    shuffled_adds = int(fold_runs(shuffled, w0)[0].numel())
    del shuffled, perm
    plain_ms = time_ms(lambda: plain(w0))
    library_ms = time_ms(
        lambda: torch.zeros(n, dtype=torch.float32, device=dev).index_add_(0, endpoints, w2)
    )
    bound_ms = kernel_bound_ms(tiling, e)
    log("kernel.time", kernel_ms=ms, kernel_alone_ms=alone_ms, shuffled_ms=shuffled_ms,
        shuffled_fold_adds=shuffled_adds, plain_ms=plain_ms, library_ms=library_ms,
        bound_us=bound_ms * 1e3, roofline_share=bound_ms / ms,
        roofline_share_alone=bound_ms / alone_ms)
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


OUTCOME_FIELDS = ("best_alive", "best_t", "best_density", "best_size", "alive", "t_alive",
                  "history_n", "history_m", "history_rho")


def _same_outcome(what: str, a, b, lane=None) -> None:
    """Every outcome field bitwise (lane ``lane`` of ``a`` if given)."""
    import torch

    for f in OUTCOME_FIELDS:
        x = getattr(a, f) if lane is None else getattr(a, f)[lane]
        if not torch.equal(x.cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"{what}: {f} differs")
    passes = a.passes if lane is None else a.passes[lane]
    if passes != b.passes:
        raise AssertionError(f"{what}: passes {passes} != {b.passes}")


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
        for dev in (DEV, "cpu"):
            out = getattr(generators, gen)(**kw, device=dev)
            edges = out[0] if isinstance(out, tuple) else out
            for backend in golden.BACKENDS:
                res = solve(edges, Problem.undirected(eps=golden.EPS, backend=backend,
                                                      track_history=True))
                answers[dev, backend] = res
        ref = answers[DEV, "pallas"]
        for key, res in answers.items():
            _same_outcome(f"{name} cuda/pallas vs {key}", ref, res)
        for backend in golden.BACKENDS:
            _golden_check(name, backend, answers[DEV, backend])
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
    _same_outcome("flickr pallas vs exact", res_p, res_e)
    if launches_p != res_p.passes or launches_e != 0:
        raise AssertionError(
            f"kernel launches {launches_p} (pallas) / {launches_e} (exact) "
            f"for {res_p.passes} passes"
        )
    log("flickr", equal="pallas == exact bitwise (sets, density, passes, history)",
        kernel_launches=launches_p, passes=res_p.passes)
    return {"launches": launches_p}


def _union_ms(intervals) -> float:
    """Total length of the union of ``(start, end)`` microsecond intervals,
    in ms: the time at least one device activity ran."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def phase_profile(label: str, run) -> None:
    """Where one run's device time goes, by kernel name (torch.profiler),
    and the device's busy share of its wall time (the wall measured on a
    run without the profiler): ``device_busy_ms`` sums every activity's
    time, ``device_busy_union_ms`` counts time when activities on several
    streams overlap once, and the idle share is taken from the union."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)

    rows = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(ev) for ev in rows) / 1e3
    if busy_ms == 0:
        log("profile", run=label,
            device_time="not measured (the profiler recorded no device events)", wall_ms=wall_ms)
        return
    union_ms = _union_ms((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA)
    log("profile", run=label, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_busy_union_ms=union_ms, device_busy_share=union_ms / wall_ms,
        device_idle_share=1 - union_ms / wall_ms)
    for ev in sorted(rows, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(ev) / 1e3:9.4f} ms  x{ev.count:<4d} {ev.key[:110]}", flush=True)


# -- K2 and the Count-Sketch path (livejournal_md) ---------------------------


def sketch_bound_ms(n_edges: int, t: int, b: int, groups: int) -> float:
    """Least time on the card for one counter build: src, dst and w_alive
    read once (12 B per edge) and the t*b float counters written once,
    over HBM bandwidth.  (Where the tables are split over CTA groups the
    kernel reads the edges ``groups`` times; the bound does not.)"""
    return (n_edges * 12 + t * b * 4) / HBM_BYTES_PER_S * 1e3


def _flat_sketch_index(src, dst, w, p):
    """The K2 scatter with the hashing done beforehand: int64 flat counter
    index and float32 value of every (table, endpoint), for the library
    yardstick (one ``index_add_``)."""
    import torch

    from repro_torch.core.countsketch import _hash_bucket, _hash_sign

    flats, vals = [], []
    for x in (src, dst):
        rows = torch.arange(p.n_tables, dtype=torch.int64, device=x.device)[:, None]
        flats.append((_hash_bucket(p, x).long() + rows * p.n_buckets).reshape(-1))
        vals.append((_hash_sign(p, x) * w[None, :]).reshape(-1))
    return torch.cat(flats), torch.cat(vals)


# K2's float error limit, relative to each counter's absolute mass: it lies
# between K2's reading and that of a bf16-weight control (PERF.md has both
# readings), and the control must fail it.
MASS_TOL = 3e-6


def counter_mass(src, dst, w, p):
    """float64[t, b]: 1 + each counter's absolute mass, ``sum(|sign*w|)``
    over the terms it sums."""
    import torch

    flat, vals = _flat_sketch_index(src, dst, w, p)
    return 1 + torch.zeros(p.n_tables * p.n_buckets, dtype=torch.float64, device=w.device
                           ).index_add_(0, flat, vals.double().abs()).view(p.n_tables, p.n_buckets)


def check_float_counters(what: str, src, dst, w, p):
    """K2 on float weights against the plain version in float64.

    A counter sums ``sign*w`` terms of both signs: at livejournal_md, hubs
    of opposite sign (terms of 10^5 cancelling to 10^2), and at b=128
    some 15k terms a counter, so any f32 order of the sum, the plain
    version's own ``index_add_`` included, can stray past 1e-4 of the
    RESULT.  The error is held instead to ``MASS_TOL`` of the counter's
    absolute mass ``1 + sum(|sign*w|)`` (what a reassociated sum's error
    scales with).  A control, the plain version on bf16-rounded weights,
    must fail that limit, or the check could not tell a lower-precision
    kernel from a sound one.  The counters outside plain rtol/atol 1e-4 are
    counted for the kernel and for the plain version in f32 alike.
    Returns (max abs err, log fields).
    """
    import torch

    from repro_torch.kernels.count_sketch.ops import sketch_edges
    from repro_torch.kernels.count_sketch.ref import sketch_edges_ref

    want = sketch_edges_ref(src, dst, w.double(), p)
    err = (sketch_edges(src, dst, w, p).double() - want).abs()
    err_plain = (sketch_edges_ref(src, dst, w, p).double() - want).abs()
    mass = counter_mass(src, dst, w, p)
    over_mass = (err / mass).max().item()
    control = ((sketch_edges_ref(src, dst, w.bfloat16().float(), p).double() - want).abs()
               / mass).max().item()
    if over_mass > MASS_TOL:
        raise AssertionError(f"{what}: error {over_mass} of the counters' absolute mass, "
                             f"past {MASS_TOL}")
    if control <= MASS_TOL:
        raise AssertionError(f"{what}: the bf16-weight control reads {control} of the mass, "
                             f"within {MASS_TOL}: the limit cannot tell it from K2")

    def outside(e):
        return int((e > 1e-4 + 1e-4 * want.abs()).sum())

    return err.max().item(), {
        "tolerance": f"{MASS_TOL} x (1 + counter's abs mass) vs plain in f64",
        "max_abs_err": err.max().item(), "max_err_over_mass": over_mass,
        "bf16_control_max_err_over_mass": control,
        "plain_f32_max_abs_err": err_plain.max().item(),
        "plain_f32_max_err_over_mass": (err_plain / mass).max().item(),
        "outside_rtol_1e4_kernel": outside(err), "outside_rtol_1e4_plain_f32": outside(err_plain),
    }


def phase_sketch_kernel(lj) -> dict:
    """K2 against its plain version on the card: livejournal_md's first
    pass (unit weights, bitwise), random float weights (see
    :func:`check_float_counters`), and adversarial streams (bitwise on unit
    weights; float weights as in (b))."""
    import numpy as np
    import torch

    from repro_torch.core.api import Problem
    from repro_torch.core.countsketch import make_sketch_params
    from repro_torch.kernels.count_sketch.ops import count_sketch_update, plan, sketch_edges
    from repro_torch.kernels.count_sketch.ref import (
        combine_runs, count_sketch_update_ref, sketch_edges_ref,
    )

    prob = Problem.undirected(eps=EPS, backend="sketch")
    p = make_sketch_params(prob.sketch_tables, prob.sketch_buckets, prob.sketch_seed)
    e = lj.n_edges_padded
    w0 = torch.where(lj.mask, lj.weight, 0.0)
    errs = []
    # (a) the main path's first pass.
    got = sketch_edges(lj.src, lj.dst, w0, p)
    want = sketch_edges_ref(lj.src, lj.dst, w0, p)
    errs.append(check_equal("livejournal pass0 counters", got, want))
    log("sketch.check", case="livejournal_pass0", equal="bitwise", edges=e,
        tables=p.n_tables, buckets=p.n_buckets, max_abs_counter=got.abs().max().item())
    # (b) random float weights (see check_float_counters for the bound).
    wf = torch.from_numpy(np.random.default_rng(0).random(e).astype(np.float32)).to(DEV)
    err_f, info = check_float_counters("livejournal float weights", lj.src, lj.dst, wf, p)
    errs.append(err_f)
    log("sketch.check", case="livejournal_float", **info)
    # (c) adversarial streams: one hub node takes every endpoint; t and b
    # over the one-window, whole-table and split routes; E a multiple of
    # no block; every weight zero.
    rng = np.random.default_rng(1)
    n_adv = 1_000_003
    xs = torch.from_numpy(rng.integers(0, lj.n_nodes, n_adv).astype(np.int32)).to(DEV)
    ys = torch.from_numpy(rng.integers(0, lj.n_nodes, n_adv).astype(np.int32)).to(DEV)
    hub = torch.full((n_adv,), 7, dtype=torch.int32, device=DEV)
    ones = torch.ones(n_adv, dtype=torch.float32, device=DEV)
    wr = torch.from_numpy(rng.random(n_adv).astype(np.float32)).to(DEV)
    for t in (1, 5, 8):
        for b in (128, 8192, 32768):
            q = make_sketch_params(t, b, seed=t)
            errs.append(check_equal(f"t{t} b{b}", sketch_edges(xs, ys, ones, q),
                                    sketch_edges_ref(xs, ys, ones, q)))
            errs.append(check_equal(f"hub t{t} b{b}", sketch_edges(hub, ys, ones, q),
                                    sketch_edges_ref(hub, ys, ones, q)))
            errs.append(check_equal(f"one array t{t} b{b}", count_sketch_update(hub, ones, q),
                                    count_sketch_update_ref(hub, ones, q)))
            err_q, info = check_float_counters(f"float t{t} b{b}", xs, ys, wr, q)
            errs.append(err_q)
            log("sketch.check", case=f"adversarial_t{t}_b{b}", equal="bitwise (unit weights)",
                edges=n_adv, window_groups=plan(t, b)[1], float_max_abs_err=err_q,
                float_max_err_over_mass=info["max_err_over_mass"],
                float_bf16_control_over_mass=info["bf16_control_max_err_over_mass"],
                float_outside_rtol_1e4=info["outside_rtol_1e4_kernel"],
                float_plain_f32_outside_rtol_1e4=info["outside_rtol_1e4_plain_f32"])
    zero = sketch_edges(xs, ys, torch.zeros_like(ones), p)
    if zero.any() or torch.signbit(zero).any():
        raise AssertionError("all-zero weights left a counter other than +0.0")
    log("sketch.check", case="all_zero_weights", equal="all counters +0.0")
    torch.cuda.synchronize()

    # Timing at the main path's shapes.
    ms = time_ms(lambda: sketch_edges(lj.src, lj.dst, w0, p))
    plain_ms = time_ms(lambda: sketch_edges_ref(lj.src, lj.dst, w0, p), n=5, warmup=1)
    flat, vals = _flat_sketch_index(lj.src, lj.dst, w0, p)
    library_ms = time_ms(lambda: torch.zeros(p.n_tables * p.n_buckets, device=DEV)
                         .index_add_(0, flat, vals))
    del flat, vals
    # The edge list is sorted by its lower endpoint, so a warp's 32 edges
    # mostly share src; K2 folds each such run into one add a table.  The
    # same edges in a random order leave nothing to fold, and one hub as
    # every lower endpoint folds all.  The adds each stream issues per
    # table, counted by the plain rule (combine_runs), beside the 2E
    # endpoints' adds before folding.
    def adds(x0, x1, w):
        return len(combine_runs(x0, w)[0]) + len(combine_runs(x1, w)[0])

    perm = torch.randperm(e, generator=torch.Generator(device=DEV).manual_seed(0), device=DEV)
    ps, pd, pw = lj.src[perm], lj.dst[perm], w0[perm]
    check_equal("shuffled edge order", sketch_edges(ps, pd, pw, p), got)
    shuffled_ms = time_ms(lambda: sketch_edges(ps, pd, pw, p))
    adds_shuffled = adds(ps, pd, pw)
    del perm, ps, pd, pw
    # One hub takes all 64M lower endpoints: its counters pass 2^24, where
    # f32 sums of unit weights stop being exact (the plain version's own
    # one-by-one f32 sum stalls at 2^24), so the hub stream is held, as
    # float weights are, to MASS_TOL of each counter's absolute mass
    # against the plain version in float64.
    hub_src = torch.full_like(lj.src, 7)
    want = sketch_edges_ref(hub_src, lj.dst, w0.double(), p)
    mass = counter_mass(hub_src, lj.dst, w0, p)
    hub_over = ((sketch_edges(hub_src, lj.dst, w0, p).double() - want).abs() / mass).max().item()
    hub_plain_over = ((sketch_edges_ref(hub_src, lj.dst, w0, p).double() - want).abs()
                      / mass).max().item()
    del want, mass
    if hub_over > MASS_TOL:
        raise AssertionError(f"hub stream: error {hub_over} of the counters' absolute mass, "
                             f"past {MASS_TOL}")
    log("sketch.check", case="livejournal_hub_stream", tolerance=f"{MASS_TOL} x (1 + counter's "
        "abs mass) vs plain in f64", max_err_over_mass=hub_over,
        plain_f32_max_err_over_mass=hub_plain_over)
    hub_ms = time_ms(lambda: sketch_edges(hub_src, lj.dst, w0, p))
    adds_hub = adds(hub_src, lj.dst, w0)
    del hub_src
    adds_stream = adds(lj.src, lj.dst, w0)
    window, groups = plan(p.n_tables, p.n_buckets)
    bound_ms = sketch_bound_ms(e, p.n_tables, p.n_buckets, groups)
    log("sketch.time", kernel_ms=ms, kernel_ms_edges_shuffled=shuffled_ms,
        kernel_ms_hub=hub_ms, stream_over_shuffled=ms / shuffled_ms, plain_ms=plain_ms,
        library_ms_scatter_only=library_ms, bound_us=bound_ms * 1e3,
        roofline_share=bound_ms / ms, window=window, groups=groups)
    log("sketch.adds", per_table_stream_order=adds_stream, per_table_shuffled=adds_shuffled,
        per_table_hub=adds_hub, per_table_unfolded=2 * int((w0 != 0).sum().item()))
    return {
        "name": "count_sketch_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/count_sketch/csrc/count_sketch.cu",
        "replaces": "src/repro/kernels/count_sketch/kernel.py:69",
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


def _peak_run(fn):
    """Runs ``fn()`` to the end on the card: (result, wall ms, host syncs,
    peak device MB above what was allocated before)."""
    import torch

    from repro_torch import hostsync

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hostsync.read.count = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, hostsync.read.count, (torch.cuda.max_memory_allocated() - base) / 2**20


def phase_livejournal(lj) -> dict:
    """The ``backend='auto'`` query at LiveJournal scale (asked for: the
    default backend is 'exact').  ``'auto'`` resolves to the Count-Sketch
    (4.84M nodes > 1M), every pass builds its counters through K2, and the
    answer equals the same peel over the plain counters bit for bit.  Also
    the exact backend, for the density ratio."""
    import torch

    from repro_torch.core import Problem, solve
    from repro_torch.core.countsketch import (
        _estimates, _query_index, make_sketch_params, median_over_tables,
    )
    from repro_torch.core.engine import FnBackend, UndirectedThreshold, run_peel
    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.count_sketch.ref import sketch_edges_ref

    prob = Problem.undirected(eps=EPS, backend="auto", track_history=True)
    cs_ops.count_sketch_update.launches = 0
    res, wall, syncs, peak = _peak_run(lambda: solve(lj, prob))
    launches = cs_ops.count_sketch_update.launches
    if res.provenance.backend != "sketch" or res.provenance.compaction != "off":
        raise AssertionError(f"auto resolved to {res.provenance}")
    if launches != res.passes:
        raise AssertionError(f"K2 launches {launches} != passes {res.passes}")
    log("livejournal", backend="auto->sketch", wall_ms=wall, passes=res.passes,
        host_syncs=syncs, kernel_launches=launches, peak_above_graph_mb=peak,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
        rho=float(res.best_density), size=int(res.best_size))

    # The same peel over the plain counters.
    p = make_sketch_params(prob.sketch_tables, prob.sketch_buckets, prob.sketch_seed)
    index = _query_index(p, torch.arange(lj.n_nodes, dtype=torch.int32, device=DEV))

    def plain_degrees(edges, w_alive):
        counters = sketch_edges_ref(edges.src, edges.dst, w_alive, p)
        return median_over_tables(_estimates(counters, *index))

    mp = prob.resolved_max_passes(lj.n_nodes)
    before = cs_ops.count_sketch_update.launches
    plain = run_peel(lj, UndirectedThreshold(EPS), FnBackend(plain_degrees), mp,
                     track_history=True)
    if cs_ops.count_sketch_update.launches != before:
        raise AssertionError("the plain-counter peel launched K2")
    _same_outcome("livejournal sketch (K2) vs plain counters", res, plain)
    log("livejournal", equal="K2 solve == plain-counter solve bitwise "
        "(sets, density, passes, history)", passes=plain.passes)

    exact, wall_e, syncs_e, peak_e = _peak_run(
        lambda: solve(lj, Problem.undirected(eps=EPS, backend="exact", track_history=True)))
    log("livejournal", backend="exact", wall_ms=wall_e, passes=exact.passes,
        segments=len(exact.extras["compaction"]["segments"]), host_syncs=syncs_e,
        peak_above_graph_mb=peak_e, rho=float(exact.best_density),
        size=int(exact.best_size),
        sketch_over_exact_density=float(res.best_density) / float(exact.best_density))
    return {"launches": launches}, res


# -- K3 and the turnstile path (flickr_sm churn) ------------------------------


def l0_bound_ms(n_rows: int, n_cells_touched: int) -> float:
    """Least time on the card for one in-place sketch update: 12 B per row
    read (src, dst, sgn), plus one read and one write of the 16 B (four
    int32 fields) of each distinct cell the batch touches, over HBM
    bandwidth.  The 4*d atomics of a row that land on a cell already
    touched resolve in L2 and move no further DRAM bytes."""
    return (n_rows * 12 + n_cells_touched * 16 * 2) / HBM_BYTES_PER_S * 1e3


def l0_sector_ops(flat, live) -> dict:
    """L2 sector atomics one K3 launch issues (a cell's four int32 fields
    are 16 B; a 32 B sector holds two cells), from the batch's cells
    ``flat`` (int64[d, E], ``flat_cells``) and its live rows (``live``,
    sign != 0 after canonicalization).  One red instruction touches each
    distinct sector of its lanes once.

    * ``one_thread_per_row``: the kernel this one replaced.  A warp takes 32
      consecutive rows and issues four instructions per table, one per
      field, each over the live rows' cells.
    * ``four_lanes_per_cell``: this kernel.  A warp takes 128 rows, lane l
      rows 4l..4l+3; for each k < 4 the live rows among rows 4l+k are
      staged in lane order, and each instruction (one per table) covers
      8 staged rows, all four fields.

    Also the share of live (row, table) adds whose cell another row of
    the same staged set hits: what folding equal cells in a warp
    (``__match_any_sync``) could save."""
    import torch

    d, n = flat.shape
    pad = (-n) % 128
    flat = torch.nn.functional.pad(flat, (0, pad))
    live = torch.nn.functional.pad(live, (0, pad))
    rows = torch.arange(n + pad, device=flat.device)
    table = torch.arange(d, device=flat.device)[:, None]

    def distinct(group, where):  # distinct (group, table, where) over live rows
        key = (group[None, :] * d + table) * (int(where.max().item()) + 1) + where
        return torch.unique(key[:, live]).numel()

    warp32 = rows // 32
    # Staged sets: (chunk of 128 rows, k); a row's slot is its rank among
    # its set's live rows in lane order.
    lv = live.view(-1, 32, 4).transpose(1, 2)  # [chunk, k, lane]
    slot = (torch.cumsum(lv.long(), dim=2) - 1).transpose(1, 2).reshape(-1)
    staged = (rows // 128) * 4 + rows % 4
    adds = int(live.sum().item()) * d
    return {
        "one_thread_per_row": 4 * distinct(warp32, flat // 2),
        "four_lanes_per_cell": distinct(staged * 4 + slot // 8, flat // 2),
        "red_instructions_before": 4 * d * torch.unique(warp32[live]).numel(),
        "red_instructions_after": d * int((-(-lv.long().sum(2) // 8)).sum().item()),
        "same_cell_in_staged_set_share": (adds - distinct(staged, flat)) / max(1, adds),
    }


def _l0_plain(src, dst, sgn, p):
    from repro_torch.kernels.l0_sampler.ops import canonicalize_edges
    from repro_torch.kernels.l0_sampler.ref import l0_delta_ref

    return l0_delta_ref(*canonicalize_edges(src, dst, sgn), p)


def phase_l0_kernel(flickr) -> dict:
    """K3 against its plain version on the card, all bitwise: a 2^20-row
    batch of flickr_sm's edges at the turnstile defaults (L=32, d=3,
    C=16384), rows with sign 0 and self-loops, sums that wrap mod 2^32,
    and L in {1, 32} x C in {256, 16384}."""
    import numpy as np
    import torch

    from repro_torch.kernels import hashing
    from repro_torch.kernels.l0_sampler.ops import (
        canonicalize_edges, edge_fingerprint, flat_cells, l0_delta, l0_sketch_shape, l0_update,
        make_l0_params,
    )

    rows = TURNSTILE_BATCH
    src, dst = flickr.src[:rows].contiguous(), flickr.dst[:rows].contiguous()
    ones = torch.ones(rows, dtype=torch.int32, device=DEV)
    p = make_l0_params(n_levels=32, n_cells=1 << 14, n_tables=3, seed=0)
    errs = [check_equal("flickr batch", l0_delta(src, dst, ones, p), _l0_plain(src, dst, ones, p))]
    log("l0.check", case="flickr_batch_2^20", equal="bitwise", rows=rows)
    rng = np.random.default_rng(2)
    sgn = torch.from_numpy(rng.choice(np.array([1, -1, 0], np.int32), rows)).to(DEV)
    loops = dst.clone()
    loops[::3] = src[::3]  # a third of the rows are self-loops
    errs.append(check_equal("sign 0 and self-loops", l0_delta(src, loops, sgn, p),
                            _l0_plain(src, loops, sgn, p)))
    log("l0.check", case="sign0_and_self_loops", equal="bitwise", rows=rows)
    big_u = torch.full((rows,), 2**31 - 9, dtype=torch.int32, device=DEV)
    big_v = torch.full((rows,), 2**31 - 2, dtype=torch.int32, device=DEV)
    got = l0_delta(big_u, big_v, ones, p)
    errs.append(check_equal("wrapping sums", got, _l0_plain(big_u, big_v, ones, p)))
    if not (got < 0).any():
        raise AssertionError("the wrapping case did not wrap")
    log("l0.check", case="wrapping_sums", equal="bitwise", rows=rows)
    for L in (1, 32):
        for C in (256, 1 << 14):
            q = make_l0_params(n_levels=L, n_cells=C, n_tables=3, seed=L + C)
            errs.append(check_equal(f"L{L} C{C}", l0_delta(src, loops, sgn, q),
                                    _l0_plain(src, loops, sgn, q)))
            log("l0.check", case=f"L{L}_C{C}", equal="bitwise", rows=rows)
    torch.cuda.synchronize()

    # Timing: the main path's in-place update of one 2^20-row batch.
    tables = torch.zeros(l0_sketch_shape(p), dtype=torch.int32, device=DEV)
    ms = time_ms(lambda: l0_update(tables, src, dst, ones, p))
    plain_ms = time_ms(lambda: _l0_plain(src, dst, ones, p), n=10, warmup=1)
    # The library yardstick: the scatter alone, over precomputed indices.
    # The batch's rows are canonical already (flickr's edges are u < v).
    u, v, s = canonicalize_edges(src, dst, ones)
    d, C = p.n_tables, p.n_cells
    flat = flat_cells(p, u, v)
    fp = hashing.to_i32(edge_fingerprint(p, u, v))
    vals = torch.stack([s, s * u, s * v, s * fp], dim=-1).repeat(d, 1)
    flat_tables = tables.view(-1, 4)
    library_ms = time_ms(lambda: flat_tables.index_add_(0, flat.reshape(-1), vals))
    # The cells this batch touches: (level, table, cell) of every row
    # with a non-zero sign after canonicalization.
    live = s != 0
    touched = torch.unique(flat[:, live]).numel()
    bound_ms = l0_bound_ms(rows, touched)
    log("l0.time", kernel_ms=ms, plain_ms=plain_ms, library_ms_scatter_only=library_ms,
        kernel_over_library=ms / library_ms, bound_us=bound_ms * 1e3,
        roofline_share=bound_ms / ms, rows=rows, nonzero_rows=int(live.sum().item()),
        cells_touched=touched, cells_in_table=p.n_levels * d * C)
    log("l0.sectors", **l0_sector_ops(flat, live))
    return {
        "name": "l0_delta",
        "route": "cuda",
        "source": "src/repro_torch/kernels/l0_sampler/csrc/l0_sampler.cu",
        "replaces": "src/repro/kernels/l0_sampler/kernel.py:104",
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


def _sample_solve_cpu(edges, n_nodes, prob):
    """The port's insert-mode solve of a recovered sample on the CPU (the
    plain versions), built by the same helper as ``TurnstileDensest.query``."""
    from repro_torch.core import solve
    from repro_torch.core.turnstile import sample_edgelist

    sample, _ = sample_edgelist(edges, n_nodes, "cpu")
    return solve(sample, dataclasses.replace(prob, stream_mode="insert", compaction="off",
                                             substrate="jit"))


def phase_turnstile(flickr) -> dict:
    """A churn stream over flickr_sm: its 7,065,860 edges inserted in
    batches of 2^20 (7 launches, the last padded), a seeded 10% deleted in
    one batch, then ``query()`` with the sample peel on K1."""
    import numpy as np
    import torch

    from repro_torch.core import Problem
    from repro_torch.core.turnstile import TurnstileDensest
    from repro_torch.graph.edgelist import apply_updates
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.l0_sampler.ops import add_wrapped
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    m = flickr.n_edges_padded
    rng = np.random.default_rng(0)
    del_idx = torch.from_numpy(np.sort(rng.choice(m, size=m // 10, replace=False))).to(DEV)
    dels = (flickr.src[del_idx].contiguous(), flickr.dst[del_idx].contiguous())
    prob = Problem.undirected(eps=EPS, stream_mode="turnstile", backend="pallas",
                              track_history=True)

    def stream():
        td = TurnstileDensest(flickr.n_nodes, prob, device=DEV)
        for i in range(0, m, TURNSTILE_BATCH):
            td.apply(insert_edges=(flickr.src[i:i + TURNSTILE_BATCH],
                                   flickr.dst[i:i + TURNSTILE_BATCH]))
        td.apply(delete_edges=dels)
        return td

    l0_ops.l0_delta.launches = 0
    tiled_degrees.launches = 0
    td, apply_ms, _, peak = _peak_run(stream)
    updates = td.sketch.updates_applied
    t0 = time.perf_counter()
    edges, level, info = td.sketch.recover()
    recover_ms = (time.perf_counter() - t0) * 1e3
    res, query_ms, syncs, _ = _peak_run(td.query)
    l0_launches, k1_launches = l0_ops.l0_delta.launches, tiled_degrees.launches
    n_batches = -(-m // TURNSTILE_BATCH) + 1  # the inserts, then one delete batch
    if not l0_launches == td.sketch.batches_applied == n_batches:
        raise AssertionError(f"K3 launches {l0_launches} for {td.sketch.batches_applied} batches")
    if k1_launches != res.passes or k1_launches == 0:
        raise AssertionError(f"K1 launches {k1_launches} for {res.passes} sample passes")
    log("turnstile", batches=td.sketch.batches_applied, updates=updates,
        apply_ms=apply_ms, updates_per_s=updates / (apply_ms / 1e3),
        peak_above_graph_mb=peak, k3_launches=l0_launches)
    log("turnstile", query_ms=query_ms, recover_ms=recover_ms,
        peel_ms=query_ms - recover_ms, level=level, sample_edges=len(edges),
        decode_rounds=info["decode_rounds"], passes=res.passes, k1_launches=k1_launches,
        host_syncs=syncs, rho=float(res.best_density), size=int(res.best_size))

    # The sketch equals the plain version applied to the same batches
    # (padding rows carry sign 0 and add nothing).
    plain = torch.zeros_like(td.sketch.tables)
    p = td.sketch.params
    for i in range(0, m, TURNSTILE_BATCH):
        s, d = flickr.src[i:i + TURNSTILE_BATCH], flickr.dst[i:i + TURNSTILE_BATCH]
        plain = add_wrapped(plain, _l0_plain(s, d, torch.ones_like(s), p))
    plain = add_wrapped(plain, _l0_plain(*dels, -torch.ones_like(dels[0]), p))
    check_equal("turnstile sketch vs plain", td.sketch.tables, plain)
    # Decode never fabricates: every recovered edge is live in the exact
    # host result of the same stream.
    final, stats = apply_updates(flickr, deletes=torch.stack(dels, 1).cpu().numpy())
    n = flickr.n_nodes
    fs, fd = final.src.cpu().numpy().astype(np.int64), final.dst.cpu().numpy().astype(np.int64)
    live = np.minimum(fs, fd) * n + np.maximum(fs, fd)
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1]  # recovered edges are u < v
    if not np.isin(keys, live).all():
        raise AssertionError(f"{int((~np.isin(keys, live)).sum())} recovered edges are not live")
    # The query equals the insert-mode solve of the recovered sample on the
    # CPU.
    want = _sample_solve_cpu(edges, n, td.problem)
    scale = float(2**level)
    for f in ("best_alive", "best_size", "alive", "history_n"):
        if not torch.equal(getattr(res, f).cpu(), getattr(want, f).cpu()):
            raise AssertionError(f"turnstile query {f} != the sample's CPU solve")
    for f in ("best_density", "history_m", "history_rho"):
        if not torch.equal(getattr(res, f).cpu(), (getattr(want, f) * scale).cpu()):
            raise AssertionError(f"turnstile query {f} != the sample's CPU solve x 2^level")
    log("turnstile", equal="sketch == plain bitwise; decode fabricated none of "
        f"{len(edges)} edges; query == insert-mode CPU solve of the sample",
        live_edges=len(live), deleted=stats["deleted"])
    # How far the sampled estimate lies from the exact peel of the live
    # graph (printed, not asserted: MTVV's envelope needs a sample of
    # n*polylog/eps^2 edges, and 16,384 is far below that at 976k nodes).
    from repro_torch.core import solve

    exact = solve(final, Problem.undirected(eps=EPS, compaction="off"))
    log("turnstile", exact_rho_live_graph=float(exact.best_density),
        sampled_over_exact=float(res.best_density) / float(exact.best_density),
        envelope=(1 + EPS) * (2 + 2 * EPS))
    phase_profile("turnstile_stream_and_query", lambda: stream().query())
    return {"launches": l0_launches}


def phase_golden_sketch_turnstile() -> None:
    """The quickstart and 200k graphs' ``sketch`` and ``turnstile`` cells
    on the card meet the JAX golden fixture (answer, counters or sketch
    tables, recovered edges, level)."""
    import torch_port_golden as golden
    from repro_torch.graph import generators

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["answers"]
    for name, (gen, kw) in golden.GRAPHS.items():
        out = getattr(generators, gen)(**kw, device=DEV)
        edges = out[0] if isinstance(out, tuple) else out
        for cell in ("sketch", "turnstile"):
            got = golden.port_entry(edges, cell)
            if got != fixture[name][cell]:
                raise AssertionError(f"{name}/{cell}: {got} != JAX golden {fixture[name][cell]}")
            shown = ("best_size", "passes", "level")
            log("golden", graph=name, cell=cell, equal="JAX golden",
                **{k: got[k] for k in shown if k in got})


# -- per-seed serving (the query engine, the local substrate, resilience) ----

# The engine's defaults in benchmarks/bench_serve.py:124-131 (radius 1, 128
# ego nodes, 16 queries a flush, eps 0.5, 32 passes; compaction off, as
# there); the local mode at repro_torch/constants.py's budget 512, 8
# rounds, alpha 1.0, volume factor 32.
SERVE_PROBLEM = dict(eps=EPS, max_passes=32, compaction="off")
SERVE_ENGINE = dict(radius=1, max_ego_nodes=128, max_batch=16)
SERVE_QUERIES = 256
SERVE_LJ_QUERIES = 64
SERVE_FRONT_DOOR = 4
SERVE_FAIL_PROB = 0.3


def serve_seeds(indptr, count: int) -> list:
    """``count`` seeds of degree >= 1, drawn by ``numpy.random.default_rng(0)``."""
    import numpy as np

    candidates = np.nonzero(np.diff(indptr) > 0)[0]
    return [int(x) for x in np.random.default_rng(0).choice(candidates, count, replace=False)]


def _pct(values, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def _timed_extraction(eng) -> dict:
    """Accumulates the host seconds ``eng`` spends extracting (wraps the
    engine's per-query extraction on this instance; ``del
    eng._extract_pending`` restores it)."""
    spent = {"s": 0.0}
    inner = eng._extract_pending

    def timed(q):
        t0 = time.perf_counter()
        try:
            return inner(q)
        finally:
            spent["s"] += time.perf_counter() - t0

    eng._extract_pending = timed
    return spent


def _serve_run(eng, seeds) -> tuple:
    """One pass of ``seeds`` through ``eng`` on the card: (results, numbers)."""
    import torch

    from repro_torch import hostsync

    spent = _timed_extraction(eng)
    flushes, lanes, pads = eng.batches_flushed, eng.lanes_solved, eng.pad_lanes
    touched, scanned = eng.local_nodes_touched, eng.local_edges_scanned
    torch.cuda.synchronize()
    hostsync.read.count = 0
    t0 = time.perf_counter()
    results = eng.query_many(seeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._extract_pending
    n_flush = eng.batches_flushed - flushes
    lat = [r.latency_s * 1e3 for r in results]
    numbers = dict(
        queries=len(seeds), wall_ms=wall * 1e3, qps=len(seeds) / wall,
        p50_ms=_pct(lat, 50), p99_ms=_pct(lat, 99), flushes=n_flush,
        distinct_buckets=len({r.bucket for r in results}),
        lanes=eng.lanes_solved - lanes, pad_lanes=eng.pad_lanes - pads,
        host_syncs_per_flush=hostsync.read.count / max(n_flush, 1),
        extract_ms=spent["s"] * 1e3, solve_ms=(wall - spent["s"]) * 1e3,
        extract_share=spent["s"] / wall,
    )
    if eng.extraction == "local":
        numbers.update(
            local_nodes_touched_per_query=(eng.local_nodes_touched - touched) / len(seeds),
            local_edges_scanned_per_query=(eng.local_edges_scanned - scanned) / len(seeds))
    return results, numbers


def _same_answer(what: str, got, want, fields=("density", "seed_in_set", "bucket", "n_ego",
                                                "m_ego")) -> None:
    import numpy as np

    if not np.array_equal(got.nodes, want.nodes):
        raise AssertionError(f"{what}: seed {got.seed} nodes differ")
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "density":
            a, b = np.float64(a).tobytes(), np.float64(b).tobytes()
        if a != b:
            raise AssertionError(f"{what}: seed {got.seed} {f} {getattr(got, f)} != "
                                 f"{getattr(want, f)}")


def phase_serve(flickr, flickr_cpu, extraction: str) -> None:
    """``DensestQueryEngine`` over flickr_sm on the card (``serve.bfs`` or
    ``serve.local``): 256 seeds in one ``query_many`` (logged; nothing
    compiles, so the first run is already a warm one), every answer
    ``'ok'`` and == a standalone ``solve`` of the same padded buffer on the card
    (bitwise, unit weights) and == the engine on the CPU; in local mode
    the first 4 seeds also == the front door ``solve(flickr,
    Problem(substrate='local'), seed=s)`` (it builds the CSR on every call,
    so only 4 seeds take it)."""
    import dataclasses

    from repro_torch.core import Problem, solve
    from repro_torch.serve import DensestQueryEngine

    label = f"serve.{extraction}"
    prob = Problem.undirected(**SERVE_PROBLEM)
    t0 = time.perf_counter()
    eng = DensestQueryEngine(flickr, prob, extraction=extraction, **SERVE_ENGINE)
    csr_s = time.perf_counter() - t0
    seeds = serve_seeds(eng._indptr, SERVE_QUERIES)
    results, numbers = _serve_run(eng, seeds)
    log(label, engine_build_s=csr_s, **numbers)
    for r in results:
        if r.status != "ok":
            raise AssertionError(f"{label}: seed {r.seed} answered {r.status}: {r.error}")
        padded, nodes = eng.extract(r.seed)
        one = solve(padded.to(flickr.device), prob)
        alive = one.nodes()
        want = dataclasses.replace(r, nodes=nodes[alive[alive < len(nodes)]],
                                   density=float(one.best_density))
        _same_answer(f"{label} lane vs standalone solve", r, want, fields=("density",))
        if r.bucket[:2] != (padded.n_nodes, padded.n_edges_padded):
            raise AssertionError(f"{label}: seed {r.seed} bucket {r.bucket} != buffer")
    cpu = DensestQueryEngine(flickr_cpu, prob, extraction=extraction, **SERVE_ENGINE)
    for a, b in zip(results, cpu.query_many(seeds)):
        _same_answer(f"{label} card vs CPU", a, b)
    checked = ["every lane == standalone solve on the card (bitwise)", "== engine on the CPU"]
    if extraction == "local":
        local = dataclasses.replace(prob, substrate="local")
        for r in results[:SERVE_FRONT_DOOR]:
            t0 = time.perf_counter()
            front = solve(flickr, local, seed=r.seed)
            front_ms = (time.perf_counter() - t0) * 1e3
            want = dataclasses.replace(r, nodes=front.nodes(), density=float(front.best_density))
            _same_answer(f"{label} lane vs front door", r, want, fields=("density",))
            log(label, front_door_seed=r.seed, front_door_ms=front_ms,
                bucket=front.extras["local"]["bucket"], size=int(front.best_size))
        checked.append(f"first {SERVE_FRONT_DOOR} == solve(flickr, Problem(substrate='local'), "
                       "seed=s)")
    log(label, equal="; ".join(checked), queries=len(seeds),
        buckets=sorted(eng.bucket_histogram.items()))
    phase_profile(f"{label}_one_flush", lambda: eng.query_many(seeds[:SERVE_ENGINE["max_batch"]]))


def phase_serve_livejournal(lj) -> None:
    """``serve.local.livejournal``: 64 seeds in local mode over
    livejournal_md; the per-query work and p50 beside flickr_sm's (work
    bounded by the budget, not by n)."""
    from repro_torch.core import Problem
    from repro_torch.serve import DensestQueryEngine

    t0 = time.perf_counter()
    eng = DensestQueryEngine(lj, Problem.undirected(**SERVE_PROBLEM), extraction="local",
                             **SERVE_ENGINE)
    csr_s = time.perf_counter() - t0
    seeds = serve_seeds(eng._indptr, SERVE_LJ_QUERIES)
    results, numbers = _serve_run(eng, seeds)
    if not all(r.status == "ok" for r in results):
        raise AssertionError("serve.local.livejournal: a query did not answer")
    log("serve.local.livejournal", engine_build_s=csr_s, nodes=lj.n_nodes,
        edges=lj.n_edges_padded, **numbers)


def _churn_service(flickr):
    """A ``TurnstileDensityService`` on the card fed the flickr_sm churn
    stream of ``phase_turnstile`` (2^20-row insert batches, then a seeded
    10% deleted in one batch), with the sample peel under ``'pallas'``."""
    import numpy as np
    import torch

    from repro_torch.core import Problem
    from repro_torch.serve import TurnstileDensityService

    m = flickr.n_edges_padded
    rng = np.random.default_rng(0)
    del_idx = torch.from_numpy(np.sort(rng.choice(m, size=m // 10, replace=False))).to(DEV)
    dels = (flickr.src[del_idx].contiguous(), flickr.dst[del_idx].contiguous())
    svc = TurnstileDensityService(flickr.n_nodes, Problem.undirected(
        eps=EPS, stream_mode="turnstile", backend="pallas"), device=DEV)
    for i in range(0, m, TURNSTILE_BATCH):
        svc.apply(insert_edges=(flickr.src[i:i + TURNSTILE_BATCH],
                                flickr.dst[i:i + TURNSTILE_BATCH]))
    svc.apply(delete_edges=dels)
    return svc


def phase_serve_resilience(flickr, flickr_cpu) -> None:
    """``serve.resilience``: the bfs engine under ``FaultPlan(seed=0)``
    failing each ``serve.solve`` with p 0.3, ``max_retries=2`` and every
    degrade rung on, a turnstile density service on the card attached (fed
    the churn stream through K3; its sample peel through K1); the (status,
    fallback, attempts) of every query == the port's engine on the CPU
    under the same plan, and the answers too.  The CPU engine reads the
    same service (its sketch on the CPU would cost a minute of plain K3);
    both engines read a frozen clock, so no circuit breaker's cooldown
    depends on the wall."""
    from repro_torch import faults
    from repro_torch.core import Problem
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.peel_degree.ops import tiled_degrees
    from repro_torch.serve import DensestQueryEngine, ResilienceConfig

    cfg = ResilienceConfig(max_retries=2, degrade_radius=True, degrade_turnstile=True,
                           degrade_last_good=True)
    l0_ops.l0_delta.launches = 0
    tiled_degrees.launches = 0
    t0 = time.perf_counter()
    svc = _churn_service(flickr)
    feed_ms = (time.perf_counter() - t0) * 1e3
    k3 = l0_ops.l0_delta.launches
    runs = {}
    for device, graph in ((DEV, flickr), ("cpu", flickr_cpu)):
        eng = DensestQueryEngine(graph, Problem.undirected(**SERVE_PROBLEM), resilience=cfg,
                                 time_fn=lambda: 0.0, **SERVE_ENGINE).attach_turnstile(svc)
        seeds = serve_seeds(eng._indptr, SERVE_QUERIES)
        t0 = time.perf_counter()
        with faults.active(faults.FaultPlan(seed=0).fail_prob("serve.solve", SERVE_FAIL_PROB)):
            results = eng.query_many(seeds)
        wall_ms = (time.perf_counter() - t0) * 1e3
        runs[device] = results
        if device != DEV:
            continue
        k1 = tiled_degrees.launches
        computed, served = svc.queries_computed, svc.queries_served
        passes = svc.result().passes  # the cached answer: no launch
        if k3 == 0 or k3 != svc.batches_applied:
            raise AssertionError(f"K3 launches {k3} != {svc.batches_applied} batches")
        if k1 == 0 or k1 != passes or computed != 1:
            raise AssertionError(f"K1 launches {k1} != the sample peel's {passes} passes "
                                 f"({computed} peels)")
        by = {}
        for r in results:
            key = r.status if r.fallback is None else f"{r.status}:{r.fallback.split(':')[0]}"
            by[key] = by.get(key, 0) + 1
        st = eng.stats()
        log("serve.resilience", queries=len(seeds), wall_ms=wall_ms, feed_ms=feed_ms,
            k3_launches=k3, batches=svc.batches_applied, k1_launches=k1, sample_passes=passes,
            outcomes=by, solve_retries=st["solve_retries"],
            breaker_open_skips=st["breaker_open_skips"],
            service_queries_computed=computed, service_queries_served=served)
    card, cpu = runs[DEV], runs["cpu"]
    for a, b in zip(card, cpu):
        if (a.status, a.fallback, a.attempts) != (b.status, b.fallback, b.attempts):
            raise AssertionError(f"serve.resilience seed {a.seed}: card {a.status}/{a.fallback}/"
                                 f"{a.attempts} != CPU {b.status}/{b.fallback}/{b.attempts}")
        if a.answered:
            _same_answer("serve.resilience card vs CPU", a, b, fields=("density", "bucket"))
    if not any(r.degraded for r in card):
        raise AssertionError("serve.resilience: the plan degraded no query")
    log("serve.resilience", equal="(status, fallback, attempts) and answers == the CPU run "
        "under the same plan")


def phase_build_cache() -> None:
    """``build.cache``: a fresh process loads all four libraries from the
    directory ``phase_build`` filled and runs nvcc zero times; a second
    fresh process asks for K3 with one nvcc flag changed (-O3 -> -O2)
    through ``load_library``'s build arguments and must miss and build."""
    import os

    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.peel_degree import ops as pd_ops

    sources = [str(o.SOURCE) for o in (pd_ops, cs_ops, l0_ops, fa_ops)]
    warm = (
        "import json, time; from pathlib import Path; from repro_torch import kernels\n"
        "def never(*a): raise SystemExit('nvcc ran')\n"
        "ms = {}\n"
        f"for s in {sources!r}:\n"
        "    t0 = time.perf_counter(); kernels.load_library(Path(s), build=never)\n"
        "    ms[Path(s).name] = (time.perf_counter() - t0) * 1e3\n"
        "c = kernels.PROCESS_COUNTERS\n"
        "print(json.dumps({'load_ms': ms, 'build_log': list(kernels.BUILD_LOG), "
        "'hits': c.disk_hits, 'misses': c.disk_misses}))\n"
    )
    changed = (
        "import json; from pathlib import Path; from repro_torch import kernels\n"
        "flags = tuple('-O2' if f == '-O3' else f for f in kernels.NVCC_FLAGS)\n"
        f"kernels.load_library(Path({sources[2]!r}), flags=flags)\n"
        "c = kernels.PROCESS_COUNTERS\n"
        "print(json.dumps({'build_log': {k: v['seconds'] for k, v in kernels.BUILD_LOG.items()},"
        " 'hits': c.disk_hits, 'misses': c.disk_misses, 'path': str(kernels.library_path("
        f"Path({sources[2]!r}), flags))}}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for name, code in (("warm", warm), ("changed_flag", changed)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              env=env, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"build.cache {name} child failed: {proc.stdout}{proc.stderr}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        out[name]["process_s"] = time.perf_counter() - t0
    w, c = out["warm"], out["changed_flag"]
    if w["build_log"] or (w["hits"], w["misses"]) != (4, 0):
        raise AssertionError(f"build.cache: a warm directory built {w}")
    if (c["hits"], c["misses"]) != (0, 1) or list(c["build_log"]) != ["l0_sampler.cu"]:
        raise AssertionError(f"build.cache: a changed nvcc flag did not miss {c}")
    log("build.cache", warm_load_ms=w["load_ms"], warm_nvcc_runs=len(w["build_log"]),
        warm_process_s=w["process_s"], changed_flag_nvcc_s=c["build_log"],
        changed_flag_entry=Path(c["path"]).name)


def phase_golden_serve() -> None:
    """``golden.serve``: the JAX golden fixture's serve entries (the engine
    in both modes and the local front door, on the quickstart and 200k
    graphs) on the card."""
    import torch_port_golden as golden

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["serve"]["answers"]
    for case in golden.SERVE_CASES:
        got = golden.port_serve_entry(case, DEV)
        if got != fixture[case]:
            bad = [i for i, (a, b) in enumerate(zip(got, fixture[case])) if a != b]
            raise AssertionError(f"golden serve {case}: entries {bad} differ from the JAX golden")
        log("golden", serve_case=case, equal="JAX golden", entries=len(got))


# -- the semi-streaming substrate (livejournal_md from a disk memmap) ----------

# The Problem defaults: 2^20-edge chunks, 4 workers, a window of 8 chunks.
STREAM_CHUNK = 1 << 20
STREAM_WORKERS = 4
STREAM_PREFETCH = 8
# Faults of the storm run: the first attempt of these chunk keys fails, and
# the first attempt of STREAM_SLOW_KEY sleeps (a straggler).
STREAM_FAIL_KEYS = (3, 17, 40)
STREAM_SLOW_KEY = 5
STREAM_SLOW_S = 0.2
F32_EXACT = 1 << 24  # f32 sums of unit weights are exact below this


def _stream_state_vs_ladder(what: str, st, res) -> dict:
    """A streaming run's state against the in-memory exact ladder's result:
    the best set, the best density's f32 bits, passes and history_n bitwise;
    history_m and history_rho bitwise on every pass whose alive edge count
    is below 2^24.  Above it the ladder's f32 sum of unit weights rounds in
    its reduction order while the driver adds chunk totals in f64 and
    rounds once: those passes must agree within 2 ulps, and the count of
    passes that differ is returned."""
    import numpy as np

    if st.pass_idx != res.passes:
        raise AssertionError(f"{what}: passes {st.pass_idx} != ladder's {res.passes}")
    if not np.array_equal(st.best_alive, res.best_alive.cpu().numpy()):
        raise AssertionError(f"{what}: best set differs from the ladder's")
    if np.float32(st.best_rho).tobytes() != res.best_density.cpu().numpy().tobytes():
        raise AssertionError(f"{what}: best density {st.best_rho} != {float(res.best_density)}")
    hist = np.asarray(st.history, np.float64).reshape(-1, 3)
    k = st.pass_idx
    want = [getattr(res, f).cpu().numpy()[:k] for f in ("history_n", "history_m", "history_rho")]
    if not np.array_equal(hist[:, 0].astype(np.int32), want[0]):
        raise AssertionError(f"{what}: history_n differs")
    rounded = 0
    for col, ref in ((hist[:, 1].astype(np.float32), want[1]),
                     (hist[:, 2].astype(np.float32), want[2])):
        ulps = np.abs(col.view(np.int32).astype(np.int64) - ref.view(np.int32))
        big = hist[:, 1] >= F32_EXACT
        if (ulps[~big] != 0).any() or (ulps[big] > 2).any():
            raise AssertionError(f"{what}: history differs from the ladder's: ulps {ulps.tolist()}")
        rounded += int((ulps != 0).sum())
    return {"passes_f32_rounded": rounded}


def stream_inputs(lj):
    """The livejournal_md edges on the host (what the store is written
    from) and the in-memory exact ladder on the card, with its peak device
    memory (graph included: it is the ladder's input)."""
    from repro_torch.core import Problem, solve

    m = lj.mask
    host = tuple(a[m].cpu().numpy() for a in (lj.src, lj.dst, lj.weight))
    graph_mb = sum(t.numel() * t.element_size() for t in (lj.src, lj.dst, lj.weight, lj.mask))
    ladder, wall, syncs, peak = _peak_run(lambda: solve(lj, Problem.undirected(
        eps=EPS, backend="exact", track_history=True)))
    log("stream.ladder", graph="livejournal_md", wall_ms=wall, passes=ladder.passes,
        host_syncs=syncs, peak_device_mb_with_graph=peak + graph_mb / 2**20,
        rho=float(ladder.best_density), size=int(ladder.best_size))
    return host, ladder, peak + graph_mb / 2**20


def _stream_run(store, n_nodes, max_passes=None, resume=False, **kw):
    """One streaming solve from the store on the card: (state, driver, wall
    ms, host syncs, peak device MB), every allocation of the run counted
    (nothing else is on the card)."""
    from repro_torch.core import StreamingDensest, chunked_from_memmap

    drv = StreamingDensest(chunked_from_memmap(store, STREAM_CHUNK), n_nodes, eps=EPS,
                           n_workers=STREAM_WORKERS, prefetch=STREAM_PREFETCH, device=DEV,
                           compaction="geometric", **kw)
    st, wall, syncs, peak = _peak_run(lambda: drv.run(max_passes=max_passes, resume=resume))
    return st, drv, wall, syncs, peak


def _same_stream(what: str, got, want) -> None:
    import numpy as np

    if (got.best_rho != want.best_rho or got.pass_idx != want.pass_idx
            or got.history != want.history or not np.array_equal(got.best_alive, want.best_alive)
            or not np.array_equal(got.alive, want.alive)):
        raise AssertionError(f"{what}: differs from the streaming run from disk")


def phase_stream(host, ladder, ladder_peak_mb, smi: str) -> None:
    """``stream``: livejournal_md written once to a memmap store in a
    temporary directory, then ``StreamingDensest(chunked_from_memmap(store,
    2^20), eps=0.5, compaction='geometric', device='cuda')`` at the Problem
    defaults (4 workers, window 8), against the in-memory exact ladder;
    again with ``spill_dir`` and a residency cap below the first rung's
    survivors; killed after 3 passes and resumed; under a seeded fault
    storm; each bitwise equal to the first run.  Host syncs, bytes to the
    card and edges streamed per pass, peak device memory against the
    ladder's, K1-K4 launches (none), one pass's profile and its host-read
    time."""
    import tempfile

    import torch

    from repro_torch import faults
    from repro_torch.core.streaming import _host_chunk, chunked_from_memmap
    from repro_torch.graph.edgelist import save_edges_memmap

    n = LIVEJOURNAL["n"]
    counters = _kernel_counters()
    with tempfile.TemporaryDirectory(prefix="stream_smoke_") as tmp:
        t0 = time.perf_counter()
        store = save_edges_memmap(f"{tmp}/store", *host)
        disk_mb = sum(a.nbytes for a in host) / 2**20
        log("stream.store", edges=len(host[0]), disk_mb=disk_mb,
            write_s=time.perf_counter() - t0)
        for c in counters:
            c.launches = 0
        st, drv, wall, syncs, peak = _stream_run(store, n)
        launches = {c.__name__: c.launches for c in counters}
        if any(launches.values()):
            raise AssertionError(f"the streaming path launched a kernel: {launches}")
        streamed = drv.bytes_to_device // 12
        log("stream", run="disk", card=smi, wall_ms=wall, passes=st.pass_idx,
            compactions=drv.compactions, host_syncs=syncs,
            host_syncs_per_pass=syncs / st.pass_idx,
            bytes_to_device_per_pass=drv.bytes_to_device / st.pass_idx,
            edges_streamed=streamed, edges_streamed_per_s=streamed / (wall / 1e3),
            speculative_reissues=drv.speculative_reissues,
            peak_resident_chunks=drv.peak_resident_chunks,
            peak_resident_edges=drv.peak_resident_edges, peak_device_mb=peak,
            ladder_peak_device_mb=ladder_peak_mb, kernel_launches=launches,
            rho=st.best_rho, size=int(st.best_alive.sum()))
        rounded = _stream_state_vs_ladder("stream vs in-memory ladder", st, ladder)
        log("stream", equal="== the in-memory exact ladder (set, density, passes, history)",
            **rounded)

        # The spill ladder: survivors on disk, the host holding only the
        # window.  The cap is the window; without a spill the first rung's
        # survivors must overflow it.
        cap = STREAM_PREFETCH * STREAM_CHUNK
        try:
            _stream_run(store, n, residency_cap_edges=cap)
        except RuntimeError as e:
            if "spill_dir" not in str(e):
                raise
        else:
            raise AssertionError("the capped in-RAM rebuild did not refuse")
        sp, sdrv, swall, ssyncs, speak = _stream_run(store, n, residency_cap_edges=cap,
                                                      spill_dir=f"{tmp}/spill")
        _same_stream("spill run", sp, st)
        if sdrv.spill_rungs < 1 or sdrv.peak_resident_edges > cap:
            raise AssertionError(f"spill run: {sdrv.spill_rungs} rungs, "
                                 f"{sdrv.peak_resident_edges} edges resident")
        log("stream", run="spill", wall_ms=swall, passes=sp.pass_idx,
            spill_rungs=sdrv.spill_rungs, host_syncs=ssyncs,
            peak_resident_edges=sdrv.peak_resident_edges, residency_cap_edges=cap,
            peak_device_mb=speak, equal="== disk run bitwise")

        # Kill after 3 passes, resume from the checkpoint.
        ck = f"{tmp}/ck"
        part, _, kwall, _, _ = _stream_run(store, n, checkpoint_dir=ck, max_passes=3)
        res, _, rwall, rsyncs, _ = _stream_run(store, n, checkpoint_dir=ck, resume=True)
        if part.pass_idx != 3:
            raise AssertionError(f"the killed run made {part.pass_idx} passes")
        _same_stream("kill/resume", res, st)
        log("stream", run="kill_resume", killed_wall_ms=kwall, resumed_wall_ms=rwall,
            resumed_passes=res.pass_idx - 3, resumed_host_syncs=rsyncs,
            equal="== disk run bitwise")

        # A seeded fault storm on the chunk site.
        plan = faults.FaultPlan(seed=0).latency("streaming.chunk", STREAM_SLOW_S,
                                                key=STREAM_SLOW_KEY, nth=(1,))
        for k in STREAM_FAIL_KEYS:
            plan = plan.fail_nth("streaming.chunk", 1, key=k)
        with faults.active(plan):
            fs, fdrv, fwall, _, _ = _stream_run(store, n)
        _same_stream("fault storm", fs, st)
        if fdrv.speculative_reissues < 1:
            raise AssertionError("the fault storm re-issued no chunk")
        log("stream", run="fault_storm", wall_ms=fwall, failed_keys=list(STREAM_FAIL_KEYS),
            slow_key=STREAM_SLOW_KEY, speculative_reissues=fdrv.speculative_reissues,
            equal="== disk run bitwise")

        # Where one full pass goes: the host reads (memmap -> staged
        # arrays, one thread), then the card's side by the profiler.
        stream = chunked_from_memmap(store, STREAM_CHUNK)
        out = _host_chunk(next(stream()))
        t0 = time.perf_counter()
        for chunk in stream():
            _host_chunk(chunk, [o[: len(chunk[0])] for o in out])
        log("stream.pass", host_read_ms_one_thread=(time.perf_counter() - t0) * 1e3,
            chunks=-(-len(host[0]) // STREAM_CHUNK))
        alive = torch.ones(n, dtype=torch.bool, device=DEV)
        phase_profile("stream_one_pass", lambda: drv._pass_stats(alive, stream))


def phase_stream_flickr(flickr, flickr_cpu) -> None:
    """``stream.flickr``: the front door ``solve(g, Problem(substrate=
    'streaming'))`` on flickr_sm with its node state on the card == the same
    on the CPU, bitwise; then the golden fixture's streaming entries on the
    card."""
    import torch_port_golden as golden
    from repro_torch.core import Problem, solve

    prob = Problem.undirected(eps=EPS, substrate="streaming", track_history=True)
    card, wall, syncs, peak = _peak_run(lambda: solve(flickr, prob))
    t0 = time.perf_counter()
    cpu = solve(flickr_cpu, prob)
    cpu_s = time.perf_counter() - t0
    _same_outcome("stream flickr card vs CPU", card, cpu)
    log("stream.flickr", wall_ms=wall, cpu_wall_s=cpu_s, passes=card.passes, host_syncs=syncs,
        peak_device_mb=peak, streaming=card.extras["streaming"],
        equal="card == CPU bitwise (sets, density, passes, history)")
    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["streaming"]["answers"]
    for case in golden.STREAM_CASES:
        if golden.port_stream_entry(case, DEV) != fixture[case]:
            raise AssertionError(f"golden streaming {case} differs from the JAX golden")
        log("golden", stream_case=case, equal="JAX golden")


# -- the §5.2 mesh substrate, NCCL at world size 1 ----------------------------

# flickr_sm's twophase cell compacts after this many passes (it peels in ~5).
MESH_TWOPHASE_PASSES = 2


def mesh_inputs():
    """A one-rank card mesh (NCCL, bound to the card) and a one-rank CPU
    mesh (gloo) in this process: the world ``make_mesh`` starts runs
    ``cpu:gloo,cuda:nccl`` over an in-memory store."""
    from repro_torch.core.mapreduce import make_mesh

    mesh = make_mesh((1,), ("data",))
    cpu_mesh = make_mesh((1,), ("data",), device="cpu")
    log("mesh.init", card=str(mesh), cpu=str(cpu_mesh))
    return mesh, cpu_mesh


def _mesh_run(fn):
    """``_peak_run(fn)`` with the collectives counted from 0: (result, wall
    ms, host syncs, peak MB, collectives)."""
    from repro_torch import collectives

    collectives.reset()
    out, wall, syncs, peak = _peak_run(fn)
    coll = {"all_reduce": collectives.all_reduce.count,
            "all_reduce_mb": collectives.all_reduce.bytes / 1e6,
            "all_gather": collectives.all_gather.count,
            "all_gather_mb": collectives.all_gather.bytes / 1e6}
    return out, wall, syncs, peak, coll


def _ladder_reduces(lad) -> int:
    """All-reduces of a collective ladder: one at entry, one a pass, one
    more a pass for the trigger outside the last rung."""
    segs = lad["segments"]
    return 1 + sum(g["passes"] for g in segs) + sum(g["passes"] for g in segs[:-1])


def phase_mesh_livejournal(lj, ladder, sketch, mesh) -> dict:
    """``mesh.livejournal``: livejournal_md on the one-rank NCCL mesh.
    ``Problem.undirected(substrate='mesh')`` resolves compaction 'auto' to
    the collective ladder; it equals the in-memory jit ladder field for
    field (its rung schedule differs).  ``backend='sketch'`` builds its
    counters with K2 once a pass on the rank's shard and equals the
    ``livejournal`` phase's jit sketch solve field for field.  Each run's
    collectives are counted: one all_reduce a pass (19.36 MB of [deg |
    total] for the exact mesh, (5·8192 + 1)·4 B for the sketch), one more
    for the ladder's trigger, four gathers a rung."""
    import torch

    from repro_torch.core import Problem, solve
    from repro_torch.kernels.count_sketch import ops as cs_ops

    prob = Problem.undirected(eps=EPS, substrate="mesh", track_history=True)
    res, wall, syncs, peak, coll = _mesh_run(lambda: solve(lj, prob, mesh=mesh))
    lad = res.extras["compaction"]
    if res.provenance.compaction != "geometric" or not lad["single_program"]:
        raise AssertionError(f"mesh auto resolved to {res.provenance}, {lad}")
    _same_outcome("livejournal mesh ladder vs jit ladder", res, ladder)
    if coll["all_reduce"] != _ladder_reduces(lad) or coll["all_gather"] != 4 * (
            len(lad["segments"]) - 1):
        raise AssertionError(f"mesh ladder collectives {coll} for {lad['segments']}")
    log("mesh.livejournal", cell="exact, collective ladder", wall_ms=wall, passes=res.passes,
        host_syncs=syncs, peak_above_graph_mb=peak,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20, **coll,
        reduce_mb_per_pass=(lj.n_nodes + 1) * 4 / 1e6, schedule=lad["schedule"],
        rung_passes=[g["passes"] for g in lad["segments"]],
        jit_ladder_segments=len(ladder.extras["compaction"]["segments"]),
        equal="mesh ladder == jit ladder bitwise (sets, density, passes, history)")
    # The first mesh solve also sets up the edge group's NCCL communicator.
    _, warm_wall, _, _ = _peak_run(lambda: solve(lj, prob, mesh=mesh))
    _, jit_wall, jit_syncs, jit_peak = _peak_run(lambda: solve(lj, Problem.undirected(
        eps=EPS, track_history=True)))
    log("mesh.livejournal", cell="exact, collective ladder, again", wall_ms=warm_wall)
    log("mesh.livejournal", cell="jit ladder (comparator)", wall_ms=jit_wall,
        host_syncs=jit_syncs, peak_above_graph_mb=jit_peak)
    phase_profile("livejournal_mesh_ladder", lambda: solve(lj, prob, mesh=mesh))
    phase_profile("livejournal_jit_ladder", lambda: solve(lj, Problem.undirected(eps=EPS)))

    prob_s = Problem.undirected(eps=EPS, substrate="mesh", backend="sketch", track_history=True)
    cs_ops.count_sketch_update.launches = 0
    res_s, wall_s, syncs_s, peak_s, coll_s = _mesh_run(lambda: solve(lj, prob_s, mesh=mesh))
    launches = cs_ops.count_sketch_update.launches
    if launches != res_s.passes:
        raise AssertionError(f"mesh sketch: K2 launches {launches} != passes {res_s.passes}")
    if coll_s["all_reduce"] != res_s.passes or coll_s["all_gather"] != 0:
        raise AssertionError(f"mesh sketch collectives {coll_s}")
    _same_outcome("livejournal mesh sketch vs jit sketch", res_s, sketch)
    log("mesh.livejournal", cell="sketch (K2)", wall_ms=wall_s, passes=res_s.passes,
        host_syncs=syncs_s, k2_launches=launches, peak_above_graph_mb=peak_s, **coll_s,
        reduce_kb_per_pass=(prob_s.sketch_tables * prob_s.sketch_buckets + 1) * 4 / 1e3,
        equal="mesh sketch == jit sketch bitwise (sets, density, passes, history)")
    phase_profile("livejournal_mesh_sketch", lambda: solve(lj, prob_s, mesh=mesh))
    return {"mesh.livejournal": launches}


def phase_mesh_flickr(flickr, flickr_cpu, mesh, cpu_mesh) -> None:
    """``mesh.flickr``: flickr_sm on the card mesh (NCCL) == on the CPU mesh
    (gloo), world size 1, for compaction off, twophase and the bf16 wire."""
    from repro_torch.core import Problem, solve

    cells = {
        "off": dict(compaction="off"),
        "twophase": dict(compaction="twophase", twophase_passes=MESH_TWOPHASE_PASSES),
        "off.bf16": dict(compaction="off", wire_dtype="bf16"),
    }
    for name, kw in cells.items():
        prob = Problem.undirected(eps=EPS, substrate="mesh", track_history=True, **kw)
        card, wall, syncs, peak, coll = _mesh_run(lambda: solve(flickr, prob, mesh=mesh))
        t0 = time.perf_counter()
        cpu = solve(flickr_cpu, prob, mesh=cpu_mesh)
        cpu_s = time.perf_counter() - t0
        _same_outcome(f"flickr mesh {name} card vs CPU", card, cpu)
        if coll["all_reduce"] != card.passes or coll["all_gather"] != 0:
            raise AssertionError(f"flickr mesh {name} collectives {coll}")
        log("mesh.flickr", cell=name, wall_ms=wall, cpu_wall_s=cpu_s, passes=card.passes,
            host_syncs=syncs, peak_above_graph_mb=peak, **coll,
            equal="card (NCCL) == CPU (gloo) bitwise (sets, density, passes, history)")


def phase_mesh_directed(dg, mesh) -> None:
    """``mesh.directed``: the directed 976k planted graph at c=4 on the
    card mesh (the collective ladder) == its jit solve (the host ladder)."""
    from repro_torch.core import Problem, solve

    kw = dict(c=DIRECTED_C, eps=EPS, track_history=True)
    want, wall_j, _, _ = _peak_run(lambda: solve(dg, Problem.directed(**kw)))
    got, wall, syncs, peak, coll = _mesh_run(lambda: solve(
        dg, Problem.directed(substrate="mesh", **kw), mesh=mesh))
    _same_outcome("directed mesh ladder vs jit ladder", got, want)
    lad = got.extras["compaction"]
    if coll["all_reduce"] != _ladder_reduces(lad):
        raise AssertionError(f"directed mesh collectives {coll} for {lad['segments']}")
    log("mesh.directed", c=DIRECTED_C, wall_ms=wall, jit_wall_ms=wall_j, passes=got.passes,
        host_syncs=syncs, peak_above_graph_mb=peak, **coll, schedule=lad["schedule"],
        equal="mesh ladder == jit ladder bitwise (S, T, density, passes, history)")


def _kernel_counters():
    """The four kernels' launch-counting wrappers."""
    from repro_torch.kernels.count_sketch.ops import count_sketch_update
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.l0_sampler.ops import l0_delta
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    return (tiled_degrees, count_sketch_update, l0_delta, flash_attention)


# -- Algorithms 2 and 3 and the sweep driver, through K1 and K2 ---------------

# Algorithm 2's size floor at flickr_sm: the undirected best set there is a
# few thousand nodes, so k binds.
TOPK_K = 100_000
SWEEP_EPS = [0.25, 0.5, 1.0]
# A planted S->T block (2,000 x 500 pairs, each kept with p 0.2: ~200k
# edges) in a directed ER background at flickr_sm's scale (7.6M edges) and
# at livejournal_md's (68.9M edges).
DIRECTED_FLICKR = dict(n=976_000, avg_deg=7.8, ks=2_000, kt=500, p_dense=0.2, seed=0)
DIRECTED_LJ = dict(n=4_840_000, avg_deg=14.24, ks=2_000, kt=500, p_dense=0.2, seed=0)
DIRECTED_C = 4.0
def phase_topk(flickr) -> None:
    """Algorithm 2 on flickr_sm through the ladder: ``backend='pallas'``
    (K1 once a pass) == ``'exact'`` bitwise, and the best set has at least
    k nodes."""
    from repro_torch.core import Problem, solve
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    runs = {}
    for backend in ("pallas", "exact"):
        prob = Problem.at_least_k(k=TOPK_K, eps=EPS, backend=backend, track_history=True)
        tiled_degrees.launches = 0
        res, wall, syncs, peak = _peak_run(lambda: solve(flickr, prob))
        launches = tiled_degrees.launches
        runs[backend] = (res, launches)
        log("topk", backend=backend, k=TOPK_K, wall_ms=wall, passes=res.passes,
            segments=len(res.extras["compaction"]["segments"]), host_syncs=syncs,
            k1_launches=launches, peak_above_graph_mb=peak, rho=float(res.best_density),
            size=int(res.best_size))
    (res_p, launches_p), (res_e, launches_e) = runs["pallas"], runs["exact"]
    _same_outcome("topk pallas vs exact", res_p, res_e)
    if launches_p != res_p.passes or launches_e != 0:
        raise AssertionError(f"K1 launches {launches_p} (pallas) / {launches_e} (exact) "
                             f"for {res_p.passes} passes")
    if int(res_p.best_size) < TOPK_K:
        raise AssertionError(f"at_least_k best set {int(res_p.best_size)} < k={TOPK_K}")
    log("topk", equal="pallas == exact bitwise (sets, density, passes, history)",
        best_size=int(res_p.best_size), k=TOPK_K, k1_launches=launches_p)
    phase_profile("flickr_topk_pallas", lambda: solve(flickr, Problem.at_least_k(
        k=TOPK_K, eps=EPS, backend="pallas")))


def phase_sweep(flickr) -> None:
    """An eps sweep on flickr_sm under ``'pallas'``: one peel loop for all
    lanes, K1 once per live lane a pass, one host sync a pass; each lane
    bitwise equal to a standalone solve (the ladder) at its eps."""
    from repro_torch.core import Problem, solve, solve_batch
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    prob = Problem.undirected(backend="pallas", track_history=True)
    tiled_degrees.launches = 0
    sweep, wall, syncs, peak = _peak_run(lambda: solve_batch(flickr, prob, eps=SWEEP_EPS))
    launches = tiled_degrees.launches
    mp = sweep.provenance.max_passes
    if launches != sum(sweep.passes):
        raise AssertionError(f"K1 launches {launches} != lanes' passes {sweep.passes}")
    if syncs > max(sweep.passes) + 2:
        raise AssertionError(f"{syncs} host syncs for lanes of {sweep.passes} passes")
    log("sweep", eps=SWEEP_EPS, wall_ms=wall, passes=sweep.passes, max_passes=mp,
        host_syncs=syncs, k1_launches=launches, peak_above_graph_mb=peak,
        rho=[float(x) for x in sweep.best_density], size=[int(x) for x in sweep.best_size])
    walls = []
    for i, e in enumerate(SWEEP_EPS):
        one, wall_1, _, _ = _peak_run(lambda: solve(flickr, Problem.undirected(
            eps=e, backend="pallas", track_history=True, max_passes=mp)))
        walls.append(wall_1)
        _same_outcome(f"sweep lane eps={e} vs standalone", sweep, one, lane=i)
    log("sweep", equal="every lane == its standalone solve bitwise", standalone_wall_ms=walls)
    phase_profile("flickr_eps_sweep_pallas", lambda: solve_batch(flickr, prob, eps=SWEEP_EPS))


def _block_density(edges, s_ids, t_ids) -> float:
    """|E(S*, T*)| / sqrt(|S*||T*|) of the planted block (ids are ranges)."""
    import math

    s0, s1 = int(s_ids[0]), int(s_ids[-1]) + 1
    t0, t1 = int(t_ids[0]), int(t_ids[-1]) + 1
    inside = (edges.mask & (edges.src >= s0) & (edges.src < s1)
              & (edges.dst >= t0) & (edges.dst < t1))
    return int(inside.sum().item()) / math.sqrt(len(s_ids) * len(t_ids))


def phase_directed(mesh) -> None:
    """Algorithm 3 on the planted S->T block at flickr_sm's scale: the
    41-value c grid (delta 2) through the ladder with exact degrees, the
    block recovered (>= 70% of S* and of T*, density >= the block's /
    (2(1+eps)delta)); then ``solve_batch(c=grid)``, each lane bitwise equal
    to that c's standalone solve."""
    import numpy as np

    from repro_torch.core import Problem, solve, solve_batch
    from repro_torch.graph import generators

    t0 = time.perf_counter()
    dg, s_ids, t_ids = generators.directed_planted(**DIRECTED_FLICKR, device=DEV)
    log("directed.graph", nodes=dg.n_nodes, edges=dg.n_edges_padded,
        gen_seconds=round(time.perf_counter() - t0, 3))
    prob = Problem.directed(eps=EPS)
    res, wall, syncs, peak = _peak_run(lambda: solve(dg, prob))
    ex = res.extras
    grid = ex["c_grid"]
    s_rec = len(np.intersect1d(res.nodes(), s_ids)) / len(s_ids)
    t_rec = len(np.intersect1d(res.t_nodes(), t_ids)) / len(t_ids)
    block = _block_density(dg, s_ids, t_ids)
    floor = block / (2 * (1 + EPS) * prob.c_delta)
    log("directed", grid_size=len(grid), best_c=ex["best_c"], wall_ms=wall,
        passes_per_c=[int(x) for x in ex["c_passes"]], host_syncs=syncs,
        peak_above_graph_mb=peak, rho=float(res.best_density), s_size=len(res.nodes()),
        t_size=len(res.t_nodes()), recall_s=s_rec, recall_t=t_rec, block_density=block)
    if s_rec < 0.7 or t_rec < 0.7:
        raise AssertionError(f"planted block recall S {s_rec}, T {t_rec} < 0.7")
    if float(res.best_density) < floor:
        raise AssertionError(f"best density {float(res.best_density)} < block/6 = {floor}")
    sweep, wall_s, syncs_s, peak_s = _peak_run(lambda: solve_batch(dg, prob, c=grid))
    log("directed.sweep", lanes=len(grid), wall_ms=wall_s, passes=sweep.passes,
        host_syncs=syncs_s, peak_above_graph_mb=peak_s)
    if syncs_s > max(sweep.passes) + 2:
        raise AssertionError(f"{syncs_s} host syncs for lanes of {sweep.passes} passes")
    for i, c in enumerate(grid):
        one = solve(dg, Problem.directed(c=float(c), eps=EPS, track_history=False))
        _same_outcome(f"c sweep lane c={c} vs its solve", sweep, one, lane=i)
        if float(one.best_density) != ex["c_density"][i] or one.passes != ex["c_passes"][i]:
            raise AssertionError(f"c={c}: solve differs from the grid's per-c solve")
    best = int(np.argmax(sweep.best_density.cpu().numpy()))
    log("directed", equal="every c lane == its per-c solve (== the grid's) bitwise",
        sweep_best_c=float(grid[best]), grid_best_c=ex["best_c"])
    phase_profile("directed_c_grid", lambda: solve(dg, prob))
    phase_profile("directed_c_sweep", lambda: solve_batch(dg, prob, c=grid))
    phase_mesh_directed(dg, mesh)


def phase_directed_sketch() -> None:
    """Algorithm 3 at livejournal_md's scale (68.9M edges drawn) through
    ``backend='auto'`` (the Count-Sketch above 1M nodes): two K2 launches a
    pass (out and in tables), and the answer equals the same peel over the
    plain counters bit for bit while every counter's partial sums stay
    within 2^24."""
    import torch

    from repro_torch.core import Problem, solve
    from repro_torch.core.countsketch import (
        _estimates, _query_index, make_sketch_params, median_over_tables,
    )
    from repro_torch.core.engine import DirectedST, run_peel
    from repro_torch.graph import generators
    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.count_sketch.ref import count_sketch_update_ref

    t_phase = time.perf_counter()
    dl, s_ids, t_ids = generators.directed_planted(**DIRECTED_LJ, device=DEV)
    log("directed.sketch.graph", nodes=dl.n_nodes, edges=dl.n_edges_padded,
        gen_seconds=round(time.perf_counter() - t_phase, 3))
    prob = Problem.directed(c=DIRECTED_C, eps=EPS, backend="auto", track_history=True)
    cs_ops.count_sketch_update.launches = 0
    res, wall, syncs, peak = _peak_run(lambda: solve(dl, prob))
    launches = cs_ops.count_sketch_update.launches
    if res.provenance.backend != "sketch" or res.provenance.compaction != "off":
        raise AssertionError(f"auto resolved to {res.provenance}")
    if launches != 2 * res.passes:
        raise AssertionError(f"K2 launches {launches} != 2 x passes {res.passes}")
    log("directed.sketch", backend="auto->sketch", c=DIRECTED_C, wall_ms=wall,
        passes=res.passes, host_syncs=syncs, k2_launches=launches, peak_above_graph_mb=peak,
        rho=float(res.best_density), s_size=int(res.best_size),
        t_size=int(res.best_t.sum()))

    p = make_sketch_params(prob.sketch_tables, prob.sketch_buckets, prob.sketch_seed)
    index = _query_index(p, torch.arange(dl.n_nodes, dtype=torch.int32, device=DEV))
    # Each counter's absolute mass at pass 0 (every edge alive, unit
    # weights) bounds its partial sums in every pass.
    most = 0
    for ids in (dl.src[dl.mask].long(), dl.dst[dl.mask].long()):
        for row in index[0]:
            most = max(most, int(torch.bincount(row[ids]).max().item()))
    if most > 2**24:
        raise AssertionError(f"a counter's mass {most} passes 2^24: not bitwise")

    class PlainCounters:
        def directed(self, edges, w_alive):
            c_out = count_sketch_update_ref(edges.src, w_alive, p)
            c_in = count_sketch_update_ref(edges.dst, w_alive, p)
            return (median_over_tables(_estimates(c_out, *index)),
                    median_over_tables(_estimates(c_in, *index)), w_alive.sum())

    before = cs_ops.count_sketch_update.launches
    plain = run_peel(dl, DirectedST(eps=EPS, c=torch.tensor(DIRECTED_C)), PlainCounters(),
                     prob.resolved_max_passes(dl.n_nodes), track_history=True)
    if cs_ops.count_sketch_update.launches != before:
        raise AssertionError("the plain-counter peel launched K2")
    _same_outcome("directed sketch (K2) vs plain counters", res, plain)
    log("directed.sketch", equal="K2 solve == plain-counter solve bitwise (S, T, density, "
        "passes, history)", max_counter_mass=most)
    phase_profile("directed_auto_sketch", lambda: solve(dl, prob))
    log("directed.sketch", phase_seconds=round(time.perf_counter() - t_phase, 3))


def phase_golden_objectives() -> None:
    """Algorithms 2 and 3 and an eps sweep on the card meet the JAX golden
    fixture's ``objectives`` entries."""
    import torch_port_golden as golden

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["objectives"]["answers"]
    for case in golden.OBJECTIVE_CASES:
        got = golden.port_objective_entry(case, DEV)
        if got != fixture[case]:
            raise AssertionError(f"{case}: {got} != JAX golden {fixture[case]}")
        first = got[0] if isinstance(got, list) else got
        log("golden", case=case, equal="JAX golden", best_size=first["best_size"],
            passes=[g["passes"] for g in got] if isinstance(got, list) else first["passes"])


# -- K4 and the LM path (llama3.2-3b at full width) ---------------------------


# K4's shapes: the reference's kernel tests, then the main path's (B=1, an
# 8,192-token prompt, 24/8 heads, D=128, bf16), a ragged length, mixtral's
# window, kv positions that are not an arange (a stride of 3, with a
# window of 3 * 1,000 positions), and D=64 at a length that is not a
# multiple of the 128-key tile.  (B, S, Hq, Hkv, D, window, dtype, stride
# of the positions)
FLASH_CASES = [
    (2, 256, 4, 4, 64, None, "float32", 1), (1, 256, 8, 2, 64, None, "float32", 1),
    (2, 384, 4, 2, 32, 128, "float32", 1), (1, 300, 2, 1, 64, None, "float32", 1),
    (1, 256, 4, 4, 64, None, "bfloat16", 1),
    (1, 8192, 24, 8, 128, None, "bfloat16", 1), (1, 8000, 24, 8, 128, None, "bfloat16", 1),
    (1, 8192, 24, 8, 128, 4096, "bfloat16", 1), (1, 4096, 24, 8, 128, 3000, "bfloat16", 3),
    (2, 1000, 16, 4, 64, None, "bfloat16", 1),
]
# K4 against its plain version, two limits.  Elementwise, rtol = atol =
# the reference tests' own (2e-5 f32, 2e-2 bf16): at the main shape a late
# row's outputs are ~0.015-0.02, no larger than that atol, so it holds the
# early rows only.  Per row (one query, one head, D values), the relative
# L2 error ||got - want|| / ||want||, which is scale-free and holds every
# row: K4 and the plain version round p to bf16 at other points and then
# round the output, a few bf16 ulps at most.  Three controls must fail
# them in every case (PERF.md has the readings on both sides).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_ROW_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
LM_PROMPT = 8192


def flash_pairs(q_positions, kv_positions, window) -> int:
    """Allowed (query, key) pairs of one head: kpos <= qpos (and kpos >
    qpos - window), counted from the positions by a search in the sorted
    keys."""
    import torch

    kp = torch.sort(kv_positions.long()).values
    qp = q_positions.long()
    n = torch.searchsorted(kp, qp, right=True)
    if window is not None:
        n = n - torch.searchsorted(kp, qp - window, right=True)
    return int(n.sum().item())


def flash_bound_ms(q, k, pairs: int) -> tuple:
    """Least time on the card for one K4 call: the larger of its FLOPs
    (q.k and p.v, 2*D each per allowed pair and query head) over the
    dtype's peak and its bytes (q, k, v read once, the output written
    once, the positions) over HBM bandwidth.  Returns (ms, 'operations' or
    'bytes')."""
    import torch

    b, sq, hq, d = q.shape
    flops = 4.0 * d * hq * b * pairs
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * (sq + k.shape[1])
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _flash_inputs(b, s, hq, hkv, d, dtype, seed, stride=1):
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, hq, d, generator=g, device=DEV).to(dt)
    k = torch.randn(b, s, hkv, d, generator=g, device=DEV).to(dt)
    v = torch.randn(b, s, hkv, d, generator=g, device=DEV).to(dt)
    return q, k, v, stride * torch.arange(s, dtype=torch.int32, device=DEV)


def flash_controls(q, k, v, qpos, kpos, window, want, tile: int) -> dict:
    """The plain version with three faults a wrong K4 could have: the
    diagonal dropped from every row's mask (kpos < qpos); the diagonal
    dropped in the second half of the rows only; one allowed kv tile of
    ``tile`` keys dropped, the one before the middle query's diagonal, which
    changes every later row it reaches and none before."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_ref as ref

    half = q.shape[1] // 2
    late = want.clone()
    late[:, half:] = ref(q[:, half:], k, v, qpos[half:], kpos + 1, window=window).float()
    key = int(torch.searchsorted(kpos.long(), qpos[half:half + 1].long())[0])
    start = max(0, (key // tile - 1) * tile)
    kp = kpos.clone()
    kp[start:start + tile] = 2 ** 30  # a position no query reaches
    return {
        "diagonal": ref(q, k, v, qpos, kpos + 1, window=window).float(),
        "late_diagonal": late,
        "interior_tile": ref(q, k, v, qpos, kp, window=window).float(),
    }


def flash_errors(got, want, dtype: str) -> dict:
    """Readings of ``got`` against ``want`` (both float32) at FLASH_TOL and
    FLASH_ROW_TOL: values outside the elementwise limit, rows outside the
    row limit, the largest absolute and row-relative errors."""
    tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
    err = (got - want).abs()
    row = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return dict(outside=int((err > tol + tol * want.abs()).sum()),
                rows_outside=int((row > row_tol).sum()),
                max_abs_err=err.max().item(), max_row_rel_err=row.max().item())


def phase_flash_kernel() -> dict:
    """K4 against its plain version on the card, within FLASH_TOL
    (elementwise) and FLASH_ROW_TOL (per row); in every case three controls
    (:func:`flash_controls`) must fail those limits.  Then K4's time at
    S=8192 and 32768 beside its bound, the plain version's (8192) and
    ``scaled_dot_product_attention``'s."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        KV_TILE_BF16, KV_TILE_F32, Q_BLOCK_BF16, flash_attention, tile_bounds,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref, tile_bounds_ref

    errs, failures = [], []
    for i, (b, s, hq, hkv, d, window, dtype, stride) in enumerate(FLASH_CASES):
        q, k, v, pos = _flash_inputs(b, s, hq, hkv, d, dtype, seed=i, stride=stride)
        got = flash_attention(q, k, v, q_positions=pos, kv_positions=pos, window=window).float()
        want = flash_attention_ref(q, k, v, pos, pos, window=window).float()
        kernel = flash_errors(got, want, dtype)
        del got
        tile = KV_TILE_BF16 if dtype == "bfloat16" else KV_TILE_F32  # K4's kv tile
        controls = {name: flash_errors(ctrl, want, dtype) for name, ctrl in
                    flash_controls(q, k, v, pos, pos, window, want, tile).items()}
        del want
        if dtype == "bfloat16":  # the plan (K4's first launch) against its plain version
            qpos = pos[s // 3:]
            check_equal(f"K4 plan {s}", tile_bounds(qpos, pos).cpu(),
                        tile_bounds_ref(qpos.cpu(), pos.cpu(), Q_BLOCK_BF16, KV_TILE_BF16))
        case = f"B{b}_S{s}_H{hq}/{hkv}_D{d}_w{window}_{dtype}_pos{stride}x"
        log("flash.check", case=case,
            tolerance=f"rtol=atol={FLASH_TOL[dtype]}, row {FLASH_ROW_TOL[dtype]}", **kernel,
            controls=controls)
        if kernel["outside"] or kernel["rows_outside"]:
            failures.append(f"K4 {case}: {kernel}")
        for name, c in controls.items():
            if not (c["outside"] or c["rows_outside"]):
                failures.append(f"K4 {case}: the {name} control passes both limits")
        errs.append(kernel["max_abs_err"])
        del q, k, v
    if failures:
        raise AssertionError("; ".join(failures))
    torch.cuda.empty_cache()

    # Timing at the main path's shape, then at 32,768 tokens.
    timed = {}
    hq, hkv, d = 24, 8, 128  # llama3.2-3b
    for s in (LM_PROMPT, 4 * LM_PROMPT):
        q, k, v, pos = _flash_inputs(1, s, hq, hkv, d, "bfloat16", seed=s)
        n = TIMED_LAUNCHES if s == LM_PROMPT else 5
        ms = time_ms(lambda: flash_attention(q, k, v, q_positions=pos, kv_positions=pos), n=n)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n=n)
        plain_ms = None
        if s == LM_PROMPT:
            plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, pos, pos), n=5, warmup=1)
        # The plan alone (K4's first launch, inside kernel_ms too).
        plan_ms = time_ms(lambda: tile_bounds(pos, pos), n=n)
        pairs = flash_pairs(pos, pos, None)
        bound_ms, bound_by = flash_bound_ms(q, k, pairs)
        timed[s] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        log("flash.time", seq=s, kernel_ms=ms, plain_ms=plain_ms, library_ms_sdpa=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, allowed_pairs_per_head=pairs,
            roofline_share=bound_ms / ms, tflops=4.0 * d * hq * pairs / ms / 1e9,
            plan_ms=plan_ms, vs_sdpa=ms / library_ms)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    main = timed[LM_PROMPT]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "max_abs_err": max(errs),
        **main,
        "ms_32768": timed[4 * LM_PROMPT]["ms"],
        "library_ms_32768": timed[4 * LM_PROMPT]["library_ms"],
        "bound_ms_32768": timed[4 * LM_PROMPT]["bound_ms"],
    }


def lm_config(**kw):
    """llama3.2-3b at full width (src/repro/configs/llama3_2_3b.py)."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("llama3.2-3b").config, remat=False, **kw)


def _row_rel_err(got, want) -> float:
    """Largest relative L2 error of one position's K (or V) row, over every
    layer, position and kv head."""
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()


# The pallas prefill against the xla prefill of the same weights, bf16.
# The two attention paths round p to bf16 at other points (the xla path
# normalizes first), so the residual streams drift apart by bf16 flips;
# these limits sit between that drift and a control that drops the
# diagonal from layer 0's mask (PERF.md has the readings).
LM_CACHE_REL_TOL = 0.1
LM_LOGITS_TOL = 0.25


def phase_lm_prefill(params, tokens) -> dict:
    """llama3.2-3b, 28 layers, one 8,192-token prompt: ``prefill`` with
    ``attn_impl='pallas'`` (K4, counted) against ``'xla'``, same weights."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer

    runs = {}
    for impl in ("pallas", "xla", "pallas", "xla"):
        cfg = lm_config(attn_impl=impl)
        flash_attention.launches = 0
        (logits, cache, cur_len), wall, _, peak = _peak_run(
            lambda: transformer.prefill(params, cfg, tokens))
        launches = flash_attention.launches
        if launches != (cfg.n_layers if impl == "pallas" else 0):
            raise AssertionError(f"{impl} prefill: {launches} K4 launches, {cfg.n_layers} layers")
        log("lm.prefill", impl=impl, run="second" if impl in runs else "first",
            prompt=tokens.shape[1], wall_ms=wall, peak_above_weights_mb=peak,
            peak_device_mb=torch.cuda.max_memory_allocated() / 2**20, k4_launches=launches,
            greedy=int(logits.argmax()))
        runs.setdefault(impl, (logits, cache, launches))
        del logits, cache
    (lp, cp, launches), (lx, cx, _) = runs["pallas"], runs["xla"]

    # The control: the xla prefill with layer 0's mask missing its diagonal.
    real = transformer.gqa_attention
    calls = []

    def no_diagonal_in_layer0(q, k, v, *, q_positions, kv_positions, **kw):
        calls.append(1)
        if len(calls) == 1:
            kv_positions = kv_positions + 1  # kpos + 1 <= qpos: kpos < qpos
        return real(q, k, v, q_positions=q_positions, kv_positions=kv_positions, **kw)

    transformer.gqa_attention = no_diagonal_in_layer0
    try:
        lc, cc, _ = transformer.prefill(params, lm_config(attn_impl="xla"), tokens)
    finally:
        transformer.gqa_attention = real

    layer0_equal = all(torch.equal(cp[key][0], cx[key][0]) for key in ("k", "v"))
    cache_err = max(_row_rel_err(cp[key], cx[key]) for key in ("k", "v"))
    ctrl_cache_err = max(_row_rel_err(cc[key], cx[key]) for key in ("k", "v"))
    logits_err = (lp - lx).abs().max().item()
    ctrl_logits_err = (lc - lx).abs().max().item()
    top2 = torch.topk(lx[0], 2).values
    margin = (top2[0] - top2[1]).item()
    same_greedy = int(lp.argmax()) == int(lx.argmax())
    log("lm.prefill", layer0_cache="bitwise equal" if layer0_equal else "DIFFERS",
        cache_row_rel_err=cache_err, cache_tol=LM_CACHE_REL_TOL,
        control_cache_row_rel_err=ctrl_cache_err, logits_max_abs_err=logits_err,
        logits_tol=LM_LOGITS_TOL, control_logits_max_abs_err=ctrl_logits_err,
        logits_std=lx.std().item(), greedy_pallas=int(lp.argmax()), greedy_xla=int(lx.argmax()),
        xla_top1_top2_margin=margin,
        greedy="equal" if same_greedy else
        ("DIFFERS" if margin > LM_LOGITS_TOL else "differs at a near tie (margin <= logits_tol)"))
    if not layer0_equal:
        raise AssertionError("layer 0's K/V cache differs: it is computed before any attention")
    if cache_err > LM_CACHE_REL_TOL or logits_err > LM_LOGITS_TOL:
        raise AssertionError(f"pallas vs xla prefill: cache {cache_err}, logits {logits_err}")
    if ctrl_cache_err <= LM_CACHE_REL_TOL or ctrl_logits_err <= LM_LOGITS_TOL:
        raise AssertionError(f"the diagonal-dropped control passes a check (cache "
                             f"{ctrl_cache_err}, logits {ctrl_logits_err})")
    # Below LM_LOGITS_TOL the top two logits are a near tie that the allowed
    # drift may flip; the logits limit is the check there.
    if not same_greedy and margin > LM_LOGITS_TOL:
        raise AssertionError(f"the greedy token differs between the pallas and xla prefill "
                             f"at a top-1/top-2 margin of {margin}")
    return {"launches": launches}


SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW = 4, 6, 16


def phase_lm_serve(params) -> None:
    """``ServeEngine`` at full width, ``attn_impl='xla'`` (decode has no
    pallas path, as in the reference), float32 compute: 4 slots, 6
    requests of 512-2,048-token prompts, 16 new tokens each.  Every request
    is answered, and one request's tokens equal the argmax chain of full
    forwards (teacher-forced: one forward over the prompt and the tokens,
    whose argmax at each new position must be the next token)."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import decode_step, forward
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = lm_config(attn_impl="xla", compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(512, 2049, SERVE_REQUESTS)]
    eng = ServeEngine(params, cfg, n_slots=SERVE_SLOTS, max_len=2048 + SERVE_NEW, device=DEV)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=SERVE_NEW))
    done, decode_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        admits = bool(eng.queue) and any(r is None for r in eng.slot_req)
        t1 = time.perf_counter()
        done.extend(eng.step())  # ends in the sampler's copy to the host
        if not admits:
            decode_ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in done)
    log("lm.serve", requests=len(done), prompt_lens=[len(p) for p in prompts],
        generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        decode_steps=len(decode_ms), median_decode_step_ms=float(np.median(decode_ms)),
        cache_mb=sum(c.numel() * c.element_size() for c in eng.cache.values()) / 2**20)
    if len(done) != SERVE_REQUESTS or any(len(r.tokens) != SERVE_NEW for r in done):
        raise AssertionError(f"{len(done)} of {SERVE_REQUESTS} requests answered")
    req = min(done, key=lambda r: len(r.prompt))
    seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
    logits, _ = forward(params, cfg, torch.as_tensor(seq, device=DEV)[None])
    new = logits[0, len(req.prompt) - 1:]
    chain = new.argmax(-1).tolist()
    top2 = torch.topk(new, 2, dim=-1).values
    log("lm.serve", rid=req.rid, prompt=len(req.prompt), engine_tokens=req.tokens,
        forward_argmax_chain=chain,
        least_top1_top2_margin=(top2[:, 0] - top2[:, 1]).min().item())
    if chain != req.tokens:
        raise AssertionError(f"request {req.rid}: engine {req.tokens} != forward chain {chain}")
    # Where a decode step's time goes (every slot, after the run).
    cur = torch.as_tensor(eng.cur_len, device=DEV)
    toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device=DEV)
    phase_profile("llama_decode_step_f32", lambda: decode_step(params, cfg, eng.cache, toks, cur))


def phase_lm_golden() -> None:
    """The REDUCED llama3.2-3b on the card (float32 compute) meets the JAX
    golden fixture: prefill logits through K4, the engine's greedy tokens,
    their margins; dense and window=16."""
    import torch_port_golden as golden

    from repro_torch.kernels.flash_attention.ops import flash_attention

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["lm"]["answers"]
    for case in golden.LM_CASES:
        before = flash_attention.launches
        got = golden.port_lm_entry(case, DEV)
        bad = golden.lm_mismatch(got, fixture[case])
        if bad or flash_attention.launches == before:
            raise AssertionError(f"lm golden {case}: {bad or 'K4 never launched'}")
        log("golden", lm_case=case, equal=f"JAX golden (tokens; logits rtol=atol="
            f"{golden.LM_LOGITS_TOL})", tokens=got["tokens"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core import Problem, solve
    from repro_torch.graph import generators

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    # Path 1: Algorithm 1 on the ladder through K1 (flickr_sm).
    t0 = time.perf_counter()
    flickr = generators.chung_lu_power_law(**FLICKR, device=DEV)
    log("flickr.graph", nodes=flickr.n_nodes, edges=flickr.n_edges_padded,
        gen_seconds=round(time.perf_counter() - t0, 3))
    k1 = phase_kernel(flickr)
    phase_quickstart()
    k1.update(phase_flickr(flickr))
    phase_profile("flickr_pallas", lambda: solve(flickr, Problem.undirected(eps=EPS,
                                                                            backend="pallas")))
    # Path 2: the Count-Sketch backend through K2 (livejournal_md).
    t0 = time.perf_counter()
    lj = generators.chung_lu_power_law(**LIVEJOURNAL, device=DEV)
    log("livejournal.graph", nodes=lj.n_nodes, edges=lj.n_edges_padded,
        gen_seconds=round(time.perf_counter() - t0, 3))
    k2 = phase_sketch_kernel(lj)
    k2_lj, lj_sketch = phase_livejournal(lj)
    k2.update(k2_lj)
    phase_profile("livejournal_auto_sketch", lambda: solve(lj, Problem.undirected(
        eps=EPS, backend="auto")))
    # Path 6 (its livejournal_md part): per-seed local serving.
    phase_serve_livejournal(lj)
    # Path 7: the semi-streaming substrate, livejournal_md from a disk
    # memmap with nothing else on the card.
    lj_host, ladder, ladder_peak_mb = stream_inputs(lj)
    # Path 8: the §5.2 mesh substrate on a one-rank NCCL mesh (K2 on the
    # sketch cell), against the in-memory ladder and the sketch solve.
    mesh, cpu_mesh = mesh_inputs()
    k2["launches_by_path"] = {"livejournal": k2["launches"],
                              **phase_mesh_livejournal(lj, ladder, lj_sketch, mesh)}
    del lj, lj_sketch
    torch.cuda.empty_cache()
    phase_stream(lj_host, ladder, ladder_peak_mb, smi)
    del lj_host, ladder
    # Path 3: the turnstile runtime through K3 (and K1 on the sample).
    k3 = phase_l0_kernel(flickr)
    k3.update(phase_turnstile(flickr))
    phase_golden_sketch_turnstile()
    # Path 5: Algorithms 2 and 3 and the sweep driver through K1 and K2.
    phase_topk(flickr)
    phase_sweep(flickr)
    # Path 6: per-seed serving (the engine in both modes, the local front
    # door, the resilience ladder over the turnstile service: K3 and K1)
    # and the cache of built kernels.
    flickr_cpu = flickr.to("cpu")
    phase_serve(flickr, flickr_cpu, "bfs")
    phase_serve(flickr, flickr_cpu, "local")
    phase_serve_resilience(flickr, flickr_cpu)
    phase_stream_flickr(flickr, flickr_cpu)
    phase_mesh_flickr(flickr, flickr_cpu, mesh, cpu_mesh)
    del flickr_cpu
    phase_build_cache()
    phase_golden_serve()
    del flickr
    torch.cuda.empty_cache()
    phase_directed(mesh)
    torch.cuda.empty_cache()
    phase_directed_sketch()
    torch.cuda.empty_cache()
    phase_golden_objectives()
    # Path 4: the LM at full width through K4 (llama3.2-3b).
    from repro_torch.models.transformer import init_params, prefill

    k4 = phase_flash_kernel()
    t0 = time.perf_counter()
    params = init_params(lm_config(), torch.Generator(device=DEV).manual_seed(0), DEV)
    tokens = torch.randint(0, lm_config().vocab, (1, LM_PROMPT), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    torch.cuda.synchronize()
    log("lm.model", arch="llama3.2-3b", layers=lm_config().n_layers,
        params=lm_config().param_count(),
        weights_mb=torch.cuda.memory_allocated() / 2**20,
        init_seconds=round(time.perf_counter() - t0, 3))
    k4.update(phase_lm_prefill(params, tokens))
    phase_profile("llama_prefill_pallas",
                  lambda: prefill(params, lm_config(attn_impl="pallas"), tokens))
    phase_lm_serve(params)
    del params
    torch.cuda.empty_cache()
    phase_lm_golden()
    import torch.distributed as dist

    dist.destroy_process_group()
    log("done", seconds=round(time.perf_counter() - t_start, 3))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern}
                                  for kern in (k1, k2, k3, k4)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
