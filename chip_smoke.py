#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from the sources in this checkout (one
``nvcc`` each, all started together), holds each against its plain PyTorch
version on the card, then drives the port's thirteen paths through the
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
  fresh process that loads the five libraries from the cache of built
  kernels with no ``nvcc``, and the golden fixture's serve entries;
* the semi-streaming substrate: livejournal_md written to a memmap store
  on disk and streamed in 2^20-edge chunks by ``StreamingDensest`` with its
  node state on the card (no kernel of K1-K4b; ``index_add_``), against the
  in-memory exact ladder, with the spill ladder, a kill and resume, and a
  seeded fault storm; the front door on flickr_sm against the CPU driver;
* the §5.2 mesh substrate on a one-rank NCCL mesh (``make_mesh``):
  livejournal_md on the collective ladder against the in-memory jit
  ladder and with ``backend='sketch'`` (K2 once a pass on the rank's
  shard) against the jit sketch solve, flickr_sm with compaction off,
  twophase and the bf16 wire against the same on a one-rank gloo mesh on
  the CPU, and the directed 976k graph at c=4 against its jit solve, each
  run's collectives counted;
* the port's benchmarks and examples (``benchmarks/torch_port/``,
  ``examples/torch_port/``) at the reference's defaults, on the graphs and
  the NCCL mesh above: the engine's backends, compaction and the mesh
  ladders, the front door and K1's load, every table and figure of the
  paper (Table 4 on livejournal_md), streaming, turnstile (K3 once a
  batch), serving with a cold start of K1-K3 in fresh processes,
  resilience, and the five examples; each record is printed on a
  ``[bench.*]`` line and written under experiments/bench/torch/;
* the LM path at the full width of llama3.2-3b (28 layers, random weights
  from a seeded ``torch.Generator``): ``prefill`` of an 8,192-token prompt
  with ``attn_impl='pallas'`` (K4, flash attention, once per layer)
  against ``'xla'``, and the ``ServeEngine`` answering 6 requests;
* mixtral-8x7b at full width, 4 of its 32 layers (the MoE FFN: 8 experts,
  top-2, capacity 1.25, groups of 1,024): ``prefill`` of an 8,192-token
  prompt through K4's sliding window (4,096) against ``'xla'``, the MoE
  share of its device time, the ``ServeEngine`` answering 4 requests at
  capacity 8.0 (each answer against a full forward), and the drop share at
  the config's own capacity;
* training, llama3.2-3b at full width (28 layers, 4,096-token sequences,
  remat on, ``attn_impl='auto'``: the chunked path, bf16 compute, f32
  parameters and moments): step 1 under 'auto' against 'xla' and a
  no-diagonal control, three ``make_train_step`` steps (AdamW in place),
  one profiled; ``flash_attention_trainable`` (K4's forward with its
  log-sum-exp, the backward kernel K4b) at the same attention shape
  against K4b's plain version (the chunked vjp), three controls and dense
  autodiff; the golden training entries of the five LM archs' REDUCED
  configs; and ``python -m repro_torch.launch.train`` killed and resumed in
  child processes, bitwise;
* the GNN and recsys families at their published widths (no kernel of
  K1-K4b: gathers, ``index_add_`` and GEMMs): graphsage-reddit on the
  232,965-node, 114.6M-edge minibatch_lg graph through the layered sampler
  and full batch on ogb_products (2.45M nodes, 61.9M edges), each GNN arch
  on 128 molecules, equiformer-v2 on full_graph_sm, each step 1 at bf16
  against f32 and a control, three train steps; mace's and egnn's
  invariance checks; the two-tower model's serving, retrieval over 1M
  candidates and training at a 32,768 batch; the tiled neighbor sum on the
  NCCL mesh; examples/torch_port/community_gnn.py; the golden ``gnn_train``
  entries; and ``launch.train`` for each of the five archs.

Answers are checked against the exact backend, the plain versions, the
port on the CPU and the JAX package's golden fixture
(tests/fixtures/torch_port/golden.json), the LM's against its ``'xla'``
path, its full forward and the golden fixture's REDUCED-config entries (mixtral
and llama4 among them).
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
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))  # benchmarks.torch_port, examples/torch_port

from repro_torch.configs.densest_mapreduce import chung_lu_args  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
F32_FLOPS = 67e12  # outside the tensor cores
# Dense TF32 on the tensor cores.  K4's and K4b's f32 kernels take each
# product as three TF32 products (split TF32), so their other bound is 3x
# the FLOPs at this rate; an f32 bound_ms is the lower of the two.
TF32_FLOPS = 495e12
EPS = 0.5
# The Chung-Lu draws of configs/densest_mapreduce.py's flickr_sm and
# livejournal_md (their node counts; the average degree that draws their
# edge counts; exponent 2.2, seed 0).
FLICKR = chung_lu_args("flickr_sm")
LIVEJOURNAL = chung_lu_args("livejournal_md")
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
    """Builds K1, K2, K3, K4 and K4b from this checkout's sources, one
    ``nvcc`` per source, all started together.  Then K4's and K4b's kernels
    as ``ptxas`` built them (registers, spills, shared memory; a K4b bf16
    kernel that spills fails) and the count
    of ``wgmma`` (HGMMA) and TMA load (UTMALDG) instructions in each
    library's SASS; K1's, K2's and K3's atomic and warp-exchange
    instructions by form (K1 must have no shared atomic and a global
    reduction)."""
    from repro_torch.kernels import BUILD_LOG, library_path, load_library
    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.peel_degree import ops as pd_ops

    sources = [pd_ops.SOURCE, cs_ops.SOURCE, l0_ops.SOURCE, fa_ops.SOURCE, fa_ops.BWD_SOURCE]
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
    for label, source, smem in (
            ("k4", fa_ops.SOURCE, lambda dp: fa_ops.bf16_smem_bytes(dp)),
            ("k4b", fa_ops.BWD_SOURCE, lambda dp: fa_ops.bwd_bf16_smem_bytes(dp))):
        ptxas = str(BUILD_LOG.get(source.name, {}).get("ptxas", ""))
        for name, props in _ptxas_kernels(ptxas).items():
            log(f"build.{label}", kernel=name, **props)
            # K4b's bf16 kernels keep both accumulators in registers (one
            # dK/dV pass), and every f32 (split-TF32) kernel of K4 and K4b
            # its accumulators and fragments: a spill there is a regression.
            if (("bf16" in name and label == "k4b") or "f32" in name) and (
                    props.get("spill_stores") or props.get("spill_loads")):
                raise AssertionError(f"{label}'s {name} spills: {props}")
        found = sass_counts(library_path(source), r"\b(?:HGMMA|UTMALDG|MUFU\.EX2|HMMA)\b")
        counts = {op: found.get(op, 0) for op in ("HGMMA", "UTMALDG", "MUFU.EX2", "HMMA")}
        log(f"build.{label}", sass_instructions=counts,
            bf16_dynamic_smem_bytes={dp: smem(dp) for dp in (64, 128)},
            f32_dynamic_smem_bytes={dp: fa_ops.f32_smem_bytes(dp) for dp in (32, 64, 128)})
        if not (counts["HGMMA"] and counts["UTMALDG"]):
            raise AssertionError(f"{label}'s library has no wgmma or no TMA load: {counts}")
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
    ``ptxas -v`` output, by the demangled-enough kernel name (its integer
    and bool template arguments: ``flash_fwd_bf16<128,1>``)."""
    import re

    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            kern = re.search(r"(flash_[a-z0-9_]+?)(I(?:L[a-z]\d+E)+E)?(?=E|$)", raw)
            if kern is None:
                name = raw
            else:
                args = re.findall(r"L[a-z](\d+)E", kern.group(2) or "")
                name = kern.group(1) + (f"<{','.join(args)}>" if args else "")
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


def phase_profile(label: str, run, span=None, kinds=None, **extra) -> None:
    """Where one run's device time goes, by kernel name (torch.profiler),
    and the device's busy share of its wall time (the wall measured on a
    run without the profiler): ``device_busy_ms`` sums every activity's
    time, ``device_busy_union_ms`` counts time when activities on several
    streams overlap once, and the idle share is taken from the union.

    ``span=(owner, name)`` runs ``owner.name`` (a module's function or a
    class's staticmethod) inside ``torch.profiler.record_function(name)``
    during the profiled run and reports the device time of the kernels
    launched inside the range (``span_device_ms``, the range's device total
    in ``key_averages``) and its share of ``device_busy_ms``; a list of
    ``(owner, name, label)`` reports each label's ranges (``spans``).
    ``kinds={kind: substrings}`` sums the device time of the kernels whose
    name holds one of the substrings.  ``extra`` is logged on the line (the
    card)."""
    import inspect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    one = isinstance(span, tuple)
    spans = [] if span is None else [span + (span[1],)] if one else list(span)
    saved = []
    for owner, name, tag in spans:
        real = inspect.getattr_static(owner, name)
        fn = real.__func__ if isinstance(real, staticmethod) else real

        def annotated(*args, _fn=fn, _tag=tag, **kw):
            with record_function(_tag):
                return _fn(*args, **kw)

        saved.append((owner, name, real))
        setattr(owner, name, staticmethod(annotated) if isinstance(real, staticmethod)
                else annotated)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)

    def dev_us(ev):
        return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)

    cuda = torch.autograd.DeviceType.CUDA
    tags = {tag for _, _, tag in spans}  # a range on the device is no kernel
    rows = [ev for ev in prof.key_averages() if ev.device_type == cuda and ev.key not in tags]
    busy_ms = sum(dev_us(ev) for ev in rows) / 1e3
    if busy_ms == 0:
        log("profile", run=label,
            device_time="not measured (the profiler recorded no device events)", wall_ms=wall_ms,
            **extra)
        return
    union_ms = _union_ms((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                         if ev.device_type == cuda and ev.name not in tags)
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_busy_union_ms=union_ms,
               device_busy_share=union_ms / wall_ms, device_idle_share=1 - union_ms / wall_ms)
    by_span = {}
    for tag in sorted(tags):
        host = [ev for ev in prof.key_averages() if ev.key == tag and ev.device_type != cuda]
        span_ms = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                      for ev in host) / 1e3
        by_span[tag] = dict(calls=sum(ev.count for ev in host),
                            device_ms=span_ms or "not measured",
                            share_of_busy=span_ms / busy_ms if span_ms else "not measured")
    if one:
        (tag, r), = by_span.items()
        out.update(span=tag, span_calls=r["calls"], span_device_ms=r["device_ms"],
                   span_share_of_busy=r["share_of_busy"])
    elif by_span:
        out["spans"] = by_span
    if kinds:
        out["kinds_ms"] = {kind: sum(dev_us(ev) for ev in rows
                                     if any(w in ev.key for w in words)) / 1e3
                           for kind, words in kinds.items()}
    log("profile", run=label, **out, **extra)
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
    """``build.cache``: a fresh process loads all five libraries from the
    directory ``phase_build`` filled and runs nvcc zero times; a second
    fresh process asks for K3 with one nvcc flag changed (-O3 -> -O2)
    through ``load_library``'s build arguments and must miss and build."""
    import os

    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.peel_degree import ops as pd_ops

    sources = [str(o.SOURCE) for o in (pd_ops, cs_ops, l0_ops, fa_ops)] + [str(fa_ops.BWD_SOURCE)]
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
    if w["build_log"] or (w["hits"], w["misses"]) != (len(sources), 0):
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
    ladder's, K1-K4b launches (none), one pass's profile and its host-read
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
    """The five kernels' launch-counting wrappers."""
    from repro_torch.kernels.count_sketch.ops import count_sketch_update
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.l0_sampler.ops import l0_delta
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    return (tiled_degrees, count_sketch_update, l0_delta, flash_attention, flash_attention_bwd)


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
# window of 3 * 1,000 positions), D=64 at a length that is not a multiple
# of the 128-key tile, and path 10's (mixtral: 32/8 heads, window 4,096);
# then f32 at full width (the trainable route's 4,096 causal, a 3,000
# window over positions of stride 3, and 8,000 rows for the ragged edge of
# the 64-row blocks and 32-key tiles).  (B, S, Hq, Hkv, D, window, dtype,
# stride of the positions)
FLASH_CASES = [
    (2, 256, 4, 4, 64, None, "float32", 1), (1, 256, 8, 2, 64, None, "float32", 1),
    (2, 384, 4, 2, 32, 128, "float32", 1), (1, 300, 2, 1, 64, None, "float32", 1),
    (1, 256, 4, 4, 64, None, "bfloat16", 1),
    (1, 8192, 24, 8, 128, None, "bfloat16", 1), (1, 8000, 24, 8, 128, None, "bfloat16", 1),
    (1, 8192, 24, 8, 128, 4096, "bfloat16", 1), (1, 4096, 24, 8, 128, 3000, "bfloat16", 3),
    (2, 1000, 16, 4, 64, None, "bfloat16", 1), (1, 8192, 32, 8, 128, 4096, "bfloat16", 1),
    (1, 4096, 24, 8, 128, None, "float32", 1), (1, 4096, 24, 8, 128, 3000, "float32", 3),
    (1, 8000, 24, 8, 128, None, "float32", 1),
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


def f32_bounds_ms(flops: float) -> dict:
    """The two operation bounds of f32 work: ``flops`` at the f32 FMA rate
    outside the tensor cores, and 3 x ``flops`` (split TF32) at the TF32
    tensor-core rate."""
    return {"simt_ms": flops / F32_FLOPS * 1e3, "tf32_split_ms": 3 * flops / TF32_FLOPS * 1e3}


def ops_bound_ms(flops: float, dtype) -> float:
    """``flops`` at the dtype's peak: bf16 on the tensor cores; f32 the
    lower of :func:`f32_bounds_ms`."""
    import torch

    if dtype == torch.bfloat16:
        return flops / BF16_FLOPS * 1e3
    return min(f32_bounds_ms(flops).values())


def flash_bound_ms(q, k, pairs: int) -> tuple:
    """Least time on the card for one K4 call: the larger of its FLOPs
    (q.k and p.v, 2*D each per allowed pair and query head) over the
    dtype's peak (:func:`ops_bound_ms`) and its bytes (q, k, v read once,
    the output written once, the positions) over HBM bandwidth.  Returns
    (ms, 'operations' or 'bytes')."""
    b, sq, hq, d = q.shape
    flops = 4.0 * d * hq * b * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * (sq + k.shape[1])
    ops_ms, bytes_ms = ops_bound_ms(flops, q.dtype), nbytes / HBM_BYTES_PER_S * 1e3
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


def phase_flash_kernel(smi: str) -> dict:
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
    # f32 (the split-TF32 kernels) at the trainable route's 4,096 and the
    # prefill's 8,192, beside SDPA's f32 forward and both f32 bounds.
    f32_timed = {}
    for s in (LM_PROMPT // 2, LM_PROMPT):
        q, k, v, pos = _flash_inputs(1, s, hq, hkv, d, "float32", seed=s)
        ms = time_ms(lambda: flash_attention(q, k, v, q_positions=pos, kv_positions=pos))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n=10)
        pairs = flash_pairs(pos, pos, None)
        bound_ms, bound_by = flash_bound_ms(q, k, pairs)
        f32_timed[s] = dict(ms=ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                            **f32_bounds_ms(4.0 * d * hq * pairs))
        log("flash.time", seq=s, dtype="float32", kernel_ms=ms, library_ms_sdpa=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, bounds_f32=f32_bounds_ms(4.0 * d * hq * pairs),
            allowed_pairs_per_head=pairs, roofline_share=bound_ms / ms,
            tflops=4.0 * d * hq * pairs / ms / 1e9, vs_sdpa=ms / library_ms, card=smi)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    # Path 10's shape: mixtral's 32/8 heads and window of 4,096 at 8,192
    # tokens; the library call is SDPA with the window as a boolean mask.
    window = moe_config().window
    q, k, v, pos = _flash_inputs(1, MOE_PROMPT, 32, 8, d, "bfloat16", seed=10)
    ms = time_ms(lambda: flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                         window=window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), n=5)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, pos, pos, window=window), n=5,
                       warmup=1)
    pairs = flash_pairs(pos, pos, window)
    bound_ms, bound_by = flash_bound_ms(q, k, pairs)
    log("flash.time", seq=MOE_PROMPT, heads="32/8", window=window, kernel_ms=ms,
        plain_ms=plain_ms, library_ms_sdpa_masked=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, allowed_pairs_per_head=pairs, roofline_share=bound_ms / ms,
        tflops=4.0 * d * 32 * pairs / ms / 1e9, vs_sdpa=ms / library_ms, card=smi)
    del q, k, v, qt, kt, vt, mask
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
        "moe_window": dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by),
        "f32": {str(s): rec for s, rec in f32_timed.items()},
    }


def lm_config(**kw):
    """llama3.2-3b at full width (src/repro/configs/llama3_2_3b.py)."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("llama3.2-3b").config, remat=False, **kw)


def _row_rel_errs(got, want):
    """Each cached position's relative L2 error of its K (or V) row (every
    layer, position and kv head), as one flat tensor."""
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).reshape(-1)


def _row_rel_err(got, want) -> float:
    """The largest of :func:`_row_rel_errs`."""
    return _row_rel_errs(got, want).max().item()


@contextlib.contextmanager
def _without_diagonal(layer: int = 0):
    """The control of the prefill and training checks: layer ``layer``'s
    attention drops the diagonal from its mask (kpos < qpos), in the forward
    and in remat's recompute alike (the layer is told by a tag on its
    parameter dict)."""
    from repro_torch.models import transformer

    pick, block, attn = transformer.layer_params, transformer._attention_block, \
        transformer.gqa_attention

    def tagged(params, i):
        return {**pick(params, i), "_no_diagonal": i == layer}

    def no_diagonal(q, k, v, *, q_positions, kv_positions, **kw):
        return attn(q, k, v, q_positions=q_positions, kv_positions=kv_positions + 1, **kw)

    def maybe_dropped(cfg, p, x, positions):
        if not p.get("_no_diagonal"):
            return block(cfg, p, x, positions)
        transformer.gqa_attention = no_diagonal
        try:
            return block(cfg, p, x, positions)
        finally:
            transformer.gqa_attention = attn

    transformer.layer_params, transformer._attention_block = tagged, maybe_dropped
    try:
        yield
    finally:
        transformer.layer_params, transformer._attention_block = pick, block


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
    with _without_diagonal():
        lc, cc, _ = transformer.prefill(params, lm_config(attn_impl="xla"), tokens)

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


# -- Path 10: mixtral-8x7b at full width, the MoE FFN and K4's sliding window --

MOE_LAYERS = 4  # of 32: 1.45 B parameters (5.8 GB in f32) a layer
MOE_PROMPT = 8192  # twice the window: 8 MoE groups of 1,024
MOE_SERVE_PROMPTS = (256, 512, 1024, 2048)  # above a group: multiples of it
MOE_SERVE_NEW = 16
MOE_SERVE_CAPACITY = 8.0  # the reference's consistency test's: no token drops


def moe_config(**kw):
    """mixtral-8x7b at full width (src/repro/configs/mixtral_8x7b.py), its
    first MOE_LAYERS layers."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("mixtral-8x7b").config, n_layers=MOE_LAYERS,
                               remat=False, **kw)


def _moe_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


class _MoERecorder:
    """Wraps ``transformer.moe_apply`` (the name ``_ffn_block`` calls) and
    keeps each call's drop share and top-k experts (recomputed from its
    input and router, as ``moe_apply`` routes).  With ``pin`` (the routes
    of an earlier run, one a call) it also replaces ``moe.top_k`` so that
    each call routes every token to the pinned experts, weighted by this
    run's own router probabilities: two runs then dispatch alike, and
    differ only by their arithmetic."""

    def __init__(self, pin=None):
        from repro_torch.models import moe, transformer

        self.transformer, self.moe_module = transformer, moe
        self.real, self.real_top_k = transformer.moe_apply, moe.top_k
        self.pin, self.drops, self.routes = pin, [], []

    def __enter__(self):
        import torch

        top_k, calls = self.real_top_k, []

        def recorded(p, cfg, x, compute_dtype):
            y, aux = self.real(p, cfg, x, compute_dtype)
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]["w"].float()
            self.routes.append(top_k(torch.softmax(logits, -1), cfg.top_k)[1])
            self.drops.append(aux["moe_drop_frac"])
            return y, aux

        def pinned(probs, k):
            idx = self.pin[len(calls)].reshape(*probs.shape[:-1], k)
            calls.append(1)
            return probs.gather(-1, idx), idx

        self.transformer.moe_apply = recorded
        if self.pin is not None:
            self.moe_module.top_k = pinned
        return self

    def __exit__(self, *exc):
        self.transformer.moe_apply = self.real
        self.moe_module.top_k = self.real_top_k

    def drop_fracs(self):
        return [float(d) for d in self.drops]


# The pinned mixtral prefill against the xla prefill, bf16, 4 layers.  A
# sound pallas prefill reads cache 0.0250 / logits 0.0388 and a model whose
# layer 0 drops its diagonal 0.0764 / 0.0918 (PERF.md); the limits sit
# between, and that model must fail them.
MOE_CACHE_REL_TOL = 0.05
MOE_LOGITS_TOL = 0.065


def phase_moe_prefill(params, tokens, smi: str) -> dict:
    """mixtral-8x7b, MOE_LAYERS layers at full width, one 8,192-token prompt
    in bf16 at the config's own capacity (1.25): ``prefill`` with
    ``attn_impl='pallas'`` (K4's windowed route, window 4,096, once a layer,
    counted) against ``'xla'``, same weights.  Each wall is a run with no
    instrumentation; the routes and drop shares come from a second, untimed
    run (:class:`_MoERecorder`).

    Run free, the two routes send some tokens to other experts: K4 and the
    xla path round p to bf16 at other points, the router reads the bf16
    residual, and a token near a tie between two experts moves; in the
    layers after, its K/V differ by a whole expert's output.  The free
    runs' routing differences, drop shares and logits are printed.

    The checks run on a pallas prefill whose routing is pinned to the xla
    run's.  In it, each layer's K4 output is held to K4's limits (FLASH_TOL,
    FLASH_ROW_TOL) against its plain version and against the xla attention
    on the same q, k, v, and at layer 0 the three K4 controls
    (:func:`flash_controls`) must fail them.  Then the model: layer 0's
    cache bitwise, the cache and logits within MOE_CACHE_REL_TOL and
    MOE_LOGITS_TOL, which a model whose layer 0 drops its diagonal (routing
    pinned alike) must exceed, and the greedy token where the margin
    exceeds the logits limit."""
    import torch

    from repro_torch.kernels.flash_attention.ops import KV_TILE_BF16, flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import transformer

    def run(impl, label):
        cfg = moe_config(attn_impl=impl)
        flash_attention.launches = 0
        (logits, cache, _), wall, _, peak = _peak_run(
            lambda: transformer.prefill(params, cfg, tokens))
        launches = flash_attention.launches
        if launches != (cfg.n_layers if impl == "pallas" else 0):
            raise AssertionError(f"{impl} prefill: {launches} K4 launches, {cfg.n_layers} layers")
        with _MoERecorder() as rec:
            transformer.prefill(params, cfg, tokens)
        log("moe.prefill", impl=impl, run=label, prompt=tokens.shape[1], window=cfg.window,
            wall_ms=wall, k4_launches=launches, peak_above_weights_mb=peak,
            peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
            moe_drop_frac_per_layer=rec.drop_fracs(), greedy=int(logits.argmax()), card=smi)
        return logits, cache, launches, rec

    lp, cp, launches, rec_p = run("pallas", "free")
    lx, cx, _, rec_x = run("xla", "free")
    run("pallas", "free, second")
    run("xla", "free, second")
    routed_apart = [int((a != b).any(-1).sum()) for a, b in zip(rec_p.routes, rec_x.routes)]
    free_rows = torch.cat([_row_rel_errs(cp[key], cx[key]) for key in ("k", "v")])
    log("moe.prefill", free_runs="pallas vs xla, each routing its own tokens",
        tokens_routed_apart_per_layer=routed_apart, of_tokens=tokens.shape[1],
        cache_row_rel_err_p99=torch.quantile(free_rows, 0.99).item(),
        cache_row_rel_err_max=free_rows.max().item(),
        logits_max_abs_err=(lp - lx).abs().max().item(), card=smi)

    real = transformer.gqa_attention
    layers, failures = [], []

    def checked(q, k, v, *, q_positions, kv_positions, window=None, impl="xla", **kw):
        out = real(q, k, v, q_positions=q_positions, kv_positions=kv_positions, window=window,
                   impl=impl, **kw)
        if impl == "pallas":
            got = out.float()
            want = flash_attention_ref(q, k, v, q_positions, kv_positions, window=window).float()
            xla = real(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                       window=window, impl="xla", **kw).float()
            layer = dict(vs_plain=flash_errors(got, want, "bfloat16"),
                         vs_xla=flash_errors(got, xla, "bfloat16"))
            if not layers:
                layer["controls"] = {
                    name: flash_errors(c, want, "bfloat16") for name, c in flash_controls(
                        q, k, v, q_positions, kv_positions, window, want, KV_TILE_BF16).items()}
            log("moe.k4", layer=len(layers), tolerance=f"rtol=atol={FLASH_TOL['bfloat16']}, "
                f"row {FLASH_ROW_TOL['bfloat16']}", **layer, card=smi)
            for name, e in layer.items():
                if name != "controls" and (e["outside"] or e["rows_outside"]):
                    failures.append(f"layer {len(layers)} K4 {name}: {e}")
            for name, e in layer.get("controls", {}).items():
                if not (e["outside"] or e["rows_outside"]):
                    failures.append(f"the {name} control passes K4's limits")
            layers.append(layer)
        return out

    transformer.gqa_attention = checked
    try:
        with _MoERecorder(rec_x.routes):
            lp, cp, _ = transformer.prefill(params, moe_config(attn_impl="pallas"), tokens)
    finally:
        transformer.gqa_attention = real
    if len(layers) != moe_config().n_layers or failures:
        raise AssertionError(f"K4 in the served model: {len(layers)} layers; {failures}")

    with _without_diagonal(), _MoERecorder(rec_x.routes):
        lc, cc, _ = transformer.prefill(params, moe_config(attn_impl="xla"), tokens)

    layer0_equal = all(torch.equal(cp[key][0], cx[key][0]) for key in ("k", "v"))
    cache_err = max(_row_rel_err(cp[key], cx[key]) for key in ("k", "v"))
    ctrl_cache_err = max(_row_rel_err(cc[key], cx[key]) for key in ("k", "v"))
    logits_err = (lp - lx).abs().max().item()
    ctrl_logits_err = (lc - lx).abs().max().item()
    top2 = torch.topk(lx[0], 2).values
    margin = (top2[0] - top2[1]).item()
    same_greedy = int(lp.argmax()) == int(lx.argmax())
    log("moe.prefill", pinned="pallas with the xla run's routing vs xla",
        layer0_cache="bitwise equal" if layer0_equal else "DIFFERS",
        cache_row_rel_err=cache_err, cache_tol=MOE_CACHE_REL_TOL, logits_max_abs_err=logits_err,
        logits_tol=MOE_LOGITS_TOL, no_diagonal_model_cache_row_rel_err=ctrl_cache_err,
        no_diagonal_model_logits_max_abs_err=ctrl_logits_err,
        logits_std=lx.std().item(), greedy_pallas=int(lp.argmax()), greedy_xla=int(lx.argmax()),
        xla_top1_top2_margin=margin,
        greedy="equal" if same_greedy else
        ("DIFFERS" if margin > MOE_LOGITS_TOL else "differs at a near tie (margin <= logits_tol)"),
        card=smi)
    if not layer0_equal:
        raise AssertionError("layer 0's K/V cache differs: it is computed before any attention")
    if cache_err > MOE_CACHE_REL_TOL or logits_err > MOE_LOGITS_TOL:
        raise AssertionError(f"pallas vs xla prefill: cache {cache_err}, logits {logits_err}")
    if ctrl_cache_err <= MOE_CACHE_REL_TOL or ctrl_logits_err <= MOE_LOGITS_TOL:
        raise AssertionError(f"the no-diagonal model passes a check (cache {ctrl_cache_err}, "
                             f"logits {ctrl_logits_err})")
    if not same_greedy and margin > MOE_LOGITS_TOL:
        raise AssertionError(f"the greedy token differs between the pallas and xla prefill "
                             f"at a top-1/top-2 margin of {margin}")
    return {"launches": launches, "moe_drop_frac": rec_p.drop_fracs()}


def _forward_chain(params, cfg, prompt, answer):
    """The argmax chain of one full ``forward`` over the prompt and the
    answer's first tokens (teacher-forced: the argmax at each new position
    must be the next token), and its top-1/top-2 margins.  The sequence is
    padded with token 0 to a multiple of the MoE group, as the reference's
    group assertion needs: attention is causal and the capacity drops
    nothing, so no position read depends on the padding."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import forward

    seq = np.concatenate([prompt, np.asarray(answer[:-1], np.int32)])
    gs = cfg.moe.group_size
    n = len(seq) if len(seq) <= gs else -(-len(seq) // gs) * gs
    padded = np.zeros(n, np.int64)
    padded[:len(seq)] = seq
    logits, _ = forward(params, cfg, torch.as_tensor(padded, device=DEV)[None])
    new = logits[0, len(prompt) - 1:len(seq)]
    top2 = torch.topk(new, 2, dim=-1).values
    return new.argmax(-1).tolist(), (top2[:, 0] - top2[:, 1]).min().item(), n


def phase_moe_serve(params, smi: str) -> dict:
    """``ServeEngine`` over mixtral at full width, ``attn_impl='xla'``,
    float32 compute, capacity 8.0: 4 slots, prompts of 256-2,048 tokens, 16
    new tokens each.  Every answer equals the argmax chain of one full
    forward (:func:`_forward_chain`).  Then each prompt's drop share at the
    config's own capacity (1.25), from a float32 forward."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import forward
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = _moe_capacity(moe_config(attn_impl="xla", compute_dtype=torch.float32),
                        MOE_SERVE_CAPACITY)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in MOE_SERVE_PROMPTS]
    eng = ServeEngine(params, cfg, n_slots=len(prompts), device=DEV)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=MOE_SERVE_NEW))
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
    log("moe.serve", requests=len(done), prompt_lens=list(MOE_SERVE_PROMPTS),
        capacity_factor=MOE_SERVE_CAPACITY, generated_tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_steps=len(decode_ms),
        median_decode_step_ms=float(np.median(decode_ms)),
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20, card=smi)
    if len(done) != len(prompts) or any(len(r.tokens) != MOE_SERVE_NEW for r in done):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests answered")
    for req in sorted(done, key=lambda r: r.rid):
        chain, margin, n = _forward_chain(params, cfg, req.prompt, req.tokens)
        log("moe.serve", rid=req.rid, prompt=len(req.prompt), forward_len=n,
            engine_tokens=req.tokens, forward_argmax_chain=chain, least_top1_top2_margin=margin,
            equal=chain == req.tokens, card=smi)
        if chain != req.tokens:
            raise AssertionError(f"request {req.rid}: engine {req.tokens} != forward {chain}")
    own = _moe_capacity(cfg, moe_config().moe.capacity_factor)
    for p in prompts:
        with _MoERecorder() as rec:
            forward(params, own, torch.as_tensor(p, device=DEV)[None])
        log("moe.serve", prompt=len(p), capacity_factor=own.moe.capacity_factor,
            moe_drop_frac_per_layer=rec.drop_fracs(), card=smi)
    return {"wall_s": wall}


def phase_moe_golden(smi: str) -> None:
    """The REDUCED mixtral-8x7b and llama4 on the card (float32 compute)
    meet the JAX golden fixture: the forward's digest, moe_loss, each
    layer's drop share at the config's capacity, prefill logits through K4,
    the engine's greedy tokens and their margins."""
    import torch_port_golden as golden

    from repro_torch.kernels.flash_attention.ops import flash_attention

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["lm_moe"]["answers"]
    for arch in golden.LM_MOE_ARCHS:
        before = flash_attention.launches
        got = golden.port_lm_moe_entry(arch, DEV)
        bad = golden.lm_moe_mismatch(got, fixture[arch])
        if bad or flash_attention.launches == before:
            raise AssertionError(f"moe golden {arch}: {bad or 'K4 never launched'}")
        log("golden", lm_moe_arch=arch, equal=f"JAX golden (tokens, drop shares; floats "
            f"rtol=atol={golden.LM_LOGITS_TOL})", tokens=got["tokens"],
            moe_drop_frac=got["moe_drop_frac"], card=smi)


# -- Path 11: training, llama3.2-3b at full width, and K4's trainable route --

TRAIN_SEQ = 4096  # train_4k's sequence length; its global batch cut from 256 to 1
TRAIN_STEPS = 3
TRAIN_ATTN = (1, TRAIN_SEQ, 24, 8, 128)  # B, S, Hq, Hkv, D: llama's attention in a step
TRAIN_CHUNKS = (512, 1024)  # flash_attention_trainable's default backward chunks
# Step 1 under 'auto' (the chunked path) against the same step under 'xla'
# (dense), bf16 compute: the two paths round p to bf16 at other points, so
# the loss, the grad norm and the gradients drift by bf16 roundings; these
# limits sit between that drift and a control whose layer 0 drops the
# diagonal from its mask (PERF.md has the readings on both sides).
TRAIN_LOSS_TOL = 2e-3  # |loss_auto - loss_xla|
TRAIN_GNORM_TOL = 1e-3  # |gnorm_auto - gnorm_xla| / gnorm_xla
TRAIN_GRAD_TOL = 5e-2  # ||G_auto - G_xla|| / ||G_xla|| over every leaf
# The trainable route's f32 gradients against dense autodiff, O(1)
# cotangents: the reference test's limits (test_flash_trainable_grads_match_dense).
TRAINABLE_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
# K4's log-sum-exp against the plain one (f32 scores summed in another
# order, then exp2/log2 in base 2): absolute, on values of about 5-10.
LSE_TOL = 1e-4
TRAIN_CLI_STEPS, TRAIN_CLI_EVERY = 20, 10


def train_config(**kw):
    """llama3.2-3b at full width as ``launch/cells.py`` trains it: remat on,
    ``attn_impl='auto'`` (the chunked path at 4,096 tokens), bf16 compute,
    f32 parameters."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("llama3.2-3b").config,
                               **{"remat": True, "attn_impl": "auto", **kw})


def _tree_dist(a, b) -> float:
    """||a - b|| / ||b|| over every leaf of two gradient trees (chunked: no
    full-size temporary)."""
    import torch

    from repro_torch import tree
    from repro_torch.optim.adamw import CHUNK

    num = den = 0.0
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        xf, yf = x.reshape(-1), y.reshape(-1)
        for s in range(0, xf.numel(), CHUNK):
            num += (xf[s:s + CHUNK] - yf[s:s + CHUNK]).double().square().sum().item()
            den += yf[s:s + CHUNK].double().square().sum().item()
    return (num / max(den, 1e-300)) ** 0.5


def train_batches():
    """Path 11's batches: ``lm_token_stream(vocab, 1, 4096, seed=0)``, the
    steps' and two more for the profile."""
    from repro_torch.data.pipeline import lm_token_stream

    stream = lm_token_stream(train_config().vocab, batch=1, seq=TRAIN_SEQ, seed=0, device=DEV)
    return [next(stream) for _ in range(TRAIN_STEPS + 2)]


def phase_train_step1(params, batches, smi: str) -> float:
    """llama3.2-3b, 28 layers at full width, one card: step 1's loss, grad
    norm and gradients (no update) under 'auto' against 'xla', within the
    TRAIN_* limits, and the layer-0 no-diagonal control outside each of
    them.  Returns the 'auto' loss."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.optim import global_norm
    from repro_torch.train.step import loss_and_grads, make_loss_fn

    spec = get_arch("llama3.2-3b")

    def grads(impl, control=False):
        fn = make_loss_fn(spec, "train", cfg=train_config(attn_impl=impl))
        with _without_diagonal() if control else contextlib.nullcontext():
            (loss, metrics, g), wall, _, peak = _peak_run(
                lambda: loss_and_grads(fn, params, batches[0]))
        return loss.item(), global_norm(g).item(), g, wall, peak

    lx, nx, gx, wall_x, peak_x = grads("xla")
    la, na, ga, wall_a, peak_a = grads("auto")
    dist = _tree_dist(ga, gx)
    del ga
    lc, nc, gc, _, _ = grads("auto", control=True)
    ctrl_dist = _tree_dist(gc, gx)
    del gc, gx
    torch.cuda.empty_cache()
    checks = dict(loss_abs_err=abs(la - lx), grad_norm_rel_err=abs(na - nx) / nx,
                  grad_rel_l2=dist)
    ctrl = dict(loss_abs_err=abs(lc - lx), grad_norm_rel_err=abs(nc - nx) / nx,
                grad_rel_l2=ctrl_dist)
    limits = dict(loss_abs_err=TRAIN_LOSS_TOL, grad_norm_rel_err=TRAIN_GNORM_TOL,
                  grad_rel_l2=TRAIN_GRAD_TOL)
    log("train.step1", loss_auto=la, loss_xla=lx, grad_norm_auto=na, grad_norm_xla=nx,
        **checks, limits=limits, control_layer0_no_diagonal=ctrl, wall_ms_auto=wall_a,
        wall_ms_xla=wall_x, peak_above_weights_mb_auto=peak_a,
        peak_above_weights_mb_xla=peak_x, card=smi)
    over = [k for k, v in checks.items() if not v <= limits[k]]
    if over:
        raise AssertionError(f"step 1 'auto' vs 'xla' past its limits: {over} ({checks})")
    passed = [k for k, v in ctrl.items() if v <= limits[k]]
    if passed:
        raise AssertionError(f"the no-diagonal control passes {passed} ({ctrl})")
    return la


def phase_train_steps(params, batches, step1_loss, smi: str) -> dict:
    """``make_train_step(make_loss_fn(spec, 'train'), AdamWConfig())`` for
    TRAIN_STEPS steps (fp32 moments, the parameters and moments updated in
    place: ``params`` are trained), every loss and grad norm finite, the
    parameters moved, the peak under 80 GB; then one more step profiled."""
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import attention
    from repro_torch.optim import AdamWConfig, global_norm, init_state
    from repro_torch.train import step as train_step
    from repro_torch.train.step import make_loss_fn, make_train_step

    spec = get_arch("llama3.2-3b")
    cfg = train_config()
    opt_cfg = AdamWConfig()
    opt = init_state(params, opt_cfg)
    step = make_train_step(make_loss_fn(spec, "train", cfg=cfg), opt_cfg)
    probe = params["layers"]["mlp"]["w_down"]["w"][-1, :4].clone()
    rows, walls = [], []
    for i in range(TRAIN_STEPS):
        _zero_counts()
        (params, opt, metrics), wall, _, peak = _peak_run(lambda: step(params, opt, batches[i]))
        counts = _counts()
        row = dict(step=i + 1, loss=metrics["loss"].item(),
                   total_loss=metrics["total_loss"].item(),
                   grad_norm=metrics["grad_norm"].item(), accuracy=metrics["accuracy"].item(),
                   wall_ms=wall, peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
                   peak_above_state_mb=peak, kernels=counts)
        log("train.step", **row, card=smi)
        rows.append(row)
        walls.append(wall)
        if not all(math.isfinite(row[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"train step {i + 1}: not finite {row}")
    moved = not torch.equal(probe, params["layers"]["mlp"]["w_down"]["w"][-1, :4])
    pnorm = global_norm(params).item()
    median = statistics.median(walls[1:])
    peak_mb = max(r["peak_device_mb"] for r in rows)
    log("train.summary", arch="llama3.2-3b", layers=cfg.n_layers, seq=TRAIN_SEQ, batch=1,
        params=cfg.param_count(), moments="fp32", remat=cfg.remat, attn_impl=cfg.attn_impl,
        step1_loss_equals_grads_run=rows[0]["loss"] == step1_loss, params_moved=moved,
        param_norm=pnorm, median_step_ms_2_3=median, tokens_per_s=TRAIN_SEQ / median * 1e3,
        peak_device_mb=peak_mb, card=smi)
    if not moved or not math.isfinite(pnorm):
        raise AssertionError(f"the parameters did not move or are not finite ({pnorm})")
    if peak_mb >= 80 * 1024:
        raise AssertionError(f"peak {peak_mb} MB: over 80 GB")
    spans = [(attention._ChunkedFlash, "forward", "chunked_attention"),
             (attention._ChunkedFlash, "backward", "chunked_attention"),
             (train_step, "apply_updates", "adamw")]
    extra = iter(batches[TRAIN_STEPS:])
    phase_profile("llama_train_step", lambda: step(params, opt, next(extra)), span=spans,
                  kinds=TRAIN_KERNEL_KINDS, card=smi)
    del opt
    return {"launches": sum(r["kernels"]["k4"] for r in rows),
            "bwd_launches": sum(r["kernels"]["k4_bwd"] for r in rows), "steps": rows}


# Kernel-name classes of the training profile (cuBLAS/cuBLASLt GEMMs, and
# the dtype copies: weight casts to bf16 and operand upcasts to f32).
TRAIN_KERNEL_KINDS = {"gemm": ("gemm", "xmma", "nvjet", "cutlass", "Kernel2"),
                      "copy_or_cast": ("copy",)}


def train_attention_bound_ms(q, k, pairs: int) -> tuple:
    """Least time for one attention forward plus backward: 14·D FLOPs per
    allowed pair and query head (the forward's 4·D, then the backward's
    recomputed scores, dV, dP, dQ and dK, 2·D each) at the dtype's peak;
    bytes: q, k, v and dout read, the output and dq, dk, dv written once.
    (ms, 'operations' or 'bytes')."""
    b, sq, hq, d = q.shape
    flops = 14.0 * d * hq * b * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() * 2
    ops_ms, bytes_ms = ops_bound_ms(flops, q.dtype), nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def k4b_launch_ms(fn, n: int):
    """{kernel: device ms a launch} of ``fn``'s kernels over ``n`` calls
    under ``torch.profiler`` (K4b: the plan, the delta pre-pass, the dK/dV
    and dQ kernels, each launched once a call), the mean over the launches
    the profiler recorded; "not measured" if it recorded none.  Run in a
    fresh process (``k4b_split``): late in this script's process the
    profiler kept only some of these short windows' device events."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us, count = {}, {}
    for ev in prof.key_averages():
        m = re.search(r"(flash_\w+)(<[^>(]*>)?", ev.key)
        if ev.device_type != cuda or m is None:
            continue
        name = m.group(1) + (m.group(2) or "")
        us[name] = us.get(name, 0) + (getattr(ev, "self_device_time_total", None)
                                      or getattr(ev, "self_cuda_time_total", 0))
        count[name] = count.get(name, 0) + ev.count
    split = {name: us[name] / count[name] / 1e3 for name in us if count[name]}
    return split or "not measured (the profiler recorded no device events)"


def k4b_split() -> dict:
    """{dtype: ``k4b_launch_ms``} of K4b at TRAIN_ATTN on path 11's inputs,
    bf16 and f32, 10 calls each (a child process's work)."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    b, s, hq, hkv, d = TRAIN_ATTN
    split = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v, pos = _flash_inputs(b, s, hq, hkv, d, dtype, seed=11)
        g = torch.Generator(device=DEV).manual_seed(12)
        dout = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
        out, lse = ops._kernel_forward(q, k, v, pos, pos, None, with_lse=True)
        split[dtype] = k4b_launch_ms(lambda: ops.flash_attention_bwd(
            q, k, v, out, dout, lse, q_positions=pos, kv_positions=pos), n=10)
    return split


def k4b_split_child() -> dict:
    """``k4b_split`` in a fresh process (its libraries from the build cache);
    on a failure each dtype reads "not measured" with the child's error."""
    import os

    code = "import json, chip_smoke; print(json.dumps(chip_smoke.k4b_split()))"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        why = f"not measured (the child failed: {proc.stderr.strip()[-300:]})"
        return {"bfloat16": why, "float32": why}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def k4b_bound_ms(q, k, pairs: int) -> tuple:
    """Least time for K4b alone: 10·D FLOPs per allowed pair and query head
    (s, dp, dv, dq and dk, 2·D each) at the dtype's peak; bytes: q, k, v,
    out, dout and the log-sum-exp read, dq, dk, dv written once.  (ms,
    'operations' or 'bytes')."""
    b, sq, hq, d = q.shape
    flops = 10.0 * d * hq * b * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * b * hq * sq
    ops_ms, bytes_ms = ops_bound_ms(flops, q.dtype), nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# K4b against its plain version, the chunked vjp at the same chunks, on
# (dq, dk, dv) together, two limits.  Elementwise, |got - want| <= elem *
# (scale + |want|), with scale the rms of the plain version's three
# gradients: a gradient that is rounding noise in both (dq and dk of a
# query with one allowed key, which are 0 in exact arithmetic) is held to
# the others' scale, a large one relatively.  And the relative L2 error
# over the three.  f32: summation order.  bf16: K4b rounds P and dS to
# bf16 for wgmma where the chunked vjp keeps them in f32, and both take
# delta from a bf16 output and round their own; at the main shape the
# chunked vjp itself lies up to 0.06 of (scale + |truth|) off the f64
# dense gradient in the first rows and keys (`vs_f64_truth` in
# [train.k4]), so the elementwise limit is 2^-3, with the L2 limit at
# 2^-7.  Three controls must fail them (PERF.md has the readings on both
# sides).
TRAINABLE_BWD_TOL = {"float32": dict(elem=2.0 ** -12, rel_l2=2.0 ** -14),
                     "bfloat16": dict(elem=2.0 ** -3, rel_l2=2.0 ** -7)}


def grad_errors(got, want, dtype: str) -> dict:
    """Readings of (dq, dk, dv) ``got`` against ``want`` at
    TRAINABLE_BWD_TOL: elements outside the elementwise limit, the relative
    L2 error over the three and whether it is past its limit, the largest
    |got - want| / (scale + |want|) and the largest absolute error."""
    tol = TRAINABLE_BWD_TOL[dtype]
    want = [w.double() for w in want]
    scale = (sum(w.square().sum() for w in want) / sum(w.numel() for w in want)).sqrt()
    outside, num, den, worst, max_abs = 0, 0.0, 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        err = (g.double() - w).abs()
        outside += int((err > tol["elem"] * (scale + w.abs())).sum())
        worst = max(worst, (err / (scale + w.abs())).max().item())
        max_abs = max(max_abs, err.max().item())
        num += err.square().sum().item()
        den += w.square().sum().item()
    rel = (num / max(den, 1e-300)) ** 0.5
    return dict(outside=outside, rel_l2=rel, rel_l2_outside=rel > tol["rel_l2"],
                max_rel_err=worst, max_abs_err=max_abs)


def dense_grads(q, k, v, dout, q_positions, kv_positions, window, compute, *,
                drop_delta: bool = False):
    """(dq, dk, dv) of dense attention in the ``compute`` dtype, delta =
    rowsum(P * dP) (= rowsum(dout * out) in exact arithmetic): float64 is
    the exact gradient of the bf16 or f32 inputs; ``drop_delta`` leaves
    delta out of dS = P * (dP - delta), a fault a wrong backward could
    have."""
    import torch

    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    qf = q.to(compute).reshape(b, sq, hkv, g, d)
    kf, vf = k.to(compute), v.to(compute)
    do = dout.to(compute).reshape(b, sq, hkv, g, d)
    qp, kp = q_positions.long(), kv_positions.long()
    ok = kp[None, :] <= qp[:, None]
    if window is not None:
        ok &= kp[None, :] > qp[:, None] - window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf).mul_(scale).masked_fill_(~ok, -torch.inf)
    p = torch.softmax(s, dim=-1).nan_to_num_(0.0)
    del s
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    ds = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    if not drop_delta:
        ds.sub_((p * ds).sum(dim=-1, keepdim=True))
    ds.mul_(p).mul_(scale)
    del p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq, dk, dv


def trainable_controls(q, k, v, dout, pos, window, want, chunks) -> dict:
    """(dq, dk, dv) of three faults a wrong K4b could have: delta dropped;
    the diagonal excluded from every row's mask (the chunked vjp with each
    key one position later); dK and dV from the first query head of each
    group only (the chunked vjp with the other heads' dout zeroed; dq the
    plain version's)."""
    import torch

    from repro_torch.models.attention import chunked_vjp

    qc, kc = chunks
    g = q.shape[2] // k.shape[2]
    first = dout.clone()
    first.view(*dout.shape[:2], k.shape[2], g, dout.shape[3])[:, :, :, 1:] = 0
    _, dk1, dv1 = chunked_vjp(q, k, v, first, q_positions=pos, kv_positions=pos, window=window,
                              q_chunk=qc, kv_chunk=kc)
    return {
        "no_delta": tuple(t.to(q.dtype) for t in dense_grads(
            q, k, v, dout, pos, pos, window, torch.float32, drop_delta=True)),
        "no_diagonal": chunked_vjp(q, k, v, dout, q_positions=pos, kv_positions=pos + 1,
                                   window=window, q_chunk=qc, kv_chunk=kc),
        "one_head_per_group": (want[0], dk1, dv1),
    }


def phase_train_attention(smi: str) -> dict:
    """``flash_attention_trainable`` at llama's attention shape in a train
    step (B=1, S=4,096, 24/8 heads, D=128), bf16 and f32: K4 once and K4b
    once; the forward within K4's limits against the plain version; K4's
    log-sum-exp against the plain one; dq, dk, dv within TRAINABLE_BWD_TOL
    of K4b's plain version (the vjp of ``_chunked_gqa`` on the same grouped
    q, k, v at the same chunks) and three controls outside them; f32
    gradients within TRAINABLE_GRAD_TOL of dense autodiff; the pallas impl
    refusing grad-requiring inputs; then K4's forward, K4b alone and its
    plain version, the chunked backward, the chunked and trainable
    forward+backward and SDPA's backward and forward+backward timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_trainable,
    )
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_ref, flash_attention_ref,
    )
    from repro_torch.models.attention import _chunked_gqa, chunked_vjp, gqa_attention

    b, s, hq, hkv, d = TRAIN_ATTN
    qc, kc = TRAIN_CHUNKS
    out_rec, launches, bwd_launches, bwd_errs = {}, 0, 0, {}
    split = k4b_split_child()  # K4b's device time by launch
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        q, k, v, pos = _flash_inputs(b, s, hq, hkv, d, dtype, seed=11)
        g = torch.Generator(device=DEV).manual_seed(12)
        dout = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)  # O(1) cotangents

        def leaves():
            return [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def trainable(qq, kk, vv):
            return flash_attention_trainable(qq, kk, vv, q_positions=pos, kv_positions=pos,
                                             bwd_q_chunk=qc, bwd_kv_chunk=kc)

        def chunked(qq, kk, vv):
            return _chunked_gqa(qq, kk, vv, q_positions=pos, kv_positions=pos, kv_valid=None,
                                window=None, q_chunk=qc, kv_chunk=kc)

        def plain_bwd():
            return chunked_vjp(q, k, v, dout, q_positions=pos, kv_positions=pos, window=None,
                               q_chunk=qc, kv_chunk=kc)

        # The driven run: K4 once in the forward, K4b once in the backward.
        qq, kk, vv = leaves()
        _zero_counts()
        out = trainable(qq, kk, vv)
        got = torch.autograd.grad(out, (qq, kk, vv), dout)
        torch.cuda.synchronize()
        counts = _counts()
        if counts != {"k1": 0, "k2": 0, "k3": 0, "k4": 1, "k4_bwd": 1}:
            raise AssertionError(f"trainable route {dtype}: launches {counts}")
        launches += counts["k4"]
        bwd_launches += counts["k4_bwd"]
        want = flash_attention_ref(q, k, v, pos, pos).float()
        fwd = flash_errors(out.detach().float(), want, dtype)
        del want
        # K4's log-sum-exp (the forward's second output) against the plain one.
        out_l, lse = fa_ops._kernel_forward(q, k, v, pos, pos, None, with_lse=True)
        lse_ref = flash_attention_lse_ref(q, k, pos, pos)
        lse_err = (lse - lse_ref).abs().max().item()
        out_bitwise = torch.equal(out_l, flash_attention(q, k, v, q_positions=pos,
                                                         kv_positions=pos))
        del lse_ref
        # K4b run to run: two calls on the same inputs, and the driven run's.
        reruns = [flash_attention_bwd(q, k, v, out_l, dout, lse, q_positions=pos,
                                      kv_positions=pos, q_chunk=qc, kv_chunk=kc)
                  for _ in range(2)]
        rerun_bitwise = all(torch.equal(a, b_) and torch.equal(a, c)
                            for a, b_, c in zip(reruns[0], reruns[1], got))
        del reruns
        ref = plain_bwd()
        bwd = grad_errors(got, ref, dtype)
        controls = {name: grad_errors(c, ref, dtype) for name, c in
                    trainable_controls(q, k, v, dout, pos, None, ref, TRAIN_CHUNKS).items()}
        bwd_errs[dtype] = bwd["max_abs_err"]
        # Both against the exact gradient of the same inputs (a reading).
        truth = dense_grads(q, k, v, dout, pos, pos, None, torch.float64)
        vs_truth = {name: {key: e[key] for key in ("rel_l2", "max_rel_err")}
                    for name, e in (("k4b", grad_errors(got, truth, dtype)),
                                    ("chunked_vjp", grad_errors(ref, truth, dtype)))}
        del ref, truth
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        dense = {}
        if dtype == "float32":
            qq3, kk3, vv3 = leaves()
            o3 = gqa_attention(qq3, kk3, vv3, q_positions=pos, kv_positions=pos, impl="xla")
            g3 = torch.autograd.grad(o3, (qq3, kk3, vv3), dout)
            del o3
            tol = TRAINABLE_GRAD_TOL
            for name, a, c in zip(("dq", "dk", "dv"), got, g3):
                err = (a - c).abs()
                dense[name] = dict(max_abs_err=err.max().item(),
                                   outside=int((err > tol["atol"] + tol["rtol"] * c.abs()).sum()))
            del g3
        qq4, kk4, vv4 = leaves()
        try:
            gqa_attention(qq4, kk4, vv4, q_positions=pos, kv_positions=pos, impl="pallas")
            refused = False
        except RuntimeError as e:
            refused = "flash_attention_trainable" in str(e)
        log("train.k4", dtype=dtype, shape=f"B{b}_S{s}_H{hq}/{hkv}_D{d}", launches=counts,
            forward=fwd, forward_tol=f"rtol=atol={FLASH_TOL[dtype]}, row {FLASH_ROW_TOL[dtype]}",
            lse_max_abs_err=lse_err, no_grad_output_bitwise_with_lse=out_bitwise,
            k4b_rerun_bitwise=rerun_bitwise,
            grads_vs_chunked_vjp=bwd, grads_tol=TRAINABLE_BWD_TOL[dtype], controls=controls,
            vs_f64_truth=vs_truth,
            chunks=TRAIN_CHUNKS, vs_dense_autodiff=dense or "bf16: not held (f32 only)",
            dense_tol=TRAINABLE_GRAD_TOL, pallas_under_grad_raises=refused, card=smi)
        bad = [f"forward {fwd}"] if fwd["outside"] or fwd["rows_outside"] else []
        bad += [] if lse_err <= LSE_TOL else [f"lse off the plain one by {lse_err}"]
        bad += [] if out_bitwise else ["the output with lse differs from the no-grad one"]
        bad += [] if rerun_bitwise else ["two K4b calls on the same inputs differ"]
        bad += [f"grads vs chunked vjp {bwd}"] if bwd["outside"] or bwd["rel_l2_outside"] else []
        bad += [f"the {n} control passes" for n, c in controls.items()
                if not (c["outside"] or c["rel_l2_outside"])]
        bad += [f"{n} vs dense {e}" for n, e in dense.items() if e["outside"]]
        bad += [] if refused else ["gqa_attention(impl='pallas') did not refuse"]
        if bad:
            raise AssertionError(f"trainable route {dtype}: " + "; ".join(bad))
        del out, got

        # Times (CUDA events, medians).
        t0 = time.perf_counter()
        qq, kk, vv = leaves()
        n = 10
        k4_ms = time_ms(lambda: flash_attention(q, k, v, q_positions=pos, kv_positions=pos), n=n)
        k4b_ms = time_ms(lambda: flash_attention_bwd(q, k, v, out_l, dout, lse, q_positions=pos,
                                                     kv_positions=pos), n=n)
        k4b_plain_ms = time_ms(plain_bwd, n=n)
        kept = chunked(qq, kk, vv)
        bwd_ms = time_ms(lambda: torch.autograd.grad(kept, (qq, kk, vv), dout,
                                                     retain_graph=True), n=n)
        del kept
        chunked_ms = time_ms(lambda: torch.autograd.grad(chunked(qq, kk, vv), (qq, kk, vv),
                                                         dout), n=n)
        trainable_ms = time_ms(lambda: torch.autograd.grad(trainable(qq, kk, vv),
                                                           (qq, kk, vv), dout), n=n)
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dt = dout.transpose(1, 2).contiguous()
        sdpa_ms = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            (qt, kt, vt), dt), n=n)
        kept = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(kept, (qt, kt, vt), dt,
                                                          retain_graph=True), n=n)
        del kept
        with torch.no_grad():
            sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), n=n)
        pairs = flash_pairs(pos, pos, None)
        fwd_bound, fwd_by = flash_bound_ms(q, k, pairs)
        fb_bound, fb_by = train_attention_bound_ms(q, k, pairs)
        k4b_bound, k4b_by = k4b_bound_ms(q, k, pairs)
        flops = d * q.shape[2] * pairs  # D FLOPs per allowed pair and query head
        f32_bounds = ({} if dtype == "bfloat16" else dict(
            fwd_bounds_f32=f32_bounds_ms(4 * flops), fwd_bwd_bounds_f32=f32_bounds_ms(14 * flops),
            k4b_bounds_f32=f32_bounds_ms(10 * flops)))
        rec = dict(k4_fwd_ms=k4_ms, k4b_ms=k4b_ms, k4b_device_ms_by_launch=split[dtype],
                   k4b_plain_ms_chunked_vjp=k4b_plain_ms,
                   chunked_bwd_ms=bwd_ms, chunked_fwd_bwd_ms=chunked_ms,
                   trainable_fwd_bwd_ms=trainable_ms, library_fwd_bwd_ms_sdpa=sdpa_ms,
                   library_bwd_ms_sdpa=sdpa_bwd_ms, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
                   fwd_bwd_bound_ms=fb_bound, fwd_bwd_bound_by=fb_by, k4b_bound_ms=k4b_bound,
                   k4b_bound_by=k4b_by, k4b_roofline_share=k4b_bound / k4b_ms,
                   k4b_vs_sdpa_bwd=k4b_ms / sdpa_bwd_ms, library_fwd_ms_sdpa=sdpa_fwd_ms,
                   **f32_bounds)
        log("train.k4.time", dtype=dtype, **rec, check_s=check_s,
            time_s=time.perf_counter() - t0, card=smi)
        out_rec[dtype] = rec
        del q, k, v, dout, qq, kk, vv, qt, kt, vt, dt, out_l, lse
        torch.cuda.empty_cache()
    main = out_rec["bfloat16"]
    k4b = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/ops.py:92",
        "launches": bwd_launches,
        "max_abs_err": bwd_errs["bfloat16"],
        "ms": main["k4b_ms"],
        "plain_ms": main["k4b_plain_ms_chunked_vjp"],
        "bound_ms": main["k4b_bound_ms"],
        "bound_by": main["k4b_bound_by"],
        "library_ms": main["library_bwd_ms_sdpa"],
        "f32": dict(ms=out_rec["float32"]["k4b_ms"], max_abs_err=bwd_errs["float32"],
                    plain_ms=out_rec["float32"]["k4b_plain_ms_chunked_vjp"],
                    bound_ms=out_rec["float32"]["k4b_bound_ms"],
                    library_ms=out_rec["float32"]["library_bwd_ms_sdpa"]),
    }
    return {"launches": launches, "bwd_launches": bwd_launches, "trainable": out_rec,
            "k4b": k4b}


def phase_train_golden(smi: str) -> None:
    """The REDUCED configs of the five LM archs on the card (float32
    compute) meet the JAX golden fixture's training entries: ``lm_loss`` and
    its metrics, the grad norm, each leaf's sums after one AdamW step."""
    import torch_port_golden as golden

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["lm_train"]["answers"]
    for arch in golden.LM_TRAIN_ARCHS:
        got = golden.port_lm_train_entry(arch, DEV)
        bad = golden.lm_train_mismatch(got, fixture[arch])
        if bad:
            raise AssertionError(f"lm_train golden {arch}: {bad}")
        log("golden", lm_train_arch=arch, equal=f"JAX golden (loss, metrics, grad norm "
            f"rtol=atol={golden.LM_LOGITS_TOL}; leaf sums + {golden.LM_TRAIN_SUM_ATOL})",
            total=got["total"], grad_norm=got["grad_norm"], card=smi)


# The children's prologue: deterministic kernels (the embedding's backward
# accumulates with atomics on CUDA otherwise), set before CUDA starts.
TRAIN_CLI_PROLOGUE = (
    "import os, sys; os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'; import torch; "
    "torch.use_deterministic_algorithms(True); "
    "from repro_torch.launch.train import main; main(sys.argv[1:])")


def phase_train_cli(smi: str) -> None:
    """``python -m repro_torch.launch.train --arch llama3.2-3b`` (REDUCED) in
    child processes: 20 steps with a checkpoint every 10; then 10 steps in
    one child and a ``--resume`` to 20 in another.  The two step_20
    checkpoints must be equal bitwise (every array and the manifest)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    root = tempfile.mkdtemp(prefix="train_cli_")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def child(ckpt, steps, resume=False):
        argv = [sys.executable, "-c", TRAIN_CLI_PROLOGUE, "--arch", "llama3.2-3b",
                "--steps", str(steps), "--ckpt-every", str(TRAIN_CLI_EVERY),
                "--ckpt-dir", os.path.join(root, ckpt), "--device", DEV]
        return subprocess.Popen(argv + (["--resume"] if resume else []), env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(proc, what):
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"train CLI {what}: rc {proc.returncode}\n{err[-3000:]}")
        return out.strip().splitlines()

    try:
        t0 = time.perf_counter()
        straight, first = child("straight", TRAIN_CLI_STEPS), child("split", TRAIN_CLI_EVERY)
        out_straight = finish(straight, "straight")
        out_first = finish(first, "first half")
        out_second = finish(child("split", TRAIN_CLI_STEPS, resume=True), "resume")
        wall = time.perf_counter() - t0
        if f"resumed from step {TRAIN_CLI_EVERY}" not in out_second:
            raise AssertionError(f"the second child did not resume: {out_second}")
        final = f"step_{TRAIN_CLI_STEPS}"
        a_dir, b_dir = (os.path.join(root, c, final) for c in ("straight", "split"))
        with np.load(os.path.join(a_dir, "arrays.npz")) as a, \
                np.load(os.path.join(b_dir, "arrays.npz")) as b:
            keys = sorted(a.files)
            differ = [key for key in keys if key not in b.files
                      or a[key].dtype != b[key].dtype or not np.array_equal(a[key], b[key])]
            differ += sorted(set(b.files) - set(keys))
            n_arrays = len(keys)
        with open(os.path.join(a_dir, "manifest.json")) as f:
            man_a = json.load(f)
        with open(os.path.join(b_dir, "manifest.json")) as f:
            man_b = json.load(f)
        log("train.cli", arch="llama3.2-3b (REDUCED)", steps=TRAIN_CLI_STEPS,
            ckpt_every=TRAIN_CLI_EVERY, straight=json.loads(out_straight[-1]),
            first_half=json.loads(out_first[-1]), resumed=json.loads(out_second[-1]),
            arrays=n_arrays, arrays_differing=differ, manifests_equal=man_a == man_b,
            wall_s=wall, card=smi)
        if differ or man_a != man_b:
            raise AssertionError(f"kill-and-resume is not bitwise: {differ}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- Path 9: the port's benchmarks and examples (benchmarks/torch_port/,
# examples/torch_port/), through K1, K2 and K3 -------------------------------

def _bench_args(mod, *argv) -> object:
    """``mod``'s arguments (its defaults, the reference's) on ``DEV``, its
    record under experiments/bench/torch/ (the module's own default path)."""
    return mod.parse_args(list(argv) + ["--device", DEV])


def _zero_counts() -> None:
    for k in _kernel_counters():
        k.launches = 0


def _counts() -> dict:
    k1, k2, k3, k4, k4_bwd = _kernel_counters()
    return {"k1": k1.launches, "k2": k2.launches, "k3": k3.launches, "k4": k4.launches,
            "k4_bwd": k4_bwd.launches}


def _bench_record(phase: str, args, report: dict, launches: dict, seconds: float) -> None:
    """Writes the record where ``main`` would and prints it on one line."""
    from benchmarks.torch_port import common

    common.write_json(report, args.out)
    print(f"[{phase}] " + json.dumps({"seconds": round(seconds, 3), "launches": launches,
                                      "record": report}), flush=True)


def _drive(phase: str, fn):
    """``fn()`` with every kernel's count set to 0 just before and read just
    after: (result, launches, seconds)."""
    import torch

    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _counts(), time.perf_counter() - t0


def phase_bench_engine(flickr) -> dict:
    """``bench.engine`` at flickr_sm: exact, sketch (t=5, b=2^15) and pallas
    through the engine; K1 launches == the pallas run's passes, K2 == the
    sketch run's, pallas == exact."""
    from benchmarks.torch_port import bench_engine as mod

    args = _bench_args(mod, "--shape", "flickr_sm")
    rep, launches, sec = _drive("bench.engine", lambda: mod.run(args, graph=flickr))
    rows = {r["backend"]: r for r in rep["rows"]}
    runs = mod.REPEATS + 2  # warm-up, timed repeats, the counted run
    for backend, key in (("pallas", "k1"), ("sketch", "k2")):
        r = rows[backend]
        if r["kernel_launches"] != r["passes"] or launches[key] != runs * r["passes"]:
            raise AssertionError(f"bench.engine {backend}: {r['kernel_launches']} launches in "
                                 f"a run of {r['passes']} passes ({launches[key]} in all)")
    if (rows["pallas"]["rho"], rows["pallas"]["passes"]) != (rows["exact"]["rho"],
                                                             rows["exact"]["passes"]):
        raise AssertionError(f"bench.engine: pallas {rows['pallas']} != exact {rows['exact']}")
    _bench_record("bench.engine", args, rep, launches, sec)
    return launches


def phase_bench_peel(flickr, mesh) -> dict:
    """``bench.peel`` at flickr_sm: compaction off, twophase and geometric
    bit-identical, slots scanned recorded; the mesh block on the script's
    one-rank NCCL mesh (host ladder and collective ladder == off)."""
    from benchmarks.torch_port import bench_peel_compaction as mod

    args = _bench_args(mod, "--shape", "flickr_sm")
    rep, launches, sec = _drive("bench.peel", lambda: mod.run(args, graph=flickr, mesh=mesh))
    if not mod.identical(rep):
        raise AssertionError(f"bench.peel: a mode is not bit-identical to off: {rep['eps']}")
    for eps, rows in rep["eps"].items():
        if rows["mesh"]["ranks"] != 1:
            raise AssertionError(f"bench.peel: the mesh has {rows['mesh']['ranks']} ranks")
        log("bench.peel", eps=eps, slots_scanned={
            m: rows[m]["edge_slots_scanned"] for m in ("off", "twophase", "geometric")},
            collective_ladder_slots=rows["mesh"]["collective_ladder"]["edge_slots_scanned"])
    _bench_record("bench.peel", args, rep, launches, sec)
    return launches


def phase_bench_api(flickr) -> dict:
    """``bench.api`` at flickr_sm: first call against warm (the pallas first
    call loads K1 through the cache of built kernels), the eps sweep
    against sequential solves (lanes of f32-exact eps bitwise equal)."""
    from benchmarks.torch_port import bench_api as mod

    args = _bench_args(mod, "--shape", "flickr_sm")
    rep, launches, sec = _drive("bench.api", lambda: mod.run(args, graph=flickr))
    kl, sb = rep["kernel_load"], rep["solve_batch"]
    if not (kl["library_loaded"] and kl["equal_to_exact"]) or kl["builds_this_process"] or (
            (kl["disk_hits"], kl["disk_misses"]) != (1, 0)):
        raise AssertionError(f"bench.api: K1's first call {kl}")
    if not all(eq for eq, exact in zip(sb["lane_equal_to_solve"], sb["f32_exact"]) if exact):
        raise AssertionError(f"bench.api: a lane != its solve: {sb}")
    if launches["k1"] == 0:
        raise AssertionError("bench.api: the pallas solves launched no K1")
    _bench_record("bench.api", args, rep, launches, sec)
    return launches


def phase_bench_paper(flickr, lj, mesh) -> dict:
    """``bench.paper``: every entry of the port's ``paper_benches.ALL``:
    fig61 at flickr_sm, table4 at livejournal_md (t=5), fig67 on the
    script's one-rank NCCL mesh, the rest at the reference's sizes."""
    from benchmarks.torch_port import common
    from benchmarks.torch_port import paper_benches as mod

    graphs = {"fig61": dict(edges=flickr), "table4": dict(edges=lj, t=5),
              "fig67": dict(mesh=mesh)}
    total = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    device = common.device_record(DEV)
    for name, fn in mod.ALL.items():
        rows, launches, sec = _drive(f"bench.paper.{name}",
                                     lambda fn=fn, name=name: fn(**graphs.get(name, {}),
                                                                 device=DEV))
        for k in total:
            total[k] += launches[k]
        if name == "kernels":
            (row,) = rows
            if not row["equal_to_plain_and_index_add"] or row["kernel_launches"] == 0:
                raise AssertionError(f"bench.paper.kernels: {row}")
        if name == "table4" and launches["k2"] == 0:
            raise AssertionError("bench.paper.table4: the sketch runs launched no K2")
        if name == "fig67" and any(r["ranks"] != 1 for r in rows):
            raise AssertionError(f"bench.paper.fig67: {rows}")
        rec = {"device": device, "name": name, "rows": rows}
        common.write_json(rec, common.out_path(f"{name}.json"))
        print(f"[bench.paper.{name}] " + json.dumps({"seconds": round(sec, 3),
                                                     "launches": launches, "record": rec}),
              flush=True)
    return total


def phase_bench_stream() -> dict:
    """``bench.stream`` at the reference's defaults (200k nodes, 2^13-edge
    chunks, the memmap store in a temporary directory): sync, async and
    the geometric ladder in RAM and spilled, each bitwise equal to sync."""
    from benchmarks.torch_port import bench_stream as mod

    args = _bench_args(mod)
    rep, launches, sec = _drive("bench.stream", lambda: mod.run(args))
    bad = [m for m, r in rep["modes"].items() if not r["bit_identical_to_sync"]]
    if bad:
        raise AssertionError(f"bench.stream: {bad} differ from the synchronous run")
    _bench_record("bench.stream", args, rep, launches, sec)
    return launches


def phase_bench_turnstile() -> dict:
    """``bench.turnstile`` at the reference's defaults: K3 launches == the
    update batches (per trial, per sweep point and in all); every trial
    inside the envelope."""
    from benchmarks.torch_port import bench_turnstile as mod

    args = _bench_args(mod)
    rep, launches, sec = _drive("bench.turnstile", lambda: mod.run(args))
    points = rep["trials"] + rep["scaling"]
    batches = sum(p["batches_applied"] for p in points)
    if any(p["k3_launches"] != p["batches_applied"] for p in points) or (
            launches["k3"] != batches):
        raise AssertionError(f"bench.turnstile: K3 launches {launches['k3']} for {batches} "
                             "batches")
    if rep["accuracy"]["envelope_pass_rate"] != 1.0:
        raise AssertionError(f"bench.turnstile: {rep['accuracy']}")
    _bench_record("bench.turnstile", args, rep, launches, sec)
    return launches


def phase_bench_serve() -> dict:
    """``bench.serve`` at the reference's defaults: the engine's answers ==
    standalone solves; the cold-start children load K1-K3 from a fresh
    cache directory (nvcc) and then from the warm one with nvcc 0 times."""
    from benchmarks.torch_port import bench_serve as mod

    args = _bench_args(mod)
    rep, launches, sec = _drive("bench.serve", lambda: mod.run(args))
    cs = rep["cold_start"]
    if not rep["bit_identical_to_solve"] or cs["warm_disk_nvcc_runs"] != 0 or (
            cs["uncached_nvcc_runs"] != 3 or cs["warm_disk_hits"] != 3):
        raise AssertionError(f"bench.serve: {rep['bit_identical_to_solve']} {cs}")
    _bench_record("bench.serve", args, rep, launches, sec)
    return launches


def phase_bench_resilience() -> dict:
    """``bench.resilience`` at the reference's defaults: fault-free answers
    bitwise equal with and without the resilience layer; under the storm
    no answer is fabricated."""
    from benchmarks.torch_port import bench_resilience as mod

    args = _bench_args(mod)
    rep, launches, sec = _drive("bench.resilience", lambda: mod.run(args))
    if not rep["fault_free_bit_identical"] or rep["fault_storm"]["fabricated_results"]:
        raise AssertionError(f"bench.resilience: {rep['fault_storm']}")
    _bench_record("bench.resilience", args, rep, launches, sec)
    return launches


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch_port" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The reference's turnstile_churn at its defaults (--n 50000, 200-node
# block, 8,192 samples) fails its own envelope check after the churn: the
# level-4 sample peel reads 9.36 against the survivors' exact 2.13.  The
# port reproduces it to the bit (CPU JAX and the card); this is the ratio.
CHURN_DEFAULT_RATIO = "4.386802852860957"
# The reference's CI variant of the same example (.github/workflows/ci.yml).
CHURN_CI_ARGS = ["--n", "4000", "--planted-k", "100", "--sample-edges", "2048"]


def phase_examples() -> dict:
    """``example.*``: the five examples at their default arguments on the
    card (``mapreduce_stream``'s scratch in a temporary directory); each
    asserts its own answers.  ``turnstile_churn`` at its defaults must fail
    its envelope check with the reference's own ratio (the reference does,
    ``CHURN_DEFAULT_RATIO``), then pass at the reference's CI arguments
    with K3 launched once per update batch (6).  ``engine_matrix``
    launches K1 (two pallas cells) and K2 (three sketch cells),
    ``mapreduce_stream`` K2 (its sketch)."""
    import tempfile

    by_example = {}
    with tempfile.TemporaryDirectory(prefix="example_scratch_") as scratch:
        dev = ["--device", DEV]
        runs = [("quickstart", []), ("directed_csweep", []), ("engine_matrix", []),
                ("mapreduce_stream", ["--scratch", scratch]), ("turnstile_churn", None),
                ("turnstile_churn.ci", CHURN_CI_ARGS)]
        for name, argv in runs:
            mod = _example(name.split(".")[0])
            if argv is None:  # the defaults: the reference's own failure, to the bit
                try:
                    mod.main(dev)
                except AssertionError as e:
                    if f"after churn: ratio {CHURN_DEFAULT_RATIO} outside" not in str(e):
                        raise
                    log("example.turnstile_churn", defaults="fails its envelope check "
                        "after churn with the reference's ratio", ratio=CHURN_DEFAULT_RATIO)
                    continue
                raise AssertionError("turnstile_churn at its defaults passed where the "
                                     "reference fails")
            _, launches, sec = _drive(f"example.{name}",
                                      lambda mod=mod, argv=argv: mod.main(argv + dev))
            by_example[name] = launches
            log(f"example.{name}", seconds=round(sec, 3), launches=launches)
    if by_example["turnstile_churn.ci"]["k3"] != 6 or by_example["engine_matrix"]["k1"] < 2:
        raise AssertionError(f"example: launches {by_example}")
    if by_example["engine_matrix"]["k2"] == 0 or by_example["mapreduce_stream"]["k2"] == 0:
        raise AssertionError(f"example: no K2 launch {by_example}")
    return {k: sum(v[k] for v in by_example.values()) for k in ("k1", "k2", "k3", "k4")}


# -- Path 12: the GNN and recsys families at full width (no kernel of K1-K4b:
# gathers, index_add_ and GEMMs) ---------------------------------------------

GNN_STEPS = 3
# Step 1 at bf16 compute against the same step at f32 compute on the card
# (both accumulate their segment sums in f32: common.segment_sum): the
# loss's error relative to 1 + |loss|, the grad norm's relative error and
# the gradient tree's relative L2 error.  Each cell's limits sit between
# the drift of bf16 compute there and its control (gnn_control), which
# must exceed every one of them; PERF.md has the readings on both sides.
# equiformer-v2 x full_graph_sm holds the gradients only: at random
# weights its loss and grad norm move less when half the edges are lost
# (2.3e-4, 1.5e-4) than under bf16 rounding (3.1e-4, 1.9e-4); both are
# logged.  cell -> (control, limits)
GNN_CELLS = {
    "gnn.minibatch": ("drop16", dict(loss_rel_err=2e-5, grad_norm_rel_err=1e-3,
                                     grad_rel_l2=0.1)),
    "gnn.products": ("drop16", dict(loss_rel_err=1e-4, grad_norm_rel_err=5e-3,
                                    grad_rel_l2=2e-2)),
    "gnn.molecule.mace": ("unmasked", dict(loss_rel_err=1e-2, grad_norm_rel_err=1e-2,
                                           grad_rel_l2=1e-2)),
    "gnn.molecule.egnn": ("drop16", dict(loss_rel_err=1e-2, grad_norm_rel_err=1e-2,
                                         grad_rel_l2=1e-2)),
    "gnn.molecule.equiformer-v2": ("unmasked", dict(loss_rel_err=5e-3, grad_norm_rel_err=5e-3,
                                                    grad_rel_l2=2e-2)),
    "gnn.molecule.graphsage-reddit": ("drop16", dict(loss_rel_err=1e-4,
                                                     grad_norm_rel_err=1e-2,
                                                     grad_rel_l2=0.1)),
    "gnn.cora.equiformer-v2": ("drop4", dict(grad_rel_l2=2.5e-2)),
    "recsys.train": ("unmasked", dict(loss_rel_err=2e-5, grad_norm_rel_err=1e-3,
                                      grad_rel_l2=1.5e-2)),
}
# f32 compute on the card: energies under a rotation plus a translation and
# EGNN's coordinates under a rotation, relative to 1 + the largest |value|
# (the reference's property tests hold 1e-4); the control scales the
# positions by 1.1, which no isometry does.
GNN_INVARIANCE_TOL = 1e-4
RECSYS_TRAIN_BATCH = 32_768  # train_batch's 65,536 cut in half (PERF.md §4)
RECSYS_SERVE = {"serve_p99": 512, "serve_bulk": 262_144}
RECSYS_RETRIEVAL = (1_000_000, 100)  # retrieval_cand: candidates, top k
# bf16 serve scores against f32 ones, the largest |difference| over the
# largest |score| (scores are cosines over the temperature 0.05).
RECSYS_SCORE_TOL = 2e-2
GNN_KERNEL_KINDS = {
    "gemm": ("gemm", "xmma", "nvjet", "cutlass", "Kernel2"),
    "index_add": ("indexFunc", "index_add"),
    "gather": ("indexSelect", "index_select", "index_elementwise"),
    "scatter_reduce": ("scatter",),
    "sort": ("sort", "Sort", "radix"),
}


def gnn_shape_config(arch: str, shape: str, **kw):
    """(spec, config, shape params): the arch's published config specialized
    to the shape's dataset (d_in, n_classes; 0 classes for molecules)."""
    from repro_torch.configs import get_arch
    from repro_torch.train.step import specialize_gnn_config

    spec = get_arch(arch)
    p = dict(spec.shapes[shape].params)
    cfg = specialize_gnn_config(spec.config, {**p, "n_classes": p.get("n_classes", 0)})
    return spec, dataclasses.replace(cfg, **kw), p


def pad_full_batch(batch: dict, pad_to: int = 512) -> dict:
    """``gnn_full_batch_spec``'s padding of a drawn graph: node and edge
    counts up to a multiple of ``pad_to``, the padding nodes isolated (zero
    features, train_mask 0) and the padding edges masked (0 -> 0)."""
    import torch

    n, e = batch["features"].shape[0], batch["src"].shape[0]
    dn, de = -n % pad_to, -e % pad_to
    out = dict(batch)
    for k in ("features", "labels", "train_mask", "positions"):
        if k in batch:
            v = batch[k]
            out[k] = torch.cat([v, v.new_zeros((dn,) + tuple(v.shape[1:]))])
    for k in ("src", "dst", "edge_mask"):
        out[k] = torch.cat([batch[k], batch[k].new_zeros(de)])
    return out


def gnn_control(batch: dict, name: str) -> dict:
    """A cell's control batch: ``drop16`` / ``drop4`` mask out every 16th /
    4th edge (for a sampled block, the last of each root's 15 first-hop
    neighbors), ``unmasked`` counts every edge, the masked self-loops too
    (for the two-tower model: the history mask ignored)."""
    import torch

    if name == "unmasked":
        key = "hist_mask" if "hist_mask" in batch else "edge_mask"
        return {**batch, key: torch.ones_like(batch[key])}
    if "hop1_mask" in batch:  # drop16
        m1 = batch["hop1_mask"].clone()
        m1[:, -1] = 0
        return {**batch, "hop1_mask": m1, "hop2_mask": batch["hop2_mask"] * m1[:, :, None]}
    stride = {"drop16": 16, "drop4": 4}[name]
    idx = torch.arange(batch["edge_mask"].shape[0], device=batch["edge_mask"].device)
    return {**batch, "edge_mask": batch["edge_mask"] & (idx % stride != 0)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_gnn_step1(label: str, spec, kind: str, cfg, params, batch, smi: str) -> dict:
    """Step 1's loss, grad norm and gradients (no update) at bf16 compute
    against f32 compute on the card, within the cell's GNN_CELLS limits,
    and the cell's control batch at bf16 outside every one of them."""
    import torch

    from repro_torch.optim import global_norm
    from repro_torch.train.step import loss_and_grads, make_loss_fn

    control, limits = GNN_CELLS[label]

    def grads(c, b):
        (loss, _, g), wall, _, peak = _peak_run(
            lambda: loss_and_grads(make_loss_fn(spec, kind, cfg=c), params, b))
        return loss.item(), global_norm(g).item(), g, wall, peak

    l32, n32, g32, wall32, peak32 = grads(dataclasses.replace(cfg, compute_dtype=torch.float32),
                                          batch)
    lb, nb, gb, wallb, peakb = grads(cfg, batch)
    dist = _tree_dist(gb, g32)
    del gb

    def errs(loss, norm, dist):
        return dict(loss_rel_err=abs(loss - l32) / (1 + abs(l32)),
                    grad_norm_rel_err=_rel(norm, n32), grad_rel_l2=dist)

    checks = errs(lb, nb, dist)
    lc, nc, gc, _, _ = grads(cfg, gnn_control(batch, control))
    ctrl = errs(lc, nc, _tree_dist(gc, g32))
    del gc, g32
    log(f"{label}.step1", loss_bf16=lb, loss_f32=l32, grad_norm_bf16=nb, grad_norm_f32=n32,
        **checks, limits=limits, control={control: ctrl}, wall_ms_bf16=wallb,
        wall_ms_f32=wall32, peak_above_inputs_mb_bf16=peakb, peak_above_inputs_mb_f32=peak32,
        accumulator="f32 (bf16 messages summed in f32, rounded once)", card=smi)
    hold_limits(label, checks, ctrl, limits)
    return {"loss_bf16": lb, **checks, "control": {control: ctrl}}


def hold_limits(label: str, checks: dict, ctrl: dict, limits: dict) -> None:
    """Every limited check within its limit, the control past every one."""
    over = [k for k in limits if not checks[k] <= limits[k]]
    if over:
        raise AssertionError(f"{label}: bf16 vs f32 past its limits: {over} ({checks})")
    passed = [k for k in limits if not ctrl[k] > limits[k]]
    if passed:
        raise AssertionError(f"{label}: the control passes {passed} ({ctrl})")


def phase_gnn_steps(label: str, spec, kind: str, cfg, params, next_batch, smi: str,
                    profile: bool = False) -> dict:
    """GNN_STEPS ``make_train_step`` steps (AdamW, fp32 moments, in place)
    on ``next_batch()``'s batches: finite losses, the parameters moved;
    then, with ``profile``, one more step under the profiler."""
    import math

    import torch

    from repro_torch import tree
    from repro_torch.optim import AdamWConfig, global_norm, init_state
    from repro_torch.train.step import make_loss_fn, make_train_step

    opt_cfg = AdamWConfig()
    opt = init_state(params, opt_cfg)
    step = make_train_step(make_loss_fn(spec, kind, cfg=cfg), opt_cfg)
    probe = [p.reshape(-1)[:4].clone() for p in tree.leaves(params)]
    rows = []
    for i in range(GNN_STEPS):
        t0 = time.perf_counter()
        batch = next_batch()
        torch.cuda.synchronize()
        data_ms = (time.perf_counter() - t0) * 1e3
        (params, opt, metrics), wall, _, peak = _peak_run(lambda: step(params, opt, batch))
        row = dict(step=i + 1, loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
                   batch_ms=data_ms, step_ms=wall,
                   peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
                   peak_above_state_mb=peak)
        log(f"{label}.step", **row, card=smi)
        rows.append(row)
        if not all(math.isfinite(row[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"{label} step {i + 1}: not finite {row}")
    moved = any(not torch.equal(a, p.reshape(-1)[:4]) for a, p in zip(probe, tree.leaves(params)))
    pnorm = global_norm(params).item()
    if not moved or not math.isfinite(pnorm):
        raise AssertionError(f"{label}: the parameters did not move or are not finite ({pnorm})")
    out = dict(median_step_ms_2_3=statistics.median(r["step_ms"] for r in rows[1:]),
               median_batch_ms=statistics.median(r["batch_ms"] for r in rows),
               peak_device_mb=max(r["peak_device_mb"] for r in rows), param_norm=pnorm)
    if out["peak_device_mb"] >= 80 * 1024:
        raise AssertionError(f"{label}: peak {out['peak_device_mb']} MB: over 80 GB")
    if profile:
        batch = next_batch()
        phase_profile(f"{label}_train_step", lambda: step(params, opt, batch),
                      kinds=GNN_KERNEL_KINDS, card=smi)
    del opt
    return out


def _gnn_params(spec, cfg, seed: int = 0):
    import torch

    from repro_torch.train.step import init_model_params

    return init_model_params(spec, torch.Generator(device=DEV).manual_seed(seed), cfg=cfg,
                             device=DEV)


def phase_gnn_minibatch(smi: str) -> dict:
    """graphsage-reddit x minibatch_lg: the 232,965-node, 114,615,892-edge
    graph drawn as ``gnn_full_batch`` draws it (its features are the
    602-wide table, 561 MB on the card), the CSR sorted on the card (229 M
    slots), the layered sampler (1,024 roots, fanout 15-10) on the host;
    step 1 bf16 vs f32, GNN_STEPS steps and one profiled."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import gnn_full_batch
    from repro_torch.graph.sampler import CSRGraph, LayeredSampler

    spec, cfg, p = gnn_shape_config("graphsage-reddit", "minibatch_lg")
    t0 = time.perf_counter()
    g = gnn_full_batch(np.random.default_rng(0), p["n_nodes"], p["n_edges"], p["d_feat"],
                       p["n_classes"], False, device=DEV)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = CSRGraph.from_edges(g["src"], g["dst"], p["n_nodes"], device=DEV)
    csr_s = time.perf_counter() - t0
    feats, labels = g["features"], g["labels"].cpu().numpy()
    del g
    torch.cuda.empty_cache()
    sampler = LayeredSampler(csr, labels, p["batch_nodes"], tuple(p["fanout"]), seed=0)
    sample_ms = []

    def next_batch():
        t = time.perf_counter()
        b = next(sampler)
        sample_ms.append((time.perf_counter() - t) * 1e3)
        return {"feat_table": feats, **{k: torch.from_numpy(v).to(DEV) for k, v in b.items()}}

    log("gnn.minibatch.graph", nodes=p["n_nodes"], edges=p["n_edges"], csr_slots=len(csr.indices),
        feat_table_mb=feats.numel() * 4 / 2**20, gen_seconds=round(gen_s, 3),
        csr_seconds=round(csr_s, 3), card=smi)
    torch.cuda.reset_peak_memory_stats()
    params = _gnn_params(spec, cfg)
    first = next_batch()
    s1 = phase_gnn_step1("gnn.minibatch", spec, "sampled_train", cfg, params, first, smi)
    steps = phase_gnn_steps("gnn.minibatch", spec, "sampled_train", cfg, params, next_batch, smi,
                            profile=True)
    out = dict(arch="graphsage-reddit", shape="minibatch_lg", roots=p["batch_nodes"],
               fanout=list(p["fanout"]), sampler_ms_per_batch=statistics.median(sample_ms),
               **steps, card=smi)
    log("gnn.minibatch", **out)
    return {**out, **s1}


def phase_gnn_products(mesh, smi: str) -> dict:
    """graphsage-reddit x ogb_products, full batch: 2,449,029 nodes and
    61,859,140 uniform edges padded to 512 as ``gnn_full_batch_spec``
    pads; step 1 bf16 vs f32, GNN_STEPS steps and one profiled; then the
    tiled neighbor sum (``models/gnn/dist.py``) on the one-rank NCCL mesh
    over the same edges at width 32, f32, against the untiled oracle."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import gnn_full_batch

    spec, cfg, p = gnn_shape_config("graphsage-reddit", "ogb_products")
    t0 = time.perf_counter()
    batch = pad_full_batch(gnn_full_batch(np.random.default_rng(0), p["n_nodes"], p["n_edges"],
                                          p["d_feat"], p["n_classes"], False, device=DEV))
    torch.cuda.synchronize()
    log("gnn.products.graph", nodes=batch["features"].shape[0], edges=batch["src"].shape[0],
        real_nodes=p["n_nodes"], real_edges=p["n_edges"],
        gen_seconds=round(time.perf_counter() - t0, 3), card=smi)
    params = _gnn_params(spec, cfg)
    s1 = phase_gnn_step1("gnn.products", spec, "full_train", cfg, params, batch, smi)
    steps = phase_gnn_steps("gnn.products", spec, "full_train", cfg, params, lambda: batch, smi,
                            profile=True)
    out = dict(arch="graphsage-reddit", shape="ogb_products", **steps, card=smi)
    log("gnn.products", **out)
    del params
    phase_gnn_dist(batch, mesh, smi)
    return {**out, **s1}


def phase_gnn_dist(batch, mesh, smi: str) -> None:
    """``make_tiled_neighbor_sum`` on a one-rank NCCL group over the
    ogb_products edges, X [N, 32] f32 and random edge weights: Z and the
    gradients of sum(Z * probe) with respect to X and the weights against
    ``neighbor_sum_reference`` (rtol/atol 1e-5 values, 1e-4/1e-5 gradients,
    the reference test's), one all-gather forward, one all-gather and one
    all-reduce backward."""
    import torch

    from repro_torch import collectives
    from repro_torch.models.gnn import dist

    src, dst = batch["src"], batch["dst"]
    n = batch["features"].shape[0]
    t0 = time.perf_counter()
    tiling = dist.build_edge_tiling(src.cpu().numpy(), dst.cpu().numpy(), n, 1)
    tiling_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn((tiling.n_nodes_padded, 32), device=DEV, generator=gen)
    w = torch.rand(src.shape[0], device=DEV, generator=gen)
    probe = torch.randn(x.shape, device=DEV, generator=gen)
    f = dist.make_tiled_neighbor_sum(tiling, mesh, ("data",))

    def run(fn):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        with torch.enable_grad():
            z = fn(xr, wr)
            (z * probe).sum().backward()
        return z.detach(), xr.grad, wr.grad

    collectives.reset()
    (z, dx, dw), wall, _, peak = _peak_run(lambda: run(f))
    coll = (collectives.all_gather.count, collectives.all_reduce.count)
    zr, dxr, dwr = run(lambda a, b: dist.neighbor_sum_reference(a, b, src, dst, n))
    errs = dict(z=check_close("gnn.dist z", z, zr, 1e-5),
                dx=_close_rt("gnn.dist dx", dx, dxr), dw=_close_rt("gnn.dist dw", dw, dwr))
    if coll != (2, 1):
        raise AssertionError(f"gnn.dist: collectives (all_gather, all_reduce) {coll} != (2, 1)")
    log("gnn.dist", nodes=n, edges=src.shape[0], width=32, tiling_seconds=round(tiling_s, 3),
        fwd_bwd_ms=wall, peak_above_inputs_mb=peak, all_gather=coll[0], all_reduce=coll[1],
        max_abs_err=errs, equal="tiled == untiled oracle (values 1e-5, grads rtol 1e-4 / "
        "atol 1e-5)", card=smi)


def _close_rt(what: str, got, want, rtol: float = 1e-4, atol: float = 1e-5) -> float:
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values outside rtol {rtol} atol {atol} "
                             f"(max abs err {err.max().item()})")
    return err.max().item()


def _energies(arch: str, params, cfg, batch):
    """Per-molecule energies of mace or egnn (their loss's ``e``)."""
    from repro_torch.models.common import mlp, segment_sum, silu
    from repro_torch.models.gnn import egnn, mace

    n_graphs = batch["graph_labels"].shape[0]
    if arch == "egnn":
        h, _ = egnn.forward(params, cfg, batch)
        return egnn.readout_energy(params, cfg, h, batch["graph_ids"], n_graphs)
    h = mace.forward(params, cfg, batch)
    e_node = mlp(params["readout"], h, act=silu, compute_dtype=cfg.compute_dtype)
    return segment_sum(e_node[:, 0].float(), batch["graph_ids"], n_graphs)


def phase_gnn_invariance(arch: str, params, cfg, batch, smi: str) -> None:
    """f32 compute on the card: mace's and egnn's energies under a random
    rotation plus a translation, egnn's coordinates under a rotation,
    within GNN_INVARIANCE_TOL of 1 + the largest |value|; the control
    (positions scaled by 1.1) outside it."""
    import numpy as np
    import torch

    from repro_torch.models.gnn import egnn

    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    R = torch.tensor(q, dtype=torch.float32, device=DEV)
    t = torch.tensor(rng.standard_normal(3), dtype=torch.float32, device=DEV)
    pos = batch["positions"]

    def rel(got, want):
        return ((got - want).abs().max() / (1 + want.abs().max())).item()

    with torch.no_grad():
        e1 = _energies(arch, params, cfg, batch)
        e2 = _energies(arch, params, cfg, {**batch, "positions": pos @ R.T + t})
        ec = _energies(arch, params, cfg, {**batch, "positions": pos * 1.1})
        out = dict(energy_err=rel(e2, e1), energy_control=rel(ec, e1))
        if arch == "egnn":
            _, x1 = egnn.forward(params, cfg, batch)
            _, x2 = egnn.forward(params, cfg, {**batch, "positions": pos @ R.T})
            _, xc = egnn.forward(params, cfg, {**batch, "positions": pos * 1.1})
            out.update(coords_err=rel(x2, x1 @ R.T), coords_control=rel(xc, x1))
    log(f"gnn.molecule.{arch}.invariance", **out, limit=GNN_INVARIANCE_TOL, card=smi)
    for k, v in out.items():
        if k.endswith("_err") and not v <= GNN_INVARIANCE_TOL:
            raise AssertionError(f"{arch}: {k} {v} past {GNN_INVARIANCE_TOL}")
        if k.endswith("_control") and v <= GNN_INVARIANCE_TOL:
            raise AssertionError(f"{arch}: the control {k} {v} within {GNN_INVARIANCE_TOL}")


def phase_gnn_molecule(smi: str) -> dict:
    """Each GNN arch at its published width x molecule (128 molecules x 30
    nodes x 64 edges, d_feat 16), energy regression: step 1 bf16 vs f32,
    GNN_STEPS steps; mace's and egnn's invariance checks."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import _gnn_needs_positions, gnn_molecule_batch

    out = {}
    for arch in ("mace", "egnn", "equiformer-v2", "graphsage-reddit"):
        spec, cfg, p = gnn_shape_config(arch, "molecule")
        batch = gnn_molecule_batch(np.random.default_rng(0), p["batch"], p["n_nodes"],
                                   p["n_edges"], p["d_feat"], _gnn_needs_positions(arch),
                                   device=DEV)
        torch.cuda.reset_peak_memory_stats()
        params = _gnn_params(spec, cfg)
        label = f"gnn.molecule.{arch}"
        s1 = phase_gnn_step1(label, spec, "molecule_train", cfg, params, batch, smi)
        if arch in ("mace", "egnn"):
            phase_gnn_invariance(arch, params, cfg, batch, smi)
        steps = phase_gnn_steps(label, spec, "molecule_train", cfg, params, lambda: batch, smi,
                                profile=arch == "equiformer-v2")
        out[arch] = {**steps, **s1}
        log(label, layers=cfg.n_layers, d_hidden=cfg.d_hidden, **steps, card=smi)
    return out


def phase_gnn_equiformer_cora(smi: str) -> dict:
    """equiformer-v2 at full width (12 layers, l_max 6, m_max 2, 8 heads) x
    full_graph_sm (2,708 nodes, 10,556 edges, d_feat 1,433, 7 classes):
    step 1 bf16 vs f32, GNN_STEPS steps."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import gnn_full_batch

    spec, cfg, p = gnn_shape_config("equiformer-v2", "full_graph_sm")
    batch = gnn_full_batch(np.random.default_rng(0), p["n_nodes"], p["n_edges"], p["d_feat"],
                           p["n_classes"], True, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    params = _gnn_params(spec, cfg)
    s1 = phase_gnn_step1("gnn.cora.equiformer-v2", spec, "full_train", cfg, params, batch,
                         smi)
    steps = phase_gnn_steps("gnn.cora.equiformer-v2", spec, "full_train", cfg, params,
                            lambda: batch, smi)
    log("gnn.cora.equiformer-v2", **steps, card=smi)
    return {**steps, **s1}


def phase_recsys(smi: str) -> dict:
    """two-tower-retrieval at full width (8,388,608 users, 2,097,152 items,
    embed 256, towers 1024-512-256, history 32; 10.7 GB of f32 tables from
    a seeded generator): ``make_recsys_serve`` at serve_p99 and serve_bulk
    (bf16 against f32 scores), ``make_recsys_retrieval`` at retrieval_cand
    (its top 100 against a full sort of the same scores), then train_batch
    cut to RECSYS_TRAIN_BATCH rows: step 1 bf16 vs f32 (the control ignores
    the history mask), GNN_STEPS steps, one profiled."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import recsys_stream
    from repro_torch.data.synthetic import recsys_train_batch
    from repro_torch.models import recsys
    from repro_torch.train.step import make_recsys_retrieval, make_recsys_serve

    spec = get_arch("two-tower-retrieval")
    cfg = spec.config
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    t0 = time.perf_counter()
    params = _gnn_params(spec, cfg)
    torch.cuda.synchronize()
    tables_mb = (params["user_table"].numel() + params["item_table"].numel()) * 4 / 2**20
    log("recsys.model", users=cfg.n_users, items=cfg.n_items, embed=cfg.embed_dim,
        towers=list(cfg.tower_dims), tables_mb=tables_mb,
        init_seconds=round(time.perf_counter() - t0, 3), card=smi)
    out = {}
    for shape, rows in RECSYS_SERVE.items():
        batch = recsys_train_batch(np.random.default_rng(1), cfg, rows, device=DEV)
        serve, serve32 = make_recsys_serve(cfg), make_recsys_serve(f32)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            s16, s32 = serve(params, batch), serve32(params, batch)
            sc = serve(params, {**batch, "hist_mask": torch.ones_like(batch["hist_mask"])})
            ms = time_ms(lambda: serve(params, batch), n=10)
        err = ((s16 - s32).abs().max() / s32.abs().max()).item()
        ctrl = ((sc - s32).abs().max() / s32.abs().max()).item()
        out[shape] = dict(rows=rows, ms_per_call=ms, rows_per_s=rows / ms * 1e3,
                          score_err_bf16_vs_f32=err, control_history_mask_ignored=ctrl,
                          limit=RECSYS_SCORE_TOL,
                          peak_device_mb=torch.cuda.max_memory_allocated() / 2**20)
        log(f"recsys.{shape}", **out[shape], card=smi)
        if not torch.isfinite(s16).all() or not err <= RECSYS_SCORE_TOL < ctrl:
            raise AssertionError(f"recsys.{shape}: {out[shape]}")
    n_cand, k = RECSYS_RETRIEVAL
    rng = np.random.default_rng(2)
    query = {
        "user_id": torch.tensor([3], dtype=torch.int32, device=DEV),
        "hist": torch.from_numpy(rng.integers(0, cfg.n_items, (1, cfg.hist_len),
                                              dtype=np.int32)).to(DEV),
        "hist_mask": torch.ones((1, cfg.hist_len), device=DEV),
        "cand_ids": torch.from_numpy(rng.integers(0, cfg.n_items, n_cand,
                                                  dtype=np.int32)).to(DEV),
    }
    retrieve = make_recsys_retrieval(cfg, k=k)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got = retrieve(params, query)
        ms = time_ms(lambda: retrieve(params, query), n=10)
        u = recsys.user_embedding(params, cfg, query["user_id"], query["hist"],
                                  query["hist_mask"])
        full = (u @ recsys.item_embedding(params, cfg, query["cand_ids"]).T)[0] / cfg.temperature
        plain = torch.sort(full, descending=True).values[:k]
    check_equal("recsys.retrieval top-k scores vs a full sort", got["scores"], plain)
    out["retrieval_cand"] = dict(candidates=n_cand, k=k, ms_per_query=ms,
                                 peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
                                 equal="top-k scores == a full sort's first k, bitwise")
    log("recsys.retrieval_cand", **out["retrieval_cand"], card=smi)
    stream = recsys_stream(cfg, RECSYS_TRAIN_BATCH, seed=0, device=DEV)
    first = next(stream)
    out["step1"] = phase_gnn_step1("recsys.train", spec, "train", cfg, params, first, smi)
    out["train"] = phase_gnn_steps("recsys.train", spec, "train", cfg, params,
                                   lambda: next(stream), smi, profile=True)
    log("recsys.train", batch=RECSYS_TRAIN_BATCH,
        reduced="global batch 65,536 -> 32,768 (the [B, B] logits and their gradient)",
        moments="fp32", **out["train"], card=smi)
    del params
    return out


def phase_gnn_example(smi: str) -> None:
    """examples/torch_port/community_gnn.py on the card: every community's
    size, density and purity equal the golden fixture's (the reference
    example's at its defaults; unit weights, so the densities bitwise), and
    the resume from step 150 reaches step 200."""
    import tempfile

    import numpy as np

    import torch_port_golden as golden
    from repro_torch.graph.generators import planted_partition

    with open(golden.GOLDEN) as f:
        want = json.load(f)["gnn_train"]["community"]["answers"]
    with tempfile.TemporaryDirectory(prefix="community_gnn_") as tmp:
        t0 = time.perf_counter()
        res = _example("community_gnn").main(["--ckpt-dir", tmp])
        sec = time.perf_counter() - t0
    c = golden.COMMUNITY
    _, truth = planted_partition(n=c["n"], k=c["k"], p_in=c["p_in"], p_out=c["p_out"],
                                 seed=c["seed"], device=DEV)
    got = golden.community_record(res["communities"], truth)
    if got != want:
        raise AssertionError(f"community_gnn: {got} != the golden {want}")
    if res["resumed"]["step"] != 200 or not np.isfinite(res["resumed"]["loss"]):
        raise AssertionError(f"community_gnn: the resume ended at {res['resumed']}")
    log("gnn.example.community_gnn", seconds=round(sec, 3), communities=got,
        first_loss=res["first_loss"], loss_150=res["loss_150"],
        loss_200=res["resumed"]["loss"], equal="communities == the JAX golden (bitwise rho)",
        card=smi)


def phase_gnn_golden(smi: str) -> None:
    """The REDUCED configs of the four GNN archs and the two-tower model on
    the card (float32 compute) meet the JAX golden fixture's ``gnn_train``
    entries (loss, metrics, grad norm, leaf sums after one AdamW step; the
    two-tower serve and top-k scores and items)."""
    import torch_port_golden as golden

    with open(golden.GOLDEN) as f:
        fixture = json.load(f)["gnn_train"]["answers"]
    for arch in golden.GNN_TRAIN_ARCHS:
        got = golden.port_gnn_train_entry(arch, DEV)
        bad = golden.gnn_train_mismatch(got, fixture[arch])
        if bad:
            raise AssertionError(f"gnn_train golden {arch}: {bad}")
        log("golden", gnn_train_arch=arch, equal=f"JAX golden (rtol=atol="
            f"{golden.LM_LOGITS_TOL}; leaf sums + {golden.LM_TRAIN_SUM_ATOL})",
            total=got["total"], grad_norm=got["grad_norm"], card=smi)


def phase_gnn_cli(smi: str) -> None:
    """``repro_torch.launch.train.main(['--arch', a, ...])`` for each GNN
    arch and the two-tower model, with no ``--device``: the card."""
    import tempfile

    import numpy as np

    from repro_torch.launch import train

    for arch in ("mace", "egnn", "graphsage-reddit", "equiformer-v2", "two-tower-retrieval"):
        with tempfile.TemporaryDirectory(prefix="train_cli_") as tmp:
            out = train.main(["--arch", arch, "--steps", "3", "--batch", "64",
                              "--ckpt-every", "3", "--ckpt-dir", tmp])
        if out["status"] != "done" or out["step"] != 3 or not np.isfinite(out["loss"]):
            raise AssertionError(f"launch.train --arch {arch}: {out}")
        log("gnn.cli", arch=arch, steps=out["step"], loss=out["loss"], card=smi)


def path_gnn(mesh, smi: str) -> dict:
    """Path 12: every cell above, with the five kernels' counts set to 0
    before and read after (no kernel of K1-K4b lies on this path)."""
    import torch

    t0 = time.perf_counter()
    _zero_counts()
    out = {"minibatch": phase_gnn_minibatch(smi)}
    torch.cuda.empty_cache()
    out["products"] = phase_gnn_products(mesh, smi)
    torch.cuda.empty_cache()
    out["molecule"] = phase_gnn_molecule(smi)
    out["cora"] = phase_gnn_equiformer_cora(smi)
    torch.cuda.empty_cache()
    out["recsys"] = phase_recsys(smi)
    torch.cuda.empty_cache()
    phase_gnn_example(smi)
    phase_gnn_golden(smi)
    phase_gnn_cli(smi)
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"path 12 launched a kernel of K1-K4b: {counts}")
    log("gnn.path", seconds=round(time.perf_counter() - t0, 3), launches=counts, card=smi)
    return counts



# ---------------------------------------------------------------------------
# Path 13: the launch dry-run layer (sharding/, launch/), its accounting
# held against real runs on the card
# ---------------------------------------------------------------------------

LAUNCH_DRYRUN_TIMEOUT = 600  # s for the 88 records, both meshes, in LAUNCH_JOBS children
LAUNCH_JOBS = 8
LAUNCH_BYTES_TOL = 0.01  # predicted argument bytes against memory_allocated, overall
LAUNCH_PREDICT = r"""
import json
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((1, 1), ("data", "model"))
out = {}
for key, arch, shape, ov in (
        ("llama", "llama3.2-3b", "train_4k", {"shape_params": {"global_batch": 1}}),
        ("graphsage", "graphsage-reddit", "ogb_products", {})):
    cell = cells.build_cell(arch, shape, mesh=mesh, overrides=ov)
    tr = cells.trace_cell(cell)
    out[key] = {"arg_bytes": tr.arg_bytes, "flops": tr.stats["flops"], "info": cell.info}
cell = cells.build_cell("densest-mapreduce", "livejournal_md", mesh=mesh)
stats, _ = cells._run(cell, answer=cells._alternate())
body = stats.reads[1].minus(stats.reads[0])
out["densest"] = {"collectives_a_pass": body.collective_count,
                  "in_bytes_a_pass": body.collective_in_bytes, "info": cell.info}
print("RESULT=" + json.dumps(out))
"""


def _src_env() -> dict:
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def launch_predictions_start():
    """The dry-run's predictions for path 13's three cells at a one-rank mesh,
    in a child process (a fake world cannot share this process with the
    NCCL world); started early, read when needed."""
    return subprocess.Popen([sys.executable, "-c", LAUNCH_PREDICT], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_src_env(), cwd=ROOT)


def launch_predictions(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT=")]
    if proc.returncode or not line:
        raise RuntimeError(f"launch predictions failed (rc {proc.returncode}): {err[-3000:]}")
    return json.loads(line[-1][len("RESULT="):])


def phase_launch_densest(lj, mesh, pred: dict, smi: str) -> None:
    """densest-mapreduce x livejournal_md on the NCCL mesh: the collectives a
    pass the trace predicts against ``repro_torch.collectives``' counters."""
    import torch

    from repro_torch import collectives
    from repro_torch.configs import get_arch
    from repro_torch.core.mapreduce import make_distributed_peel, shard_edges

    cfg = get_arch("densest-mapreduce").config
    axes = tuple(mesh.mesh_dim_names)
    sh = shard_edges(lj, mesh, axes)
    fn = make_distributed_peel(mesh, axes, eps=cfg.eps, max_passes=cfg.max_passes,
                               n_nodes=lj.n_nodes)
    collectives.reset()
    out = fn(sh.src, sh.dst, sh.weight, sh.mask)
    torch.cuda.synchronize()
    passes = out.passes
    count = (collectives.all_reduce.count + collectives.all_gather.count) / passes
    in_bytes = (collectives.all_reduce.bytes + collectives.all_gather.bytes) / passes
    want = pred["densest"]
    log("launch.card", cell="densest-mapreduce x livejournal_md", mesh="one-rank NCCL",
        passes=passes, expected_passes=want["info"]["expected_passes"],
        collectives_a_pass=count, predicted=want["collectives_a_pass"],
        bytes_a_pass=in_bytes, predicted_bytes=want["in_bytes_a_pass"], card=smi)
    if count != want["collectives_a_pass"] or in_bytes != want["in_bytes_a_pass"]:
        raise RuntimeError("launch.card: the densest cell's collectives a pass differ from "
                           "the dry-run's")


def phase_launch_dryrun(smi: str) -> dict:
    """``python -m repro_torch.launch.dryrun --all --include-densest
    --both-meshes``: 80 ok, 8 skipped with the configs' reasons, 0 errors;
    each single-pod cell's bound and terms under the H100 constants."""
    import shutil

    from repro_torch.configs import get_arch

    out_dir = ROOT / "experiments" / "dryrun" / "torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--include-densest",
           "--both-meshes", "--jobs", str(LAUNCH_JOBS), "--out-dir", str(out_dir)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=LAUNCH_DRYRUN_TIMEOUT,
                         env=_src_env(), cwd=ROOT)
    seconds = time.perf_counter() - t0
    recs = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    status = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
    for r in recs:
        if r["status"] == "skipped":
            want = get_arch(r["arch"]).shape(r["shape"]).skip_reason
            if r["skip_reason"] != want:
                raise RuntimeError(f"launch.dryrun: {r['arch']} x {r['shape']} skipped for "
                                   f"{r['skip_reason']!r}, the config says {want!r}")
    for r in recs:
        if r["status"] == "ok" and r["mesh"] == "16x16":
            rl = r["roofline"]
            log("launch.dryrun.cell", cell=f"{r['arch']} x {r['shape']}", bound=rl["bound"],
                compute_ms=rl["compute_s"] * 1e3, memory_ms=rl["memory_s"] * 1e3,
                collective_ms=rl["collective_s"] * 1e3,
                roofline_fraction=rl["roofline_fraction"], chip=r["chip"]["name"])
    log("launch.dryrun", **status, records=len(recs), seconds=round(seconds, 3),
        timeout=LAUNCH_DRYRUN_TIMEOUT, jobs=LAUNCH_JOBS, rc=res.returncode, card=smi)
    if status != {"ok": 80, "skipped": 8, "error": 0} or res.returncode:
        raise RuntimeError(f"launch.dryrun: {status}, rc {res.returncode}: "
                           f"{res.stdout[-3000:]} {res.stderr[-2000:]}")
    return status


def _launch_card(label: str, spec, kind: str, cfg, make_params, make_batch, pred: dict,
                 smi: str) -> None:
    """Places one cell's real state on the card and holds it to the dry-run's
    prediction: the parameters' tensor bytes exact (``memory_allocated``
    after them printed beside: the allocator rounds its blocks), all
    argument bytes within LAUNCH_BYTES_TOL of ``memory_allocated``, the
    step's dot FLOPs
    (``FlopCounterMode``) equal to the traced step's; then one timed step
    and its roofline fraction."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree as tree_util
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.step import make_loss_fn, make_train_step

    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    params = make_params()
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    opt_cfg = AdamWConfig(moment_dtype="fp32")
    opt = init_state(params, opt_cfg)
    batch = make_batch()
    torch.cuda.synchronize()
    m3 = torch.cuda.memory_allocated()
    want = pred["arg_bytes"]
    param_bytes = sum(x.numel() * x.element_size() for x in tree_util.leaves(params))
    step = make_train_step(make_loss_fn(spec, kind, cfg=cfg), opt_cfg)
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
        torch.cuda.synchronize()
    flops = fc.get_total_flops()
    t0 = time.perf_counter()
    step(params, opt, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = sum(want.values())
    rel = abs((m3 - m0) - total) / total
    frac = pred["info"]["flops_model"] / (BF16_FLOPS * wall)
    log("launch.card", cell=label, params_bytes=param_bytes, params_allocated=m1 - m0,
        predicted_params=want["params"],
        arg_bytes=m3 - m0, predicted_args=total, rel_err=rel, dot_flops=flops,
        predicted_flops=pred["flops"], step_ms=wall * 1e3,
        model_flops=pred["info"]["flops_model"], roofline_fraction=frac,
        peak_bf16=BF16_FLOPS, card=smi)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    if param_bytes != want["params"] or rel > LAUNCH_BYTES_TOL or flops != pred["flops"]:
        raise RuntimeError(f"launch.card: {label} differs from the dry-run's prediction")


def phase_launch_card(pred: dict, smi: str) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import gnn_full_batch, lm_train_batch
    from repro_torch.models.gnn import graphsage
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import specialize_gnn_config

    spec = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(spec.config, attn_impl="auto", remat=True)
    _launch_card(
        "llama3.2-3b x train_4k (global_batch 1)", spec, "train", cfg,
        lambda: init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV),
        lambda: lm_train_batch(np.random.default_rng(0), cfg.vocab, 1,
                               spec.shape("train_4k").params["seq_len"], DEV),
        pred["llama"], smi)
    spec = get_arch("graphsage-reddit")
    p = dict(spec.shape("ogb_products").params)
    cfg = specialize_gnn_config(spec.config, p)
    _launch_card(
        "graphsage-reddit x ogb_products", spec, "full_train", cfg,
        lambda: graphsage.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV),
        lambda: pad_full_batch(gnn_full_batch(np.random.default_rng(0), p["n_nodes"],
                                              p["n_edges"], p["d_feat"], p["n_classes"],
                                              False, DEV)),
        pred["graphsage"], smi)


def phase_launch_pipeline(mesh, smi: str) -> None:
    """``pipelined_apply`` with one stage on the card == the sequential
    stack, forward (rtol = atol 2e-5) and gradient (5e-4 / 1e-5)."""
    import torch

    from repro_torch.sharding.pipeline import bubble_fraction, pipelined_apply

    g = torch.Generator(device=DEV).manual_seed(0)
    w = (torch.randn(1, 256, 256, device=DEV, generator=g) * 0.06).requires_grad_()
    x = torch.randn(8, 4, 256, device=DEV, generator=g)
    out = pipelined_apply(mesh, mesh.mesh_dim_names[0], lambda wi, h: torch.tanh(h @ wi), w, x)
    (out ** 2).mean().backward()
    w2 = w.detach().clone().requires_grad_()
    want = torch.tanh(x @ w2[0])
    (want ** 2).mean().backward()
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(w.grad, w2.grad, rtol=5e-4, atol=1e-5)
    log("launch.pipeline", stages=1, micro=8, out_err=(out - want).abs().max().item(),
        grad_err=(w.grad - w2.grad).abs().max().item(), bubble=bubble_fraction(1, 8), card=smi)


def path_launch(mesh, pred: dict, smi: str) -> dict:
    """Path 13: the dry-run, its accounting against the card, the pipeline;
    K1-K4b launch 0 times here."""
    _zero_counts()
    t0 = time.perf_counter()
    phase_launch_dryrun(smi)
    phase_launch_card(pred, smi)
    phase_launch_pipeline(mesh, smi)
    counts = _counts()
    log("launch.path", seconds=round(time.perf_counter() - t0, 3), launches=counts, card=smi)
    return counts

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
    launch_child = launch_predictions_start()
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
    # Path 13's densest cell (its other parts run last).
    launch_pred = launch_predictions(launch_child)
    phase_launch_densest(lj, mesh, launch_pred, smi)
    # Path 9 (its part that needs livejournal_md): the paper's tables.
    path9 = {"bench.paper": phase_bench_paper(flickr, lj, mesh)}
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
    # Path 9: the port's benchmarks at flickr_sm (K1, K2), on the mesh.
    path9["bench.engine"] = phase_bench_engine(flickr)
    path9["bench.peel"] = phase_bench_peel(flickr, mesh)
    path9["bench.api"] = phase_bench_api(flickr)
    phase_build_cache()
    phase_golden_serve()
    del flickr
    torch.cuda.empty_cache()
    # Path 9: the benchmarks that draw their own graphs, and the examples.
    path9["bench.stream"] = phase_bench_stream()
    path9["bench.turnstile"] = phase_bench_turnstile()
    path9["bench.serve"] = phase_bench_serve()
    path9["bench.resilience"] = phase_bench_resilience()
    path9["example"] = phase_examples()
    torch.cuda.empty_cache()
    phase_directed(mesh)
    torch.cuda.empty_cache()
    phase_directed_sketch()
    torch.cuda.empty_cache()
    phase_golden_objectives()
    # Path 4: the LM at full width through K4 (llama3.2-3b).
    from repro_torch.models.transformer import init_params, prefill

    k4 = phase_flash_kernel(smi)
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
    # Path 11: training at full width (the same llama3.2-3b weights, now
    # trained in place), K4's trainable route, the golden training entries
    # and the training CLI's kill and resume.
    t_train = time.perf_counter()
    batches = train_batches()
    train = phase_train_steps(params, batches, phase_train_step1(params, batches, smi), smi)
    del batches, params
    torch.cuda.empty_cache()
    k4_train = phase_train_attention(smi)
    phase_train_golden(smi)
    phase_train_cli(smi)
    log("train.path", seconds=round(time.perf_counter() - t_train, 3), card=smi)
    phase_lm_golden()
    # Path 10: mixtral-8x7b at full width (depth cut), the MoE FFN and K4's
    # sliding window.
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    params = init_params(moe_config(), torch.Generator(device=DEV).manual_seed(0), DEV)
    tokens = torch.randint(0, moe_config().vocab, (1, MOE_PROMPT), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(1))
    torch.cuda.synchronize()
    log("moe.model", arch="mixtral-8x7b", layers=MOE_LAYERS,
        reduced=f"depth: {MOE_LAYERS} of 32 layers (widths, experts, window and vocab as "
                "published)", params=moe_config().param_count(),
        weights_mb=torch.cuda.memory_allocated() / 2**20,
        init_seconds=round(time.perf_counter() - t0, 3), card=smi)
    k4_moe = phase_moe_prefill(params, tokens, smi)
    phase_profile("mixtral_prefill_pallas",
                  lambda: prefill(params, moe_config(attn_impl="pallas"), tokens),
                  span=(transformer, "moe_apply"), card=smi)
    phase_moe_serve(params, smi)
    del params, tokens
    torch.cuda.empty_cache()
    phase_moe_golden(smi)
    # Path 12: the GNN and recsys families at full width (no kernel of
    # K1-K4b; the tiled neighbor sum on the NCCL mesh).
    gnn = path_gnn(mesh, smi)
    # Path 13: the launch dry-run layer; no kernel of K1-K4b.
    launch = path_launch(mesh, launch_pred, smi)
    k4["launches_by_path"] = {"lm.prefill": k4["launches"], "moe.prefill": k4_moe["launches"],
                              "train.step": train["launches"],
                              "train.k4": k4_train["launches"], "gnn": gnn["k4"],
                              "launch": launch["k4"]}
    k4["trainable"] = k4_train["trainable"]
    k4b = k4_train["k4b"]
    k4b["launches_by_path"] = {"train.k4": k4_train["bwd_launches"],
                               "train.step": train["bwd_launches"], "gnn": gnn["k4_bwd"],
                               "launch": launch["k4_bwd"]}
    import torch.distributed as dist

    dist.destroy_process_group()
    log("done", seconds=round(time.perf_counter() - t_start, 3))
    k1.setdefault("launches_by_path", {"flickr": k1["launches"]})
    k3.setdefault("launches_by_path", {"turnstile": k3["launches"]})
    for kern, key in ((k1, "k1"), (k2, "k2"), (k3, "k3")):
        kern["launches_by_path"].update(
            {path: n[key] for path, n in path9.items() if n[key]})
        kern["launches_by_path"]["gnn"] = gnn[key]
        kern["launches_by_path"]["launch"] = launch[key]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path", "moe_window",
            "trainable", "f32")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern}
                                  for kern in (k1, k2, k3, k4, k4b)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
