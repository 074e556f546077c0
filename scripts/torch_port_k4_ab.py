#!/usr/bin/env python3
"""K4 (the flash-attention forward) against its parent version, and K4b
(the trainable route's backward) by kernel, on one NVIDIA GPU.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_port_k4_ab.py --parent build/parent

0. The register question: this tree's one-pass dK/dV kernel (256 threads)
   and the same pass in the 384-thread shape with setmaxnreg (made by
   editing a copy of this tree's source), built as the port builds them;
   ptxas's registers and spills, and from the SASS the setmaxnreg requests
   and the highest register and the spill instructions past the
   consumers' request.
1. K4's no-grad forward: the parent tree's library and this tree's, both
   called through their C entry point with the same arguments (this
   tree's with no log-sum-exp), at llama3.2-3b's prefill shape (B=1,
   S=8,192, 24/8 heads, D=128, causal) and mixtral's (32/8, window 4,096),
   bf16: outputs bitwise equal; the bf16 kernels' SASS compared
   instruction by instruction (immediates and constant-bank offsets
   masked: the parameter block grew by one pointer); CUDA-event times in
   turns parent, this, this, parent; then this tree's wrapper
   (``flash_attention``), whose host work ``chip_smoke.py``'s flash.time
   includes (each time starts from an idle card).
2. K4b at llama3.2-3b's training shape (B=1, S=4,096, 24/8, D=128, bf16),
   the parent tree's kernels against this tree's, both through this
   tree's wrapper (``flash_attention_bwd``) on the same inputs: each one's
   relative L2 error against the chunked vjp, whether two calls are
   bitwise equal, its launches' device times under ``torch.profiler``;
   then CUDA-event times (median, min and max of 30 calls) in turns
   parent, this, this, parent, twice; then design (b) of its dQ (summed
   in the dK/dV kernel in kv tile order, made by editing a copy of this
   tree's source, measured and not kept) in turns this, b, b, this.
3. ``flash_attention`` as ``chip_smoke.py``'s flash.time calls it, each
   tree's wrapper and library in a fresh process of its own, in turns
   parent, this, this, parent, at the two shapes of 1.
4. ``kernels``: every kernel of this tree's two libraries as ptxas built
   it (registers, spill bytes, static shared memory) and its HGMMA count
   in the SASS; ``sass``: every bf16 kernel (and the bf16 plan and delta
   pre-pass) of both libraries against the parent's, instruction by
   instruction, immediates and constant-bank offsets masked.
5. ``f32``: the float32 routes, the parent's kernels against this tree's
   (the parent's scalar-FMA kernels, this tree's split-TF32 wgmma), both
   through this tree's wrappers on the same inputs at llama3.2-3b's shapes
   (24/8 heads, D=128, causal): K4 at S=4,096 and 8,192 and K4b and the
   trainable route (fwd+bwd) at 4,096.  Each one's error against the plain
   version, its device time by launch under ``torch.profiler``, then
   CUDA-event medians with min and max in turns parent, this, this,
   parent.

The parent's sources are built against the parent's own shared headers
(``--parent``/src/repro_torch/kernels/csrc first on nvcc's include path).
``--parts`` picks the parts (default: all).  Prints ``nvidia-smi``'s name
and power limit first; needs ``nvcc`` and ``cuobjdump`` (as chip_smoke.py
does).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FA_CSRC = Path("src/repro_torch/kernels/flash_attention/csrc")
SHARED_CSRC = Path("src/repro_torch/kernels/csrc")
PARTS = ("registers", "k4", "k4b", "wrapper", "kernels", "sass", "f32")


def parent_flags(parent_root: Path) -> tuple:
    """nvcc flags that build a parent tree's source against its own shared
    headers (ahead of this tree's on the include path)."""
    from repro_torch.kernels import NVCC_FLAGS

    return (*NVCC_FLAGS, "-I", str(Path(parent_root).resolve() / SHARED_CSRC))


def time_ms(fn, n: int = 30) -> float:
    import torch

    for _ in range(3):
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
    return times[n // 2]


def sass_function(library: Path, pattern: str) -> list:
    """The instructions of the kernel whose mangled name matches
    ``pattern``, immediates and constant-bank offsets masked."""
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        if re.search(pattern, block.split("\n", 1)[0]):
            return [re.sub(r"0x[0-9a-f]+", "X", ins.strip())
                    for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)]
    raise LookupError(f"no kernel matching {pattern} in {library}")


def forward_entry(lib, with_lse: bool):
    """``flash_attention_fwd`` of a K4 library with its argument types: the
    parent's takes no log-sum-exp pointer."""
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (8 if with_lse else 7) + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def k4_parent_vs_this(parent_source: Path, flags: tuple) -> None:
    import torch

    from repro_torch.kernels import library_path, load_library
    from repro_torch.kernels.flash_attention import ops

    parent_lse = "void* lse" in parent_source.read_text()
    entries = {"parent": forward_entry(load_library(parent_source, flags=flags), parent_lse),
               "this": forward_entry(load_library(ops.SOURCE), True)}
    has_lse = {"parent": parent_lse, "this": True}
    for dp in (128, 64):
        a = sass_function(library_path(parent_source, flags),
                          rf"flash_fwd_bf16ILi{dp}E(?:Lb0E)?E")
        b = sass_function(library_path(ops.SOURCE), rf"flash_fwd_bf16ILi{dp}ELb0EE")
        print("[k4.sass] " + json.dumps(dict(dp=dp, parent=len(a), this=len(b),
                                             equal=a == b)), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for s, hq, window in ((8192, 24, None), (8192, 32, 4096)):
        q = torch.randn(1, s, hq, 128, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(1, s, 8, 128, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        pos = torch.arange(s, dtype=torch.int32, device="cuda")

        def call(tree):
            out = torch.empty_like(q)
            bounds = torch.empty(4 * (-(-s // 128)), dtype=torch.int32, device="cuda")
            lse = [None] if has_lse[tree] else []
            strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
            err = entries[tree](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse,
                                pos.data_ptr(), pos.data_ptr(), bounds.data_ptr(), 1, s, s, hq,
                                8, 128, *strides, window or 0, 1.0 / 128 ** 0.5, 1,
                                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return out

        def wrapper():
            return ops.flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                       window=window)

        bitwise = torch.equal(call("parent"), call("this")) and torch.equal(call("this"),
                                                                             wrapper())
        turns = [("parent", time_ms(lambda: call("parent"))),
                 ("this", time_ms(lambda: call("this"))),
                 ("this", time_ms(lambda: call("this"))),
                 ("parent", time_ms(lambda: call("parent"))),
                 ("this_wrapper", time_ms(wrapper))]
        print("[k4.ab] " + json.dumps(dict(seq=s, heads=f"{hq}/8", window=window,
                                           bitwise=bitwise, ms=turns)), flush=True)


def one_pass_384(text: str) -> str:
    """This tree's K4b source with its dK/dV kernel in the 384-thread shape
    instead: a producer warpgroup (setmaxnreg.dec 24, its first thread
    walking the steps) and the same two consumer warpgroups (setmaxnreg.inc
    240), the one pass unchanged."""
    head = "    if (threadIdx.x == 0) {\n      while (pw.hl < g && issued < S + step) {\n"
    start = text.index(head)
    end = text.index("    const int q0 = w.qb * kBQ + w.half * kQStep;", start)
    body = text[start + len(head):end]
    assert body.endswith("      }\n    }\n")
    producer = "      while (pw.hl < g) {\n" + body[:-len("    }\n")]
    text = text[:start] + text[end:]
    edits = (
        ("__global__ void __launch_bounds__(kBwdThreads, 1)\nflash_bwd_dkdv_bf16(",
         "__global__ void __launch_bounds__(384, 1)\nflash_bwd_dkdv_bf16("),
        ("  if (threadIdx.x == 0) {\n    mbar_expect_tx(kv_full, 2 * L::kKVBytes);\n",
         "  if (threadIdx.x < 128) {\n"
         "  asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\" ::: \"memory\");\n"
         "  if (threadIdx.x == 0) {\n    mbar_expect_tx(kv_full, 2 * L::kKVBytes);\n"),
        ("      tma_load_4d(base + L::kKVBytes + c * kBox128, &tv, kv_full, c * kBoxCols, hk, k0, b);\n"
         "    }\n  }\n\n  const int cw = threadIdx.x >> 7;\n",
         "      tma_load_4d(base + L::kKVBytes + c * kBox128, &tv, kv_full, c * kBoxCols, hk, k0, b);\n"
         "    }\n" + producer + "  }\n  } else {\n"
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\" ::: \"memory\");\n"
         "  const int cw = (threadIdx.x >> 7) - 1;\n"),
        ("          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);\n    }\n  }\n}\n",
         "          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);\n    }\n  }\n  }\n}\n"),
        ("flash_bwd_dkdv_bf16<DP><<<(unsigned)dkdv_ctas, kBwdThreads,",
         "flash_bwd_dkdv_bf16<DP><<<(unsigned)dkdv_ctas, 384,"),
    )
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def register_report(out_dir: Path) -> None:
    """The register question: this tree's one-pass dK/dV kernel (256
    threads, no setmaxnreg) and the same pass in the 384-thread shape
    (``one_pass_384``), each built as ``load_library`` builds it.  Per bf16
    kernel: ptxas's registers and spill bytes; from the SASS the setmaxnreg
    requests (USETMAXREG), and over the code after the consumers' request
    (the whole kernel without one) the highest register touched and the
    local-memory spill instructions (STL, LDL)."""
    from repro_torch.kernels import nvcc_build
    from repro_torch.kernels.flash_attention import ops

    out_dir.mkdir(parents=True, exist_ok=True)
    variant = out_dir / "flash_attention_bwd_384.cu"
    variant.write_text(one_pass_384(ops.BWD_SOURCE.read_text()))
    report = {}
    for name, source in (("this_256", ops.BWD_SOURCE), ("one_pass_384", variant)):
        library = out_dir / f"{name}.so"
        ptxas = nvcc_build(source, library)
        kernels, notes, current = {}, {}, None
        for line in ptxas.splitlines():
            m = re.search(r"\((C75\d+)\).*function '(\S+)'", line)
            if m:  # ptxas's performance notes name their function
                notes.setdefault(m.group(2), []).append(m.group(1))
                continue
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1) if "bf16" in m.group(1) else None
                if current:
                    kernels[current] = {}
            elif current:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    kernels[current]["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    kernels[current]["ptxas_registers"] = int(m.group(1))
        for kernel in kernels:
            kernels[kernel]["ptxas_notes"] = notes.get(kernel, [])
        sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                               "-sass", str(library)], capture_output=True, text=True,
                              check=True).stdout
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            fname = block.split("\n", 1)[0].strip()
            if fname not in kernels:
                continue
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)
            up = [i for i, s in enumerate(ins) if "USETMAXREG.TRY_ALLOC" in s]
            down = [i for i, s in enumerate(ins) if "USETMAXREG.DEALLOC" in s]
            lo = up[0] if up else 0
            hi = down[0] if down and down[0] > lo else len(ins)
            region = ins[lo:hi]
            regs = [int(r) for s in region for r in re.findall(r"\bR(\d+)\b", s)]
            kernels[fname].update(
                usetmaxreg=[s.strip() for s in ins if "USETMAXREG" in s],
                consumer_max_register=max(regs) if regs else None,
                consumer_stl=sum(bool(re.search(r"\bSTL\b", s)) for s in region),
                consumer_ldl=sum(bool(re.search(r"\bLDL\b", s)) for s in region))
        report[name] = {re.search(r"flash_bwd_\w+?_bf16I\w*?E", k).group(0): v
                        for k, v in kernels.items()}
    print("[k4b.registers] " + json.dumps(report), flush=True)


# Design (b) of K4b's dQ, derived from this tree's source: no dQ kernel;
# the dK/dV kernel writes each step's dS^T (bf16) to shared memory, forms
# the step's dQ rows (dS K, wgmma with both operands MN-major) and adds
# them into an f32 workspace [B, Hq, Sq_pad, D] in kv tile order (a
# counter per (b, h, 64-row step, column half), waited on with an acquire
# load, raised with a release add); a small kernel rounds the workspace to
# bf16.  The workspace and counters follow the rows scratch, zeroed by
# cudaMemsetAsync.  Measured, not kept: the design (a) kernels are faster.
DESIGN_B_EDITS = (
    ("""  float* lse2;
  int Sq_pad;
};""",
     """  float* lse2;
  int Sq_pad;
  // bf16: dQ before the scale, f32 [B, Hq, Sq_pad, D], zeroed, summed by
  // the dK/dV kernel in kv tile order; a counter per (b, h, 64-row q step,
  // column half) of the additions made so far.
  float* dq_acc;
  int* dq_sem;
};"""),
    ("""  static constexpr int kRowsOffset = kStageOffset + 2 * kDkdvStages * kStepBytes;
  static constexpr int kBarOffset = kRowsOffset + kDkdvStages * 2 * kRowBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kDkdvStages) + 1024;
};""",
     """  static constexpr int kDsBytes = kBKV * kQStep * 2;
  static constexpr int kDsOffset = kStageOffset + 2 * kDkdvStages * kStepBytes;  // 1024-aligned
  static constexpr int kRowsOffset = kDsOffset + 2 * kDsBytes;
  static constexpr int kBarOffset = kRowsOffset + kDkdvStages * 2 * kRowBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kDkdvStages) + 1024;
};

// d (+)= A B over 64 x 64 x 16, A and B both MN-major in shared memory
// (both transpose flags set).
__device__ __forceinline__ void wgmma_tt_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 1, 1;\\n}\\n"
      : WG_F32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\\n" ::"l"(p), "r"(v) : "memory");
}

// The kv tiles before `kt` that the plan keeps against q block `qb`: the
// additions to its rows of dq_acc that come before this tile's.
__device__ __forceinline__ int tiles_before(const BwdParams& p, int kt, int qb) {
  const int qmin = p.q_bounds[2 * qb], qmax = p.q_bounds[2 * qb + 1];
  int n = 0;
  for (int t = 0; t < kt; ++t)
    n += tile_kind(p.kv_bounds[2 * t], p.kv_bounds[2 * t + 1], true, qmin, qmax, p.window) != 0;
  return n;
}"""),
    ("""  const uint32_t kv_full = base + L::kBarOffset;
  const uint32_t full0 = kv_full + 8, empty0 = kv_full + 8 * (1 + S);

  const int BH = p.B * p.Hkv;
  const int kt = (int)(blockIdx.x / (unsigned)BH);  // kv tile 0 first: the most q blocks""",
     """  const uint32_t kv_full = base + L::kBarOffset;
  const uint32_t full0 = kv_full + 8, empty0 = kv_full + 8 * (1 + S);
  uint8_t* const ds_buf = smem_raw + (base - raw) + L::kDsOffset;

  const int BH = p.B * p.Hkv;
  const int kt = (int)(blockIdx.x / (unsigned)BH);  // kv tile 0 first: the most q blocks"""),
    ("""  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; w.hl < g; ++step) {""",
     """  mbar_wait(kv_full, 0);
  int stage = 0, before = 0;
  uint32_t phase = 0;
  // dQ: for D <= 64 warpgroup 0 takes all columns.
  const bool dq_wg = DP == 128 || cw == 0;
  float dqp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqp[i] = 0.f;
  for (int step = 0; w.hl < g; ++step) {"""),
    ("""    const int q0 = w.qb * kBQ + w.half * kQStep;
    const bool masked = w.kind != 2;""",
     """    const int q0 = w.qb * kBQ + w.half * kQStep;
    const bool masked = w.kind != 2;
    if (w.half == 0) before = tiles_before(p, kt, w.qb);"""),
    ("""    wgmma_rs_k64(dv, pa, do_addr, kBox64);
    wgmma_rs_k64(dk, da, q_addr, kBox64);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);""",
     """    wgmma_rs_k64(dv, pa, do_addr, kBox64);
    wgmma_rs_k64(dk, da, q_addr, kBox64);
    wgmma_commit();
    // dS^T (bf16) into this step's buffer, rows = the tile's 128 keys, 64
    // q columns a 128-byte row, 128-byte swizzle (chunk j at j ^ (row & 7)).
    uint8_t* const ds = ds_buf + (step & 1) * L::kDsBytes;
    const uint32_t ds_addr = smem_u32(ds);
    {
      const int R0 = 64 * cw + 16 * warp + g8, R1 = R0 + 8;
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        const int j0 = 2 * kk, j1 = 2 * kk + 1;
        *reinterpret_cast<uint32_t*>(ds + R0 * 128 + ((j0 ^ (R0 & 7)) << 4) + 4 * t4) = da[kk][0];
        *reinterpret_cast<uint32_t*>(ds + R1 * 128 + ((j0 ^ (R1 & 7)) << 4) + 4 * t4) = da[kk][1];
        *reinterpret_cast<uint32_t*>(ds + R0 * 128 + ((j1 ^ (R0 & 7)) << 4) + 4 * t4) = da[kk][2];
        *reinterpret_cast<uint32_t*>(ds + R1 * 128 + ((j1 ^ (R1 & 7)) << 4) + 4 * t4) = da[kk][3];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    named_barrier(1, kBwdThreads);
    // dQ (64 q rows x 64 columns of this warpgroup) = dS K over the 128
    // keys: dS^T read MN-major as A, K MN-major as B (box cw).
    if (dq_wg) {
      reg_fence(dqp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        wgmma_tt_n64(dqp, smem_desc(ds_addr + kk * 2048, kBox64, 1024),
                     smem_desc(base + cw * kBox128 + kk * 2048, kBox128, 1024), kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    if (dq_wg) {
      reg_fence(dqp);
      const int h = hk * g + w.hl;
      int* sem = p.dq_sem + (pad_row_base(p, b, h) / kQStep + q0 / kQStep) * 2 + cw;
      if (tid == 0) {
        long long start = -1;
        while (load_acquire(sem) < before) {
          const long long now = clock64();
          if (start < 0) start = now;
          if (now - start > 20000000000LL) __trap();
        }
      }
      named_barrier(2 + cw, 128);
      float* acc = p.dq_acc + (pad_row_base(p, b, h) + q0 + 16 * warp + g8) * p.D + 64 * cw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (64 * cw + col < p.D) {
          atomicAdd(acc + col, dqp[4 * j]);
          atomicAdd(acc + col + 1, dqp[4 * j + 1]);
          atomicAdd(acc + 8 * p.D + col, dqp[4 * j + 2]);
          atomicAdd(acc + 8 * p.D + col + 1, dqp[4 * j + 3]);
        }
      }
      named_barrier(2 + cw, 128);
      if (tid == 0) add_release(sem, 1);
    }"""),
    ("""// -------------------------------- f32 -----------------------------------""",
     """// dq = bf16(dq_acc * scale): a warp a row (b, s, h), s < Sq.
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_dq_round(const BwdParams p) {
  const long long row = (long long)blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  if (row >= (long long)p.B * p.Sq * p.Hq) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(row % p.Hq);
  const int s = (int)((row / p.Hq) % p.Sq);
  const int b = (int)(row / ((long long)p.Hq * p.Sq));
  const float* src = p.dq_acc + (pad_row_base(p, b, h) + s) * p.D;
  __nv_bfloat16* dst = (__nv_bfloat16*)p.dq + (long long)b * p.dq_sb + (long long)s * p.dq_ss +
                       (long long)h * p.dq_sh;
  for (int d = lane; d < p.D; d += 32) dst[d] = __float2bfloat16(src[d] * p.scale);
}

// -------------------------------- f32 -----------------------------------"""),
    ("""  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DqSmem<DP>::kBytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_bf16<DP><<<(unsigned)dq_ctas, kBwdThreads, DqSmem<DP>::kBytes, stream>>>(
      tq128, tdo128, tk, tv, bp);
  return (int)cudaGetLastError();""",
     """  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)p.B * p.Sq * p.Hq;
  flash_bwd_dq_round<<<(unsigned)((rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32)),
                       kDeltaThreads, 0, stream>>>(bp);
  return (int)cudaGetLastError();"""),
    ("""  err = launch_plan(p.qpos, p.kpos, p.Sq, p.Sk, bounds, stream);
  if (!err) err = launch_delta<true>(p, stream);""",
     """  err = launch_plan(p.qpos, p.kpos, p.Sq, p.Sk, bounds, stream);
  if (!err) err = launch_delta<true>(p, stream);
  if (!err)
    err = (int)cudaMemsetAsync(p.dq_acc, 0,
                               4 * (size_t)p.B * p.Hq * p.Sq_pad * p.D +
                                   4 * (size_t)p.B * p.Hq * (p.Sq_pad / kQStep) * 2,
                               stream);"""),
    ("""    p.Sq_pad = n_tiles(Sq) * kBQ;
    p.lse2 = (float*)delta;
    p.delta = p.lse2 + (long long)B * Hq * p.Sq_pad;""",
     """    p.Sq_pad = n_tiles(Sq) * kBQ;
    p.lse2 = (float*)delta;
    p.delta = p.lse2 + (long long)B * Hq * p.Sq_pad;
    p.dq_acc = p.delta + (long long)B * Hq * p.Sq_pad;
    p.dq_sem = (int*)(p.dq_acc + (long long)B * Hq * p.Sq_pad * D);"""),
)


def design_b_scratch(b: int, sq: int, hq: int, dtype) -> int:
    """The rows scratch design (b) needs at D <= 128: lse2 and delta, the
    f32 workspace and the counters."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    if dtype != torch.bfloat16:
        return ops.bwd_rows_scratch(b, sq, hq, dtype)
    sq_pad = -(-sq // ops.Q_BLOCK_BF16) * ops.Q_BLOCK_BF16
    return 2 * b * hq * sq_pad + b * hq * sq_pad * 128 + b * hq * (sq_pad // 64) * 2


def time_spread(fn, n: int = 30) -> dict:
    """CUDA-event ms of ``n`` calls after 3 warm-ups: median, min, max."""
    import torch

    for _ in range(3):
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
    return dict(median=times[n // 2], min=times[0], max=times[-1])


def launch_split(fn, n: int = 10) -> dict:
    """{kernel: device ms a call} of ``fn``'s launches under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        m = re.search(r"(flash_\w+|Memset)(<[^>(]*>)?", e.key)
        if t and m:
            split[m.group(1) + (m.group(2) or "")] = t / n / 1e3
    return split


def k4b_parent_vs_this(parent_source: Path, out_dir: Path, flags: tuple) -> None:
    import functools

    import torch

    from repro_torch.kernels import load_library

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import chunked_vjp

    g = torch.Generator(device="cuda").manual_seed(11)
    q, dout = (torch.randn(1, 4096, 24, 128, generator=g, device="cuda").bfloat16()
               for _ in range(2))
    k, v = (torch.randn(1, 4096, 8, 128, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    pos = torch.arange(4096, dtype=torch.int32, device="cuda")
    out, lse = ops._kernel_forward(q, k, v, pos, pos, None, with_lse=True)
    want = chunked_vjp(q, k, v, dout, q_positions=pos, kv_positions=pos, window=None,
                       q_chunk=512, kv_chunk=1024)

    def bwd():
        return ops.flash_attention_bwd(q, k, v, out, dout, lse, q_positions=pos,
                                       kv_positions=pos)

    text = ops.BWD_SOURCE.read_text()
    for old, new in DESIGN_B_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"parent": parent_source, "this": ops.BWD_SOURCE,
               "design_b": out_dir / "flash_attention_bwd_design_b.cu"}
    sources["design_b"].write_text(text)
    plain_scratch = ops.bwd_rows_scratch

    def use(name):
        # The parent's kernels read the first B * Hq * Sq values of the rows
        # scratch: this tree's wrapper serves both.
        ops.BWD_SOURCE = sources[name]
        ops.load_library = (functools.partial(load_library, flags=flags) if name == "parent"
                            else load_library)
        ops._bwd_library.cache_clear()
        ops.bwd_rows_scratch = design_b_scratch if name == "design_b" else plain_scratch

    checks = {}
    for name in sources:
        use(name)
        got, again = bwd(), bwd()
        num = sum((a.double() - w.double()).square().sum() for a, w in zip(got, want))
        rel = (num / sum(w.double().square().sum() for w in want)).sqrt().item()
        checks[name] = dict(rel_l2_vs_chunked_vjp=rel,
                            rerun_bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
                            device_ms_by_launch=launch_split(bwd))
    print("[k4b.check] " + json.dumps(checks), flush=True)
    turns = []
    for name in ("parent", "this", "this", "parent") * 2:
        use(name)
        turns.append((name, time_spread(bwd)))
    for name in ("this", "design_b", "design_b", "this"):
        use(name)
        turns.append((name, time_spread(bwd)))
    use("this")
    medians = {name: sorted(t["median"] for n, t in turns if n == name) for name in sources}
    print("[k4b.ab] " + json.dumps(dict(turns=turns, medians=medians)), flush=True)


def sass_functions(library: Path) -> dict:
    """{kernel: masked instructions} of every kernel in ``library``, keyed
    by its mangled name past the anonymous namespace (whose tag differs
    from build to build)."""
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.search(r"\d+(flash_\w+)$", name)
        out[m.group(1) if m else name] = [
            re.sub(r"0x[0-9a-f]+", "X", ins.strip())
            for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)]
    return out


def kernel_report() -> None:
    """Every kernel of this tree's K4 and K4b libraries: ptxas's registers,
    spill bytes and static shared memory (``chip_smoke._ptxas_kernels``,
    from a fresh build) and the HGMMA instructions in its SASS."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import nvcc_build
    from repro_torch.kernels.flash_attention import ops

    for source in (ops.SOURCE, ops.BWD_SOURCE):
        out = ROOT / "build" / "k4_ab" / f"{source.stem}_report.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        kernels = chip_smoke._ptxas_kernels(nvcc_build(source, out))
        hgmma = {name: sum("HGMMA" in ins for ins in body)
                 for name, body in sass_functions(out).items()}
        print("[k4.kernels] " + json.dumps(dict(source=source.name, ptxas=kernels,
                                                hgmma=hgmma)), flush=True)


def sass_vs_parent(fwd_parent: Path, bwd_parent: Path, flags: tuple) -> None:
    """The bf16 kernels of both libraries (and the bf16 route's plan and
    delta pre-pass) against the parent's build, instruction by instruction."""
    from repro_torch.kernels import library_path, load_library
    from repro_torch.kernels.flash_attention import ops

    for parent, this in ((fwd_parent, ops.SOURCE), (bwd_parent, ops.BWD_SOURCE)):
        load_library(parent, flags=flags)
        load_library(this)
        a, b = sass_functions(library_path(parent, flags)), sass_functions(library_path(this))
        bf16 = sorted(n for n in a if "bf16" in n or n.startswith("flash_planE")
                      or n.startswith("flash_bwd_deltaILb1E"))
        print("[k4.sass] " + json.dumps(dict(
            source=this.name, kernels={n: dict(parent=len(a[n]), this=len(b.get(n, [])),
                                               equal=a[n] == b.get(n)) for n in bf16},
            all_equal=all(a[n] == b.get(n) for n in bf16))), flush=True)


def f32_parent_vs_this(fwd_parent: Path, bwd_parent: Path, flags: tuple) -> None:
    """Part 5: the float32 routes, the parent's kernels against this tree's
    through this tree's wrappers (the parent's C entries take the same
    arguments and ignore the scratch this tree's f32 route adds)."""
    import functools

    import torch

    from repro_torch.kernels import load_library
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.attention import chunked_vjp

    sources = {"parent": (fwd_parent, bwd_parent), "this": (ops.SOURCE, ops.BWD_SOURCE)}

    def use(name):
        ops.SOURCE, ops.BWD_SOURCE = sources[name]
        ops.load_library = (functools.partial(load_library, flags=flags) if name == "parent"
                            else load_library)
        ops._library.cache_clear()
        ops._bwd_library.cache_clear()

    def turns(fn, n=10):
        out = []
        for name in ("parent", "this", "this", "parent"):
            use(name)
            out.append((name, time_spread(fn, n)))
        return out

    g = torch.Generator(device="cuda").manual_seed(28)
    for s in (4096, 8192):
        q = torch.randn(1, s, 24, 128, generator=g, device="cuda")
        k, v = (torch.randn(1, s, 8, 128, generator=g, device="cuda") for _ in range(2))
        pos = torch.arange(s, dtype=torch.int32, device="cuda")

        def fwd():
            return ops.flash_attention(q, k, v, q_positions=pos, kv_positions=pos)

        checks = {}
        if s == 4096:
            want = flash_attention_ref(q, k, v, pos, pos).double()
            for name in sources:
                use(name)
                got = fwd().double()
                row = (got - want).norm(dim=-1) / want.norm(dim=-1)
                checks[name] = dict(max_abs_err=(got - want).abs().max().item(),
                                    max_row_rel_err=row.max().item(),
                                    rows_past_1e_5=int((row > 1e-5).sum()),
                                    device_ms_by_launch=launch_split(fwd))
            del want
        else:
            for name in sources:
                use(name)
                checks[name] = dict(device_ms_by_launch=launch_split(fwd))
        print("[f32.k4] " + json.dumps(dict(seq=s, checks=checks, turns=turns(fwd))),
              flush=True)
        del q, k, v
    torch.cuda.empty_cache()

    q, dout = (torch.randn(1, 4096, 24, 128, generator=g, device="cuda") for _ in range(2))
    k, v = (torch.randn(1, 4096, 8, 128, generator=g, device="cuda") for _ in range(2))
    pos = torch.arange(4096, dtype=torch.int32, device="cuda")
    want = chunked_vjp(q, k, v, dout, q_positions=pos, kv_positions=pos, window=None,
                       q_chunk=512, kv_chunk=1024)
    use("this")
    out, lse = ops._kernel_forward(q, k, v, pos, pos, None, with_lse=True)

    def bwd():
        return ops.flash_attention_bwd(q, k, v, out, dout, lse, q_positions=pos,
                                       kv_positions=pos)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def route():
        return torch.autograd.grad(ops.flash_attention_trainable(
            *leaves, q_positions=pos, kv_positions=pos), leaves, dout)

    checks = {}
    for name in sources:
        use(name)
        got, again = bwd(), bwd()
        num = sum((a.double() - w.double()).square().sum() for a, w in zip(got, want))
        rel = (num / sum(w.double().square().sum() for w in want)).sqrt().item()
        checks[name] = dict(rel_l2_vs_chunked_vjp=rel,
                            rerun_bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
                            device_ms_by_launch=launch_split(bwd))
    print("[f32.k4b] " + json.dumps(dict(checks=checks, turns=turns(bwd))), flush=True)
    print("[f32.route] " + json.dumps(dict(turns=turns(route, n=5))), flush=True)
    use("this")


WRAPPER_TIMING = r"""
import json, torch
from repro_torch.kernels.flash_attention.ops import flash_attention

def time_ms(fn, n=30):
    for _ in range(3):
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
    return times[n // 2]

g = torch.Generator(device="cuda").manual_seed(0)
ms = {}
for s, hq, window in ((8192, 24, None), (8192, 32, 4096)):
    q = torch.randn(1, s, hq, 128, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(1, s, 8, 128, generator=g, device="cuda").bfloat16() for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    ms[f"{hq}/8 window {window}"] = time_ms(lambda: flash_attention(
        q, k, v, q_positions=pos, kv_positions=pos, window=window))
print(json.dumps(ms))
"""


def wrapper_turns(parent_root: Path) -> None:
    trees = {"parent": parent_root, "this": ROOT}
    turns = []
    for name in ("parent", "this", "this", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[name] / "src"))
        proc = subprocess.run([sys.executable, "-c", WRAPPER_TIMING], env=env,
                              cwd=trees[name], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} child failed:\n{proc.stderr[-3000:]}")
        turns.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
    print("[k4.wrapper_ab] " + json.dumps(dict(ms=turns)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the parent commit (git archive)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k4_ab")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated parts to run, of {', '.join(PARTS)}")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    import torch

    if not torch.cuda.is_available():
        print("torch_port_k4_ab: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    flags = parent_flags(args.parent)
    fwd_parent = args.parent / FA_CSRC / "flash_attention.cu"
    bwd_parent = args.parent / FA_CSRC / "flash_attention_bwd.cu"
    if "registers" in parts:
        register_report(args.out)
    if "kernels" in parts:
        kernel_report()
    if "sass" in parts:
        sass_vs_parent(fwd_parent, bwd_parent, flags)
    if "k4" in parts:
        k4_parent_vs_this(fwd_parent, flags)
    if "k4b" in parts:
        k4b_parent_vs_this(bwd_parent, args.out, flags)
    if "wrapper" in parts:
        wrapper_turns(args.parent.resolve())
    if "f32" in parts:
        f32_parent_vs_this(fwd_parent, bwd_parent, flags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
