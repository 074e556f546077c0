#!/usr/bin/env python3
"""K4 (the flash-attention forward) against its parent version, and K4b
(the trainable route's backward) by kernel, on one NVIDIA GPU.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_port_k4_ab.py --parent build/parent

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
2. K4b at llama3.2-3b's training shape (B=1, S=4,096, 24/8, D=128, bf16):
   its launches' device times under ``torch.profiler`` (delta, the dV and
   dK passes, dQ); then the two dK/dV passes against one launch that takes
   both passes' CTAs (``merged``, made by editing a copy of this tree's
   source), in turns, each with its relative L2 error against the chunked
   vjp.
3. ``flash_attention`` as ``chip_smoke.py``'s flash.time calls it, each
   tree's wrapper and library in a fresh process of its own, in turns
   parent, this, this, parent, at the two shapes of 1.

Prints ``nvidia-smi``'s name and power limit first; needs ``nvcc`` and
``cuobjdump`` (as chip_smoke.py does).
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


def k4_parent_vs_this(parent_source: Path) -> None:
    import torch

    from repro_torch.kernels import library_path, load_library
    from repro_torch.kernels.flash_attention import ops

    parent_lse = "void* lse" in parent_source.read_text()
    entries = {"parent": forward_entry(load_library(parent_source), parent_lse),
               "this": forward_entry(load_library(ops.SOURCE), True)}
    has_lse = {"parent": parent_lse, "this": True}
    for dp in (128, 64):
        a = sass_function(library_path(parent_source),
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


MERGE_EDITS = (
    ("template <int DP, bool DK>\n__global__ void __launch_bounds__(kBwdThreads, 1)\n"
     "flash_bwd_dkdv_bf16(",
     "template <int DP>\n__global__ void __launch_bounds__(kBwdThreads, 1)\n"
     "flash_bwd_dkdv_bf16("),
    ("  const int kt = (int)(blockIdx.x / (unsigned)BH);\n"
     "  const int bh = (int)(blockIdx.x % (unsigned)BH);\n"
     "  const int b = bh / p.Hkv, hk = bh % p.Hkv;",
     "  const bool DK = blockIdx.x & 1;\n"
     "  const int kt = (int)((blockIdx.x >> 1) / (unsigned)BH);\n"
     "  const int bh = (int)((blockIdx.x >> 1) % (unsigned)BH);\n"
     "  const int b = bh / p.Hkv, hk = bh % p.Hkv;"),
    ("template <int DP, bool DK>\nint launch_dkdv(", "template <int DP>\nint launch_dkdv("),
    ("flash_bwd_dkdv_bf16<DP, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize",
     "flash_bwd_dkdv_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize"),
    ("flash_bwd_dkdv_bf16<DP, DK><<<ctas,", "flash_bwd_dkdv_bf16<DP><<<2 * ctas,"),
    ("  err = launch_dkdv<DP, false>(tq64, tdo64, tk, tv, bp, (unsigned)dkdv_ctas, stream);\n"
     "  if (!err) err = launch_dkdv<DP, true>(tq64, tdo64, tk, tv, bp, (unsigned)dkdv_ctas, "
     "stream);",
     "  err = launch_dkdv<DP>(tq64, tdo64, tk, tv, bp, (unsigned)dkdv_ctas, stream);"),
)


def k4b_kernels(out_dir: Path) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

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

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            bwd()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        m = re.search(r"(flash_\w+)(<[^>(]*>)?", e.key)
        if t and m:
            split[m.group(1) + (m.group(2) or "")] = t / e.count / 1e3
    print("[k4b.split] " + json.dumps(dict(ms_per_launch=split)), flush=True)

    text = ops.BWD_SOURCE.read_text()
    for old, new in MERGE_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    merged = out_dir / "flash_attention_bwd_merged.cu"
    merged.write_text(text)
    sources = {"two_launches": ops.BWD_SOURCE, "merged": merged}
    turns = []
    for name in ("two_launches", "merged", "merged", "two_launches"):
        ops.BWD_SOURCE = sources[name]
        ops._bwd_library.cache_clear()
        ms = time_ms(bwd)
        got = bwd()
        num = sum((a.double() - w.double()).square().sum() for a, w in zip(got, want))
        rel = (num / sum(w.double().square().sum() for w in want)).sqrt().item()
        turns.append((name, ms, rel))
    ops.BWD_SOURCE = sources["two_launches"]
    ops._bwd_library.cache_clear()
    print("[k4b.ab] " + json.dumps(dict(ms_rel_l2=turns)), flush=True)


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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_k4_ab: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    k4_parent_vs_this(args.parent / FA_CSRC / "flash_attention.cu")
    k4b_kernels(args.out)
    wrapper_turns(args.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
