"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from the start of this script): the cell's
graph is drawn on the card from ``--seed``; the port's kernels load from
the cache of built kernels at ``build/repro_torch/`` in this checkout (the
first run there builds them); the cell's own query runs twice to warm up.
Then one caller sends the query in a closed loop (the next when the answer
is on the host) for ``--seconds``.  With ``--trace 1`` the window runs
under ``torch.profiler`` and the per-layer metrics are read from the trace
and the port's counters; with ``--trace 0`` the end-to-end ones from the
host clock and the allocator.  After the window the port's state is freed,
the graph is drawn again and the plain reference (``reference.py``) peels
it; every answer of the window is compared with it (``check.py``).

The last line of standard output is the result as JSON; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key.  Exits 3 without a card (or with fewer than the cell
asks for), 4 if JAX or the JAX package was loaded, and prints no result
then.  ``--control bfloat16`` puts the reference, in bfloat16, in the
program's place: its answers must come out not correct.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Build and kernel caches of the run live at fixed paths in the checkout.
BUILD = ROOT / "build"
KERNEL_CACHE = BUILD / "repro_torch"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    traffic: Dict[str, Any]
    setup_s: float
    walls: List[float]  # each query's seconds, host clock
    window_s: float  # window start to the last answer, host clock
    peak_bytes: Optional[int]  # allocator peak over the window
    host_syncs: int  # repro_torch.hostsync.read.count over the window
    trace: Any  # trace.Summary of the traced window, or None
    work: List[List[tuple]]  # reference replay: (|E(S)|, |S|) a pass, a lane


def pin_cores() -> List[int]:
    """Binds this process to four of its usable cores, the third to the
    sixth where there are six or more, before torch is imported, so that
    every thread it starts and its count of CPU threads follow.  The host
    sets the pace of the port's loop, and an unpinned process wanders over
    cores that other work shares: on the card, three runs of the sweep
    read ``query_ms`` 15.98-16.00 ms pinned so, 15.99-16.36 unpinned and
    16.17-16.30 on two cores, interleaved in one call (PERF.md).  Acts on
    this process alone."""
    usable = sorted(os.sched_getaffinity(0))
    cores = usable[2:6] if len(usable) >= 6 else usable
    os.sched_setaffinity(0, cores)
    return cores


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def generator(config: Dict[str, Any]):
    """``generators/<config['generator']>.py``."""
    from portbench.spec import load_module

    return load_module(HERE / "generators" / f"{config['generator']}.py",
                       f"portbench_gen_{config['generator']}")


def _smi() -> str:
    fields = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def environment_lines() -> List[str]:
    import torch

    import platform

    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip().lower() in ("model name", "cpu model", "model", "hardware"):
                    model = value.strip()
                    if key.strip().lower() == "model name":
                        break
    except OSError:
        pass
    model = model or platform.processor() or platform.machine()
    affinity = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else None
    return [
        f"[env] python={sys.version.split()[0]} torch={torch.__version__} "
        f"cuda={torch.version.cuda} devices={torch.cuda.device_count()}",
        f"[env.gpu] {_smi()} (name, clocks.sm, clocks.max.sm, power.draw, power.limit, temp)",
        f"[env.host] cpu={model!r} cores={os.cpu_count()} usable={affinity} "
        f"loadavg={' '.join(f'{x:.2f}' for x in os.getloadavg())}",
    ]


def window(query, seconds: float, span: bool, log=print):
    """The closed loop: queries back to back until ``seconds`` have passed
    (the last one runs to its end).  A query that raises yields ``None``.
    Returns the results, each query's seconds, the window's seconds and the
    port's host syncs in it."""
    import contextlib

    from torch.profiler import record_function

    from portbench.trace import SPAN
    from repro_torch import hostsync

    results, walls = [], []
    syncs0 = hostsync.read.count
    shown = False
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        try:
            with record_function(SPAN) if span else contextlib.nullcontext():
                r = query()
        except Exception:  # a failed query is counted, and the window goes on
            if not shown:
                traceback.print_exc()
                shown = True
            r = None
        end = time.perf_counter()
        walls.append(end - t0)
        results.append(r)
    w = sorted(walls)
    pct = {q: w[min(len(w) - 1, int(q / 100 * len(w)))] * 1e3 for q in (50, 90, 99)} if w else {}
    log(f"[window.walls] ms p50={pct.get(50)} p90={pct.get(90)} p99={pct.get(99)} "
        f"max={w[-1] * 1e3 if w else None}")
    return results, walls, end - start, hostsync.read.count - syncs0


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
             control: Optional[str] = None, t0: Optional[float] = None,
             log=print) -> Dict[str, Any]:
    """Set-up, window, reference and comparison of one run; returns the
    result line as a dict (``checks`` last)."""
    import torch

    from portbench import check, queries, reference, trace
    from repro_torch.graph.edgelist import EdgeList

    t0 = T0 if t0 is None else t0
    dev = torch.device(device)
    on_device = dev.type == "cuda"
    config, traffic = cell.config, cell.traffic
    n = int(config["n_nodes"])
    gen = generator(config)

    tg = time.monotonic()
    if on_device:
        torch.cuda.init()
        torch.empty(1, device=dev)
        log(f"[setup] to_context_seconds={time.monotonic() - t0:.3f}")
        tg = time.monotonic()
    src, dst = gen.edges(config, seed, dev)
    m = int(src.shape[0])
    graph = EdgeList(src=src, dst=dst, weight=torch.ones(m, dtype=torch.float32, device=dev),
                     mask=torch.ones(m, dtype=torch.bool, device=dev), n_nodes=n)
    if on_device:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    log(f"[graph] config={config['name']} nodes={n} edges={m} "
        f"seconds={time.monotonic() - tg:.3f}")

    if control is None:
        query = queries.program_query(traffic, graph, str(KERNEL_CACHE))
    else:
        query = queries.control_query(traffic, src, dst, n, control)
    tw = time.monotonic()
    for _ in range(int(traffic.get("warmup_queries", 2))):
        query()
    if on_device:
        torch.cuda.synchronize()
    log(f"[setup] warmup_seconds={time.monotonic() - tw:.3f}")
    gc.collect()
    if on_device:
        torch.cuda.reset_peak_memory_stats()
    smi_before = _smi() if on_device else None
    setup_s = time.monotonic() - t0

    summary = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device else [])
        with profile(activities=acts) as prof:
            with record_function("portbench.warmup"):
                query()
            results, walls, window_s, syncs = window(query, seconds, span=True, log=log)
        tr = time.monotonic()
        summary = trace.summarize(trace.events_from_profiler(prof))
        del prof
        log(f"[trace] reduce_seconds={time.monotonic() - tr:.3f}")
    else:
        results, walls, window_s, syncs = window(query, seconds, span=False, log=log)
    if on_device:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_device else None
    log(f"[window] queries={len(walls)} seconds={window_s:.6f} host_syncs={syncs} "
        f"peak_bytes={peak}")
    if smi_before is not None:
        log(f"[env.gpu.window] before: {smi_before} | after: {_smi()}")

    # The program's state goes before the reference runs on the card.
    del query, graph, src, dst
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    tr = time.monotonic()
    src, dst = gen.edges(config, seed, dev)
    eps = queries.lane_eps(traffic)
    rep = reference.replay(src, dst, n, eps, queries.max_passes(traffic, n))
    del src, dst
    log(f"[reference] seconds={time.monotonic() - tr:.3f} passes="
        f"{[a.passes for a in rep.answers]} density={[a.density for a in rep.answers]} "
        f"size={[a.size for a in rep.answers]}")
    checks = check.compare(results, rep.answers, traffic["expect"])
    correct = check.is_correct(checks, len(results))

    run = Run(traffic=traffic, setup_s=setup_s, walls=walls, window_s=window_s, peak_bytes=peak,
              host_syncs=syncs, trace=summary, work=rep.work)
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for metric in cell.metrics_of(kind):
        value = metric.reader()(run)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    device_info = {
        "platform": "gpu" if on_device else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_device else dev.type,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if trace_on:
        device_info["busy_s"] = summary.busy_s if summary else 0.0
        device_info["window_s"] = summary.window_s if summary else window_s
    line = {
        "correct": correct,
        "attempted": len(results),
        "failed": sum(r is None for r in results),
        "metrics": metrics,
        "device": device_info,
    }
    if trace_on and summary is not None:
        line["breakdown"] = trace.breakdown(summary)
    line["checks"] = checks
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None,
                   help="put the reference in this precision in the program's place")
    return p.parse_args(argv)


def main(argv=None, cores=None) -> int:
    args = parse_args(argv)
    from portbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    import repro_torch.core.api  # noqa: F401  (the system under test: no result without it)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 3
    print(f"[setup] torch_import_seconds={time.monotonic() - T0:.3f} pinned_cores={cores}",
          flush=True)
    for line in environment_lines():
        print(line, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control,
                   log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} (JAX or the JAX package); no result", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}={c['value']} limit={c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def prepare_process() -> List[int]:
    """The script's process, before torch is imported: pinned to four cores
    (returned), this folder off ``sys.path`` (its trace.py would shadow the
    standard library's module), the checkout and its ``src`` on it, and
    every build cache at a fixed path in the checkout."""
    cores = pin_cores()
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "portbench" / "triton")
    return cores


if __name__ == "__main__":
    sys.exit(main(cores=prepare_process()))
