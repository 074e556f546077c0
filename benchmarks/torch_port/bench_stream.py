"""Out-of-core streaming benchmark of the port (counterpart of
``benchmarks/bench_stream.py``): the semi-streaming substrate's pipeline
overlap and the spill ladder's residency, with the node state on the card.

    PYTHONPATH=src python -m benchmarks.torch_port.bench_stream [--n 100000]

The reference's sync and async modes map onto the port's
``StreamingDensest(n_workers=, prefetch=)``: ``sync`` is one worker and a
one-chunk window, ``async`` ``--workers`` workers (each with its pinned
staging buffers and CUDA stream) and a ``--prefetch``-chunk window; then
the geometric ladder in RAM and spilled to disk.  Every mode must be
bitwise equal to the synchronous run (best set, density, passes and
history), as the reference asserts; ``main`` exits 1 otherwise.  The
stream is memmap-backed (written once to a store in a temporary
directory).  Writes experiments/bench/torch/BENCH_stream.json: per mode the
least wall of ``--repeats`` warm runs (host clock, ending after the last
pass's reads), passes, peak resident chunks and edges, compactions, spill
rungs and the identity flag.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmarks.torch_port import common
from repro_torch.core.streaming import StreamingDensest, chunked_from_memmap
from repro_torch.graph.edgelist import save_edges_memmap
from repro_torch.graph.generators import chung_lu_power_law


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--exponent", type=float, default=2.0)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--chunk", type=int, default=1 << 13)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--prefetch", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=common.out_path("BENCH_stream.json"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _run(make_drv, dev, repeats: int):
    st = make_drv().run(resume=False)  # warm: the workers' pinned buffers, the allocator
    best = float("inf")
    drv = None
    for _ in range(repeats):
        drv = make_drv()
        common.sync(dev)
        t0 = time.perf_counter()
        st = drv.run(resume=False)
        common.sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, st, drv


def run(args, graph=None) -> dict:
    dev = common.device_of(args)
    edges = graph if graph is not None else chung_lu_power_law(
        args.n, exponent=args.exponent, avg_deg=args.avg_deg, seed=0, device="cpu")
    mask = edges.mask.cpu().numpy()
    src = edges.src.cpu().numpy()[mask]
    dst = edges.dst.cpu().numpy()[mask]
    w = edges.weight.cpu().numpy()[mask]
    n = edges.n_nodes
    scratch = tempfile.mkdtemp(prefix="bench_stream_")
    store = save_edges_memmap(os.path.join(scratch, "store"), src, dst, w)
    stream = chunked_from_memmap(store, chunk=args.chunk)
    n_chunks = -(-len(src) // args.chunk)

    # Speculation duplicates tail chunks (a fault-tolerance knob): off in the
    # timed modes, so the numbers isolate the pipeline.
    modes = {
        "sync": dict(n_workers=1, prefetch=1, speculative=False),
        "async": dict(n_workers=args.workers, prefetch=args.prefetch, speculative=False),
        "geometric_ram": dict(n_workers=args.workers, prefetch=args.prefetch,
                              speculative=False, compaction="geometric"),
        "geometric_spill": dict(n_workers=args.workers, prefetch=args.prefetch,
                                speculative=False, compaction="geometric",
                                spill_dir=os.path.join(scratch, "spill")),
    }
    report = {
        "device": common.device_record(dev),
        "graph": {
            "family": "chung_lu_power_law",
            "n_nodes": n,
            "n_edges": int(len(src)),
            "exponent": args.exponent,
            "avg_deg": args.avg_deg,
        },
        "eps": args.eps,
        "chunk": args.chunk,
        "n_chunks": n_chunks,
        "workers": args.workers,
        "prefetch": args.prefetch,
        "statistic": f"wall_s: least of {args.repeats} warm runs",
        "modes": {},
    }
    ref = None
    try:
        for name, kw in modes.items():
            wall, st, drv = _run(
                lambda kw=kw: StreamingDensest(stream, n_nodes=n, eps=args.eps, device=dev,
                                               **kw),
                dev, args.repeats)
            if ref is None:
                ref, identical = st, True
            else:
                identical = bool(
                    st.best_rho == ref.best_rho
                    and np.array_equal(st.best_alive, ref.best_alive)
                    and st.pass_idx == ref.pass_idx
                    and st.history == ref.history
                )
            report["modes"][name] = {
                "wall_s": round(wall, 4),
                "passes": st.pass_idx,
                "rho": round(st.best_rho, 4),
                "peak_resident_chunks": drv.peak_resident_chunks,
                "peak_resident_edges": drv.peak_resident_edges,
                "compactions": drv.compactions,
                "spill_rungs": drv.spill_rungs,
                "speculative_reissues": drv.speculative_reissues,
                "bit_identical_to_sync": identical,
            }
            print(f"{name}: {report['modes'][name]}")
        sync_w = report["modes"]["sync"]["wall_s"]
        for name in ("async", "geometric_ram", "geometric_spill"):
            report["modes"][name]["speedup_vs_sync_x"] = round(
                sync_w / max(report["modes"][name]["wall_s"], 1e-9), 2)
        ram = report["modes"]["geometric_ram"]["peak_resident_edges"]
        sp = report["modes"]["geometric_spill"]["peak_resident_edges"]
        report["spill_residency_reduction_x"] = round(ram / max(sp, 1), 2)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run(args)
    common.write_json(report, args.out)
    return 0 if all(m["bit_identical_to_sync"] for m in report["modes"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
