"""What the port's benchmarks share: the device rule, the clock, the
device entry of every record and where the records go.

Each benchmark of ``benchmarks/torch_port/`` is the counterpart of the
module of the same name in ``benchmarks/``, with its arguments and
defaults, plus ``--device`` (default: the card; ``cpu`` when asked).  It
exposes ``parse_args(argv)``, ``run(args, graph=None) -> dict`` (a caller
that already holds the graph passes it) and ``main(argv)``, which writes
the record under ``experiments/bench/torch/``."""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.edgelist import resolve_device

OUT_DIR = os.path.join("experiments", "bench", "torch")


def out_path(name: str) -> str:
    return os.path.join(OUT_DIR, name)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without CUDA); 'cpu' when asked")


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def device_record(dev: torch.device) -> Any:
    """``"cpu"``, or the card's name and ``nvidia-smi``'s name and power
    limit (a card below its maximum power runs slower under load)."""
    dev = torch.device(dev)
    if dev.type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"name": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def sync(dev: torch.device) -> None:
    """Waits for the card's queued work (a no-op on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable[[], Any], dev: torch.device) -> Tuple[float, Any]:
    """Seconds of ``fn()`` on the host clock, ending after the card is done."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out


def best_of(fn: Callable[[], Any], dev: torch.device, repeats: int) -> Tuple[float, Any]:
    """One warm-up call, then the least seconds over ``repeats`` calls and
    the last call's result."""
    out = fn()
    best = float("inf")
    for _ in range(repeats):
        wall, out = timed(fn, dev)
        best = min(best, wall)
    return best, out


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def lat_stats(lat_s, wall_s: float, n: int) -> Dict[str, float]:
    """p50/p99 of per-query latencies, the stream's wall and its rate."""
    return {
        "p50_ms": round(pct(lat_s, 50) * 1e3, 3),
        "p99_ms": round(pct(lat_s, 99) * 1e3, 3),
        "wall_s": round(wall_s, 4),
        "qps": round(n / wall_s, 2),
    }


def write_json(report: dict, path: Optional[str]) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {path}")
