"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix.  The configuration's file
is the ``file`` of its entry in ``configs``; the traffic mix is
``traffic/<traffic>.json`` beside this module; each metric is read by
``metrics/<metric>.py``.  A cell's metrics are the end-to-end ones (with
``--trace 0``) or the per-layer ones (with ``--trace 1``) whose
``workloads`` key lists it, or that have no such key.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" | "per_layer"
    entry: Dict[str, Any]

    def reader(self) -> Callable[[Any], Optional[float]]:
        """``metrics/<name>.py``'s ``read(run) -> float | None``."""
        return load_module(HERE / "metrics" / f"{self.name}.py",
                           f"portbench_metric_{self.name}").read


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    metrics: List[Metric]  # both kinds; run.py picks by --trace

    def metrics_of(self, kind: str) -> List[Metric]:
        return [m for m in self.metrics if m.kind == kind]


def load_module(path: Path, name: str):
    """A file of this folder (a metric's reader, a generator) found by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def _applies(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(root) / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = [
        Metric(m["name"], m["unit"], m["better"], m["source"], kind, m)
        for kind in ("end_to_end", "per_layer")
        for m in bench[kind]
        if _applies(m, name)
    ]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                metrics=metrics)
