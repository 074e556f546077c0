"""One short run of each cell on the card (marked ``cuda``; it skips here
without one): exit 0, the contract's keys, and ``correct``."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's kernels on the card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "2", "--trace", str(trace)],
        env=env, capture_output=True, text=True, timeout=600, cwd=str(spec.ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m.name for m in spec.load_cell(cell).metrics_of(kind)}
    assert set(line["metrics"]) == want
