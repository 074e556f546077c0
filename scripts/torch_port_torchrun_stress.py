"""Stress loop for the port's torchrun teardown: runs
``tests/test_torch_mapreduce.py::test_torchrun_world_and_auto_substrate``
``--copies`` times per round under pytest-xdist (``-n 6``), beside the rest
of ``tests/test_torch_mapreduce.py``, for ``--rounds`` rounds, and counts
the failures by kind: an abort at exit (``terminate called without an
active exception``) or another failure.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_torchrun_stress.py [--rounds 4]

Run it from the root of the tree under test; it writes one temporary test
file into that tree's ``tests/`` (removed afterwards) that parametrizes the
torchrun test ``--copies`` times.  Exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

_WRAPPER = """import pytest
from test_torch_mapreduce import test_torchrun_world_and_auto_substrate as _run


@pytest.mark.parametrize("i", range({copies}))
def test_torchrun_copy(tmp_path, i):
    _run(tmp_path)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--copies", type=int, default=30)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)

    wrapper = Path("tests") / "test_torchrun_stress_copies.py"
    wrapper.write_text(_WRAPPER.format(copies=args.copies))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    runs = failed = aborts = 0
    try:
        for r in range(args.rounds):
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist",
                 "-n", str(args.workers), "-p", "no:randomly", "--tb=long",
                 "tests/test_torch_mapreduce.py", str(wrapper)],
                env=env, capture_output=True, text=True, timeout=1800,
            )
            out = proc.stdout + proc.stderr
            bad = len(re.findall(r"^FAILED .*test_torchrun_copy", out, re.M))
            runs += args.copies
            failed += bad
            aborts += out.count("terminate called without an active exception")
            other = len(re.findall(r"^FAILED ", out, re.M)) - bad
            print(f"round {r}: {args.copies} runs, {bad} failed, {other} other tests failed",
                  flush=True)
    finally:
        wrapper.unlink()
    print(f"runs={runs} failed={failed} aborts_at_exit={aborts}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
