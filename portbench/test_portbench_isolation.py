"""The harness loads neither JAX nor the JAX package ``repro`` (compared by
whole top-level names: the port's name begins with ``repro``), and without
a card, or without the program, it prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(spec.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & FORBIDDEN


def test_a_fresh_interpreter_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "from portbench import run, spec, check, queries, reference, roofline, trace\n"
        "import portbench.generators.chung_lu\n"
        "import repro_torch.core.api, repro_torch.kernels.peel_degree.ops\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    [m.reader() for m in spec.load_cell(w['name']).metrics]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(spec.ROOT), str(spec.ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300, cwd=str(spec.ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _run_script(root: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "livejournal.exact", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(root))


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            pass
    return True


def test_without_a_card_no_result():
    proc = _run_script(spec.ROOT)
    assert proc.returncode != 0 and _no_result(proc.stdout)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_script(tmp_path)
    assert proc.returncode != 0 and _no_result(proc.stdout)
