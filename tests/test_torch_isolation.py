"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, importing the port loads neither, and its
entry points never quietly fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert files
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch.core, repro_torch.kernels.peel_degree.ops; "
        "bad = [m for m in ('jax', 'jaxlib', 'repro') if m in sys.modules]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda_and_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    from repro_torch.graph import generators
    from repro_torch.graph.edgelist import from_numpy

    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy(np.array([0]), np.array([1]), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generators.planted_dense_subgraph(100, 4, 10, 0.5, seed=0)
