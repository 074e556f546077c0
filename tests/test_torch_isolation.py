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
    bench = sorted((REPO / "benchmarks" / "torch_port").glob("*.py"))
    examples = sorted((REPO / "examples" / "torch_port").glob("*.py"))
    assert bench and examples
    return files + bench + examples + [REPO / "chip_smoke.py"]


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
    # ``benchmarks`` is both packages' root: the port's benchmarks import
    # only ``benchmarks.torch_port``, never the reference's benchmarks.
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert not name.startswith("benchmarks") or name.startswith(
                "benchmarks.torch_port"), f"{path.relative_to(REPO)} imports {name}"


def test_importing_the_port_benchmarks_loads_no_jax():
    """The port's benchmarks, importable from the repository's root, load
    neither JAX nor the JAX package."""
    mods = [f"benchmarks.torch_port.{p.stem}"
            for p in sorted((REPO / "benchmarks" / "torch_port").glob("*.py"))]
    code = (
        "import importlib, sys; "
        f"[importlib.import_module(m) for m in {mods!r}]; "
        "bad = [m for m in ('jax', 'jaxlib', 'repro', 'benchmarks.bench_engine') "
        "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src") + os.pathsep + str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr


PORT_MODULES = (
    "repro_torch.core", "repro_torch.core.countsketch", "repro_torch.core.turnstile",
    "repro_torch.core.peel", "repro_torch.core.peel_topk", "repro_torch.core.peel_directed",
    "repro_torch.core.exact", "repro_torch.core.charikar", "repro_torch.core.density",
    "repro_torch.faults", "repro_torch.kernels.hashing",
    "repro_torch.kernels.peel_degree.ops", "repro_torch.kernels.count_sketch.ops",
    "repro_torch.kernels.l0_sampler.ops", "repro_torch.kernels.l0_sampler.ref",
    "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.flash_attention.ref",
    "repro_torch.models.common", "repro_torch.models.attention",
    "repro_torch.models.transformer", "repro_torch.serve.engine",
    "repro_torch.configs", "repro_torch.configs.llama3_2_3b",
    "repro_torch.configs.starcoder2_7b", "repro_torch.configs.qwen2_72b",
    "repro_torch.train.step", "repro_torch.launch.serve",
    "repro_torch.ioutil", "repro_torch.core.local", "repro_torch.core.progcache",
    "repro_torch.serve", "repro_torch.serve.densest", "repro_torch.serve.resilience",
    "repro_torch.serve.turnstile", "repro_torch.core.streaming", "repro_torch.graph.edgelist",
    "repro_torch.core.mapreduce", "repro_torch.collectives",
    "repro_torch.configs.densest_mapreduce", "repro_torch.graph.generators",
    "repro_torch.analysis", "repro_torch.analysis.core", "repro_torch.analysis.project",
    "repro_torch.analysis.rules", "repro_torch.analysis.rules.host_sync",
    "repro_torch.models.moe", "repro_torch.configs.mixtral_8x7b",
    "repro_torch.configs.llama4_maverick_400b",
)


def test_new_modules_are_scanned():
    scanned = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in PORT_MODULES:
        path = "src/" + mod.replace(".", "/")
        assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned, mod


def test_importing_the_port_loads_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package, compiles nothing, and leaves the fault hook empty (no plan
    installed: ``faults.fire`` is a no-op)."""
    code = (
        "import importlib, sys; "
        f"mods = [importlib.import_module(m) for m in {PORT_MODULES!r}]; "
        "from repro_torch import faults; from repro_torch.kernels import BUILD_LOG; "
        "bad = [m for m in ('jax', 'jaxlib', 'repro') if m in sys.modules]; "
        "state = (faults.installed(), faults._ACTIVE, BUILD_LOG); "
        "print(bad, state); sys.exit(1 if bad or state != (None, None, {}) else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_linter_loads_neither_torch_nor_the_reference():
    """``repro_torch.analysis`` is pure ``ast``/stdlib: importing it and
    running its CLI load no torch, no JAX and nothing of ``repro`` (not even
    ``repro.analysis``, which is jax-free)."""
    code = (
        "import sys; from repro_torch.analysis import __main__ as cli; "
        "assert cli.main(['--strict']) == 0; "
        "bad = [m for m in ('torch', 'numpy', 'jax', 'repro', 'repro.analysis') "
        "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)"
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generators.directed_planted(100, 3, 10, 5, 0.5, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generators.bipartite_spam(50, 40, 3, 5, 5, 0.5, seed=0)


def test_mesh_entry_point_raises_without_cuda_and_without_device():
    """``make_mesh`` defaults to the card: without one it raises before it
    starts any process group (no quiet gloo world)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    import torch.distributed as dist

    from repro_torch.core.mapreduce import make_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1,), ("data",))
    assert not dist.is_initialized()


def test_serving_entry_points_raise_without_cuda_and_without_device():
    """The turnstile density service defaults to the card; the query engine
    and ``solve(..., seed=)`` run on their graph's device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    from repro_torch.core import Problem, solve
    from repro_torch.graph.edgelist import from_numpy
    from repro_torch.serve import DensestQueryEngine, TurnstileDensityService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TurnstileDensityService(10)
    g = from_numpy(np.array([0, 1]), np.array([1, 2]), 3, device="cpu")
    assert DensestQueryEngine(g).device == torch.device("cpu")
    res = solve(g, Problem(substrate="local"), seed=0)
    assert res.best_alive.device == torch.device("cpu")


def test_lm_entry_points_raise_without_cuda_and_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("llama3.2-3b").reduced_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    params = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg)
