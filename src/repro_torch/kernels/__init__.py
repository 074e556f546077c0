"""Hand-written Hopper kernels of the port, their dispatch rule and build.

Each kernel package holds a CUDA source under ``csrc/``, a plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``).  Kernel modules are
imported lazily and nothing is compiled at import: :func:`load_library`
runs ``nvcc`` at a kernel's first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
# Headers shared by the kernels (the hash family); on nvcc's include path.
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# Shared memory one CTA may use on Hopper (dynamic, after the opt-in).
MAX_SMEM_BYTES = 232_448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Seconds and compiler output of each build made in this process, by source.
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def use_kernel(t: torch.Tensor) -> bool:
    """The dispatch rule (the counterpart of ``repro.kernels.resolve_interpret``):
    a CPU tensor gets the plain PyTorch version, a CUDA tensor gets the
    kernel.  There is no fallback: a wrapper whose kernel fails on a CUDA
    tensor raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def source_digest(source: Path) -> str:
    """Hash of ``source`` and every shared header in :data:`CSRC_DIR`, so an
    edit to either gives the library a new name and rebuilds it."""
    h = hashlib.sha256()
    for path in [Path(source), *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def library_path(source: Path) -> Path:
    """Where :func:`load_library` builds ``source``:
    ``build/repro_torch/<stem>-<hash>.so`` (the hash covers the source and
    the shared headers)."""
    source = Path(source)
    return BUILD_DIR / f"{source.stem}-{source_digest(source)}.so"


def load_library(source: Path) -> ctypes.CDLL:
    """Builds ``source`` into :func:`library_path` (once) and loads it."""
    source = Path(source)
    out = library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name} ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
        BUILD_LOG[source.name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": proc.stderr.strip(),
        }
    return ctypes.CDLL(str(out))
