"""Hand-written Hopper kernels of the port, their dispatch rule and build.

Each kernel package holds a CUDA source under ``csrc/``, a plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``).  Kernel modules are
imported lazily and nothing is compiled at import: :func:`load_library`
loads a kernel's library at its first launch from the persistent cache of
built kernels (``core/progcache.py``), and runs ``nvcc`` only on a miss.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Sequence

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

# Seconds and compiler output of each build made in this process, by source:
# a process that found every library in the cache leaves it empty.
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


def nvcc_build(source: Path, out: Path, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Compiles ``source`` into the shared library ``out`` with ``nvcc
    flags``; returns the compiler's diagnostics (``ptxas -v``).  The build
    function :func:`load_library` calls unless it is given another."""
    proc = subprocess.run(
        [_nvcc(), *flags, "-I", str(CSRC_DIR), "-o", str(out), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {Path(source).name} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc.stderr.strip()


class CacheCounters:
    """Lookups of the cache of built kernels: entries loaded (``disk_hits``),
    entries built (``disk_misses``) and builds that could not be published
    (``disk_store_errors``).  :class:`~repro_torch.core.api.Solver` keeps
    the same three counters for the loads its solves make."""

    def __init__(self):
        self.disk_hits = 0
        self.disk_misses = 0
        self.disk_store_errors = 0


# Where a load outside any Solver's scope goes, and what it counts.
_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_cache", default=(None, None)
)
PROCESS_COUNTERS = CacheCounters()


@contextlib.contextmanager
def kernel_cache(cache_dir, counters) -> Iterator[None]:
    """Within the block, :func:`load_library` looks up and publishes built
    kernels under ``cache_dir`` and counts in ``counters``; outside any
    block, under :data:`BUILD_DIR` in :data:`PROCESS_COUNTERS`."""
    token = _SCOPE.set((Path(cache_dir), counters))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def library_path(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where :func:`load_library` keeps ``source``'s library:
    ``<dir>/<stem>-<hash>.so``, the hash over the source, the shared headers
    and the build's environment (``core/progcache.py::fingerprint``)."""
    from repro_torch.core import progcache

    cache_dir, _ = _SCOPE.get()
    return progcache.entry_path(cache_dir or BUILD_DIR, source, flags)


def load_library(
    source: Path,
    *,
    build: Callable[[Path, Path, Sequence[str]], str] = nvcc_build,
    flags: Sequence[str] = NVCC_FLAGS,
) -> ctypes.CDLL:
    """Loads ``source``'s library from the cache of built kernels
    (``core/progcache.py``) or, on a miss, builds it with ``build(source,
    out, flags)`` (each build logged in :data:`BUILD_LOG`), publishes it
    there and loads it.  A publish that fails is counted and logged once
    per counter; the library is then built into a private temp directory
    and loaded from there."""
    from repro_torch.core import progcache

    source = Path(source)
    cache_dir, counters = _SCOPE.get()
    cache_dir = Path(cache_dir or BUILD_DIR)
    counters = counters if counters is not None else PROCESS_COUNTERS
    path = progcache.entry_path(cache_dir, source, flags)
    key = progcache.entry_key(source)
    lib = progcache.load(path, key, flags)
    if lib is not None:
        counters.disk_hits += 1
        return lib
    counters.disk_misses += 1

    def logged_build(out: Path) -> None:
        t0 = time.perf_counter()
        log = build(source, out, flags)
        BUILD_LOG[source.name] = {"seconds": time.perf_counter() - t0, "ptxas": log}

    if progcache.store(path, key, logged_build, flags):
        return ctypes.CDLL(str(path))
    counters.disk_store_errors += 1
    if counters.disk_store_errors == 1:
        logging.getLogger("repro_torch.progcache").warning(
            "cache of built kernels: could not publish %s (dir=%s); kernels still "
            "load, but a fresh process will build them again; further failures "
            "are counted in disk_store_errors without logging", source.name, cache_dir,
        )
    with tempfile.TemporaryDirectory(prefix="repro_torch_build_") as private:
        out = Path(private) / path.name
        logged_build(out)
        return ctypes.CDLL(str(out))  # stays mapped once the file is gone
