"""Persistent cache of built kernels (counterpart of ``repro.core.progcache``).

The reference caches compiled XLA programs on disk so that a fresh process
compiles nothing.  PyTorch runs eagerly, so the port has no programs to
cache; what a fresh process pays for instead is ``nvcc`` on each kernel's
source.  This module keeps the built shared libraries:

  * an entry is one kernel library (``<stem>-<hash>.so``) and a JSON sidecar
    (``<stem>-<hash>.json``) holding the build's :func:`fingerprint`, the
    entry's key (the source's name and digest) and the library's sha256;
  * the file name is a sha256 over :func:`~repro_torch.kernels.source_digest`
    (the source and the shared headers) and the fingerprint (format
    version, ``nvcc`` flags, the ``nvcc`` release, torch's version and CUDA
    version, the card's compute capability and the port's version), so a
    library built another way is never picked up by name;
  * the sidecar is checked again on load, and so is the library's hash, so
    a copied directory, a torn write or a corrupt library reads as a miss;
  * the library is built into a same-directory temp file and published with
    :func:`repro_torch.ioutil.atomic_publish`, then the sidecar through
    :func:`repro_torch.ioutil.atomic_write_file`: a reader sees an old entry
    or a new one, never a torn one;
  * any load failure (a missing file, a missing or corrupt sidecar, a
    fingerprint or key mismatch, a library ``ctypes.CDLL`` refuses) reads
    as a miss: the caller builds again and overwrites the entry.

Both functions fire the fault sites ``progcache.load`` and
``progcache.store``, keyed by the entry path.  The build is a function
argument (``store(path, key, build_fn, flags)``), so tests substitute a
stub that writes a library without ``nvcc``.
:func:`repro_torch.kernels.load_library` is the one caller.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

import repro_torch
from repro_torch import faults, kernels
from repro_torch.ioutil import atomic_publish, atomic_write_file

# Bump to invalidate every existing entry on a format change.
FORMAT_VERSION = 1

_LIB_SUFFIX = ".so"
_SIDECAR_SUFFIX = ".json"


@functools.lru_cache(maxsize=None)
def nvcc_release() -> str:
    """``nvcc --version``'s release line (``Cuda compilation tools, release
    12.4, V12.4.131``), run once per process; ``'nvcc not found'`` where
    there is none.  Its first line names only the compiler, the same
    for every release."""
    try:
        out = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "nvcc not found"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    release = [ln for ln in lines if "release" in ln]
    return (release or lines or ["nvcc printed nothing"])[-1]


def _capability() -> Optional[str]:
    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def fingerprint(flags: Sequence[str] = kernels.NVCC_FLAGS) -> dict:
    """How a library was built, baked into every entry's name and sidecar:
    any difference here reads as a miss, never as a load."""
    return {
        "format": FORMAT_VERSION,
        "nvcc_flags": list(flags),
        "nvcc": nvcc_release(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "capability": _capability(),
        "repro_torch": repro_torch.__version__,
    }


def entry_key(source: Path) -> str:
    """The key an entry is stored under: the source's name and digest."""
    return f"{Path(source).name}:{kernels.source_digest(source)}"


def entry_path(cache_dir, source: Path, flags: Sequence[str] = kernels.NVCC_FLAGS) -> Path:
    """The library path of ``source``'s entry under ``cache_dir`` for the
    current environment and ``flags``."""
    source = Path(source)
    digest = hashlib.sha256(
        (kernels.source_digest(source) + repr(sorted(fingerprint(flags).items()))).encode()
    ).hexdigest()
    return Path(cache_dir) / f"{source.stem}-{digest[:16]}{_LIB_SUFFIX}"


def _sidecar(path: Path) -> Path:
    return path.with_suffix(_SIDECAR_SUFFIX)


def _file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def store(path: Path, key: str, build_fn: Callable[[Path], None],
          flags: Sequence[str] = kernels.NVCC_FLAGS) -> bool:
    """Builds the library with ``build_fn(out)`` into a same-directory temp
    file and publishes it at ``path`` with its sidecar.  Best-effort: a
    fault, an unwritable directory or a failed rename returns False (the
    temp file removed); an error of ``build_fn`` itself, a compile error,
    propagates."""
    path = Path(path)
    try:
        faults.fire("progcache.store", key=str(path))
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=_LIB_SUFFIX + ".tmp")
        os.close(fd)
    except Exception:  # noqa: BLE001 — best-effort publish
        return False
    # repro: allow(fault-sites) publishes what the try above made, after its progcache.store hook fired
    try:
        build_fn(Path(tmp))
        sidecar = json.dumps({
            "fingerprint": fingerprint(flags), "key": key, "sha256": _file_sha256(Path(tmp)),
        }, sort_keys=True).encode()
        atomic_publish(tmp, str(path))
        atomic_write_file(str(_sidecar(path)), lambda f: f.write(sidecar),
                          suffix=_SIDECAR_SUFFIX + ".tmp")
        return True
    except OSError:
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load(path: Path, key: str, flags: Sequence[str] = kernels.NVCC_FLAGS
         ) -> Optional[ctypes.CDLL]:
    """The library stored for ``key`` at ``path``, loaded, or None on any
    miss (see the module docstring); the caller builds and overwrites."""
    path = Path(path)
    try:
        faults.fire("progcache.load", key=str(path))
        with open(_sidecar(path), "rb") as f:
            entry = json.loads(f.read())
        if entry.get("fingerprint") != fingerprint(flags) or entry.get("key") != key:
            return None
        if entry.get("sha256") != _file_sha256(path):
            return None
        return ctypes.CDLL(str(path))
    except Exception:  # noqa: BLE001 — every failure is a miss
        return None
