"""The port's persistent cache of built kernels (``repro_torch.core.progcache``
behind ``repro_torch.kernels.load_library``), the counterpart of
tests/test_progcache.py and of the progcache half of tests/test_resilience.py.

There is no ``nvcc`` here, so a stub build function stands in for it: it
copies a shared library that ``ctypes`` can load (the interpreter's own
``_ctypes`` extension) and counts its calls.  The contract under test:

  * the fingerprint and the entry's name and key; a changed ``nvcc`` flag
    gives a new entry path and a miss;
  * the atomic publish: a library and a JSON sidecar, no temp files left
    by a failed build or a failed rename;
  * a corrupt library, a stale fingerprint, a missing or corrupt sidecar
    and a key mismatch each read as a miss and heal on the next build;
  * store faults are counted and logged once per Solver; load faults fail
    open to a build;
  * ``Solver(cache_dir)`` wins over ``Problem.cache_dir``;
  * a fresh process with a warm directory builds nothing.

The reference's in-memory LRU tests (``max_cached_programs``) have no
counterpart: the port caches no programs.  The card's cases (real
``nvcc``, all four kernels) are in tests/test_torch_cuda.py.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import _ctypes
import pytest

from repro_torch import faults, kernels
from repro_torch.core import api, progcache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    assert faults.installed() is None
    yield
    faults.uninstall()


class StubBuild:
    """Writes a loadable shared library in place of ``nvcc``; counts calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, source, out, flags):
        self.calls.append((Path(source).name, tuple(flags)))
        shutil.copyfile(_ctypes.__file__, out)
        return f"stub build of {Path(source).name}"


def _never(source, out, flags):
    raise AssertionError(f"{Path(source).name} was built again")


@pytest.fixture
def source(tmp_path):
    src = tmp_path / "src" / "kern.cu"
    src.parent.mkdir()
    src.write_text("// kernel source v1\n")
    return src


@pytest.fixture(autouse=True)
def _clean_build_log():
    saved = dict(kernels.BUILD_LOG)
    kernels.BUILD_LOG.clear()
    yield
    kernels.BUILD_LOG.clear()
    kernels.BUILD_LOG.update(saved)


def _load(cache_dir, source, build, counters=None, **kw):
    counters = counters if counters is not None else kernels.CacheCounters()
    with kernels.kernel_cache(cache_dir, counters):
        return kernels.load_library(source, build=build, **kw), counters


# ---------------------------------------------------------------------------
# fingerprint, name and key
# ---------------------------------------------------------------------------


def test_fingerprint_keys():
    fp = progcache.fingerprint()
    assert sorted(fp) == ["capability", "format", "nvcc", "nvcc_flags", "repro_torch",
                          "torch", "torch_cuda"]
    assert fp["format"] == progcache.FORMAT_VERSION
    assert fp["nvcc_flags"] == list(kernels.NVCC_FLAGS)
    import repro_torch
    import torch

    assert fp["repro_torch"] == repro_torch.__version__
    assert (fp["torch"], fp["torch_cuda"]) == (torch.__version__, torch.version.cuda)
    assert progcache.fingerprint() == fp


def test_nvcc_release_runs_once_per_process(monkeypatch):
    calls = []

    class Done:
        stdout = ("nvcc: NVIDIA (R) Cuda compiler\nCopyright (c) 2005-2024\n"
                  "Cuda compilation tools, release 12.4, V12.4.131\n"
                  "Build cuda_12.4.r12.4/compiler.34097967_0\n")

    monkeypatch.setattr(kernels, "_nvcc", lambda: "fake-bin/nvcc")
    monkeypatch.setattr(progcache.subprocess, "run",
                        lambda *a, **kw: calls.append(a) or Done())
    progcache.nvcc_release.cache_clear()
    try:
        assert progcache.fingerprint()["nvcc"] == "Cuda compilation tools, release 12.4, V12.4.131"
        progcache.fingerprint()
        assert len(calls) == 1
    finally:
        progcache.nvcc_release.cache_clear()


def test_entry_path_and_key(tmp_path, source, monkeypatch):
    p = progcache.entry_path(tmp_path, source)
    assert p.parent == tmp_path and p.name.startswith("kern-") and p.suffix == ".so"
    assert progcache.entry_path(tmp_path, source) == p
    assert progcache.entry_key(source) == f"kern.cu:{kernels.source_digest(source)}"
    # A changed nvcc flag, a changed source, a changed environment: new names.
    flags = tuple("-O2" if f == "-O3" else f for f in kernels.NVCC_FLAGS)
    assert flags != kernels.NVCC_FLAGS
    assert progcache.entry_path(tmp_path, source, flags) != p
    monkeypatch.setattr(progcache, "FORMAT_VERSION", progcache.FORMAT_VERSION + 1)
    assert progcache.entry_path(tmp_path, source) != p
    monkeypatch.undo()
    source.write_text("// kernel source v2\n")
    assert progcache.entry_path(tmp_path, source) != p


def test_library_path_follows_the_scope(tmp_path, source):
    assert kernels.library_path(source).parent == kernels.BUILD_DIR
    with kernels.kernel_cache(tmp_path, kernels.CacheCounters()):
        assert kernels.library_path(source) == progcache.entry_path(tmp_path, source)
    assert kernels.library_path(source).parent == kernels.BUILD_DIR


# ---------------------------------------------------------------------------
# round trip and the atomic publish
# ---------------------------------------------------------------------------


def test_round_trip_builds_once(tmp_path, source):
    d = tmp_path / "cache"
    build = StubBuild()
    lib, c1 = _load(d, source, build)
    assert lib is not None and len(build.calls) == 1
    assert (c1.disk_hits, c1.disk_misses, c1.disk_store_errors) == (0, 1, 0)
    assert kernels.BUILD_LOG["kern.cu"]["ptxas"] == "stub build of kern.cu"
    path = progcache.entry_path(d, source)
    assert sorted(os.listdir(d)) == sorted([path.name, path.with_suffix(".json").name])
    side = json.loads(path.with_suffix(".json").read_text())
    assert side["fingerprint"] == progcache.fingerprint()
    assert side["key"] == progcache.entry_key(source)
    kernels.BUILD_LOG.clear()
    _, c2 = _load(d, source, _never)
    assert (c2.disk_hits, c2.disk_misses) == (1, 0) and kernels.BUILD_LOG == {}


def test_failed_build_publishes_nothing(tmp_path, source):
    d = tmp_path / "cache"

    def broken(src, out, flags):
        Path(out).write_bytes(b"half a library")
        raise RuntimeError("nvcc failed on kern.cu (1)")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        _load(d, source, broken)
    assert os.listdir(d) == []  # no entry, no temp file


def test_failed_rename_is_a_store_error(tmp_path, source, monkeypatch):
    d = tmp_path / "cache"
    real = os.replace

    def no_replace(a, b):
        if str(b).endswith(".so"):
            raise OSError("read-only")
        return real(a, b)

    monkeypatch.setattr(progcache.os, "replace", no_replace)
    build = StubBuild()
    lib, c = _load(d, source, build)
    assert lib is not None and c.disk_store_errors == 1
    assert os.listdir(d) == []  # the temp file was removed
    assert len(build.calls) == 2  # published nowhere: built into a private directory


def test_store_returns_false_instead_of_raising(tmp_path, source):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the cache directory should be")
    assert progcache.store(blocker / "x.so", "k", lambda out: None) is False


# ---------------------------------------------------------------------------
# misses that heal
# ---------------------------------------------------------------------------


def _corrupt_library(path):
    path.write_bytes(b"\x00not a library")


def _stale_fingerprint(path):
    side = path.with_suffix(".json")
    blob = json.loads(side.read_text())
    blob["fingerprint"] = dict(blob["fingerprint"], nvcc="Cuda compilation tools, release 0.0")
    side.write_text(json.dumps(blob))


def _missing_sidecar(path):
    path.with_suffix(".json").unlink()


def _corrupt_sidecar(path):
    path.with_suffix(".json").write_text("{not json")


@pytest.mark.parametrize("damage", [_corrupt_library, _stale_fingerprint, _missing_sidecar,
                                    _corrupt_sidecar])
def test_damaged_entry_reads_as_a_miss_and_heals(tmp_path, source, damage):
    d = tmp_path / "cache"
    _load(d, source, StubBuild())
    path = progcache.entry_path(d, source)
    damage(path)
    assert progcache.load(path, progcache.entry_key(source)) is None
    build = StubBuild()
    _, c = _load(d, source, build)
    assert len(build.calls) == 1 and (c.disk_hits, c.disk_misses) == (0, 1)
    _, c2 = _load(d, source, _never)  # the rebuild overwrote the bad entry
    assert c2.disk_hits == 1


def test_load_missing_and_key_mismatch(tmp_path, source):
    assert progcache.load(tmp_path / "nope.so", "k") is None
    d = tmp_path / "cache"
    _load(d, source, StubBuild())
    assert progcache.load(progcache.entry_path(d, source), "other.cu:0") is None


def test_changed_flags_miss_a_warm_directory(tmp_path, source):
    d = tmp_path / "cache"
    _load(d, source, StubBuild())
    flags = tuple("-O2" if f == "-O3" else f for f in kernels.NVCC_FLAGS)
    build = StubBuild()
    _, c = _load(d, source, build, flags=flags)
    assert c.disk_misses == 1 and build.calls == [("kern.cu", flags)]
    assert len(os.listdir(d)) == 4  # both entries, side by side


# ---------------------------------------------------------------------------
# fault sites: store faults count and log once; load faults fail open
# ---------------------------------------------------------------------------


def test_store_fault_counts_and_logs_once(tmp_path, source, caplog):
    d = tmp_path / "cache"
    other = source.with_name("other.cu")
    other.write_text("// another kernel\n")
    solver = api.Solver(cache_dir=str(d))
    plan = faults.FaultPlan().fail_prob("progcache.store", 1.0)
    build = StubBuild()
    with caplog.at_level(logging.WARNING, logger="repro_torch.progcache"):
        with faults.active(plan), solver.kernel_cache(api.Problem()):
            assert kernels.load_library(source, build=build) is not None  # fail-open
            assert kernels.load_library(other, build=build) is not None
    assert solver.disk_store_errors == 2 and solver.disk_misses == 2
    warned = [r for r in caplog.records if r.name == "repro_torch.progcache"]
    assert len(warned) == 1
    assert not d.exists() or os.listdir(d) == []  # nothing was published
    assert plan.hits_at("progcache.store", str(progcache.entry_path(d, source))) == 1


def test_load_fault_fails_open_to_a_build(tmp_path, source):
    d = tmp_path / "cache"
    _load(d, source, StubBuild())
    build = StubBuild()
    with faults.active(faults.FaultPlan().fail_prob("progcache.load", 1.0)):
        _, c = _load(d, source, build)
    assert (c.disk_hits, c.disk_misses) == (0, 1) and len(build.calls) == 1
    _, c2 = _load(d, source, _never)  # without the plan the entry loads
    assert c2.disk_hits == 1


# ---------------------------------------------------------------------------
# the Solver's directory
# ---------------------------------------------------------------------------


def test_solver_cache_dir_wins_over_problem(tmp_path, source):
    d_solver, d_prob = tmp_path / "solver", tmp_path / "problem"
    solver = api.Solver(cache_dir=str(d_solver))
    with solver.kernel_cache(api.Problem(cache_dir=str(d_prob))):
        kernels.load_library(source, build=StubBuild())
    assert len(os.listdir(d_solver)) == 2 and not d_prob.exists()
    assert solver.disk_misses == 1
    # Without its own directory the Solver takes the Problem's.
    bare = api.Solver()
    with bare.kernel_cache(api.Problem(cache_dir=str(d_prob))):
        kernels.load_library(source, build=StubBuild())
    assert len(os.listdir(d_prob)) == 2 and bare.disk_misses == 1


def test_no_directory_counts_in_the_process_counters(source, monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    before = kernels.PROCESS_COUNTERS.disk_misses
    with api.Solver().kernel_cache(api.Problem()):  # neither names one
        kernels.load_library(source, build=StubBuild())
    assert kernels.PROCESS_COUNTERS.disk_misses == before + 1
    assert len(os.listdir(tmp_path / "build")) == 2


def test_fresh_process_with_a_warm_directory_builds_nothing(tmp_path, source):
    d = tmp_path / "cache"
    _load(d, source, StubBuild())
    script = textwrap.dedent(f"""
        from pathlib import Path
        from repro_torch import kernels
        from repro_torch.core import api

        def never(source, out, flags):
            raise SystemExit("built again")

        solver = api.Solver(cache_dir={str(d)!r})
        with solver.kernel_cache(api.Problem()):
            kernels.load_library(Path({str(source)!r}), build=never)
        assert (solver.disk_hits, solver.disk_misses) == (1, 0), vars(solver)
        assert kernels.BUILD_LOG == {{}}, kernels.BUILD_LOG
        print("WARM_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "WARM_OK" in out.stdout
