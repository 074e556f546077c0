"""Port parity: the benchmarks of ``benchmarks/torch_port/`` against the
reference's ``benchmarks/`` at the same tiny arguments, on the CPU.

Each port benchmark's ``main`` runs with ``--device cpu``, exits 0 and
writes a record whose ``device`` is ``"cpu"``; every field that does not
time anything equals the reference benchmark's (run here on CPU JAX):
passes, densities, slots scanned, identity flags, residency counters,
outcome histograms, ``answered_fraction`` and the envelope pass rate.
Fields that only exist in one package (XLA trace counts; the port's host
syncs, collectives and kernel launches) are checked for what they must be.

The turnstile, serving and resilience benchmarks are in
``test_torch_benchmarks_serving.py``.
"""

import csv
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmarks import bench_api as ref_api  # noqa: E402
from benchmarks import bench_engine as ref_engine  # noqa: E402
from benchmarks import bench_peel_compaction as ref_peel  # noqa: E402
from benchmarks import bench_stream as ref_stream  # noqa: E402
from benchmarks.torch_port import bench_api as port_api  # noqa: E402
from benchmarks.torch_port import bench_engine as port_engine  # noqa: E402
from benchmarks.torch_port import bench_peel_compaction as port_peel  # noqa: E402
from benchmarks.torch_port import bench_resilience as port_resilience  # noqa: E402
from benchmarks.torch_port import bench_serve as port_serve  # noqa: E402
from benchmarks.torch_port import bench_stream as port_stream  # noqa: E402
from benchmarks.torch_port import bench_turnstile as port_turnstile  # noqa: E402


def _both(port_mod, ref_mod, tmp_path, argv, name):
    """Runs both mains on ``argv`` (+ ``--out``); returns both records."""
    port_out, ref_out = tmp_path / f"port_{name}", tmp_path / f"ref_{name}"
    assert port_mod.main(argv + ["--out", str(port_out), "--device", "cpu"]) == 0
    assert ref_mod.main(argv + ["--out", str(ref_out)]) == 0
    port = json.loads(port_out.read_text())
    assert port["device"] == "cpu"
    return port, json.loads(ref_out.read_text())


def _pick(d, keys):
    return {k: d[k] for k in keys}


def test_bench_engine_matches_reference(tmp_path, monkeypatch):
    argv = ["--n", "3000", "--max-passes", "16"]
    out = tmp_path / "engine.json"
    assert port_engine.main(argv + ["--out", str(out), "--device", "cpu"]) == 0
    port = json.loads(out.read_text())
    assert port["device"] == "cpu"
    monkeypatch.chdir(tmp_path)  # the reference writes experiments/bench/ under the cwd
    assert ref_engine.main(argv) == 0
    with open(tmp_path / "experiments" / "bench" / "engine_backends.csv") as f:
        ref_rows = list(csv.DictReader(f))
    assert [r["backend"] for r in port["rows"]] == [r["backend"] for r in ref_rows]
    for got, want in zip(port["rows"], ref_rows):
        for k in ("nodes", "edges", "passes", "rho", "rho_vs_exact"):
            assert str(got[k]) == want[k], (got["backend"], k)
        assert got["kernel_launches"] == 0  # the plain versions run on the CPU


def test_bench_peel_compaction_matches_reference(tmp_path):
    import torch.distributed as dist

    port, ref = _both(port_peel, ref_peel, tmp_path,
                      ["--n", "4000", "--repeats", "1", "--eps", "0.1", "0.5"], "peel")
    assert not dist.is_initialized()  # the world the bench started is gone
    assert _pick(port["graph"], ("n_nodes", "n_edges", "n_edges_padded")) == _pick(
        ref["graph"], ("n_nodes", "n_edges", "n_edges_padded"))
    assert port["eps"].keys() == ref["eps"].keys()
    for eps, rows in port["eps"].items():
        want = ref["eps"][eps]
        for mode in ("off", "twophase", "geometric"):
            keys = ["passes", "segments", "edge_slots_scanned", "rho", "bit_identical_to_off"]
            if mode != "off":
                keys.append("slots_reduction_x")
            assert _pick(rows[mode], keys) == _pick(want[mode], keys), (eps, mode)
            assert rows[mode]["bit_identical_to_off"] is True
        mesh, rmesh = rows["mesh"], want["mesh"]
        assert mesh["bit_identical_to_off"] is rmesh["bit_identical_to_off"] is True
        assert _pick(mesh["host_ladder"], ("host_round_trips", "segments")) == _pick(
            rmesh["host_ladder"], ("host_round_trips", "segments"))
        lad, rlad = mesh["collective_ladder"], rmesh["single_program_ladder"]
        assert _pick(lad, ("segments", "edge_slots_scanned")) == _pick(
            rlad, ("segments", "edge_slots_scanned"))
        # In place of host_round_trips: one host sync a pass plus the entry
        # read, one all_reduce a pass plus the entry and the rung triggers.
        passes = rows["off"]["passes"]
        assert lad["host_syncs"] >= passes
        assert lad["collectives"]["all_reduce"] >= passes


def test_bench_api_matches_reference(tmp_path):
    argv = ["--n", "3000", "--grid", "3", "--repeats", "1", "--max-passes", "24"]
    port, ref = _both(port_api, ref_api, tmp_path, argv, "api")
    keys = ("n_nodes", "n_edges", "eps", "max_passes")
    assert _pick(port, keys) == _pick(ref, keys)
    assert port["solve_batch"]["eps_grid"] == ref["solve_batch"]["eps_grid"]
    assert all(port["solve_batch"]["lane_equal_to_solve"])
    assert port["kernel_load"]["equal_to_exact"] is True
    assert port["kernel_load"]["library_loaded"] is False  # nothing loads on the CPU
    # one host read a pass, and the batch one a pass for every lane
    assert port["solve"]["host_syncs"] == port["solve"]["passes"] + 1
    assert port["solve_batch"]["batch_host_syncs"] <= max(port["solve_batch"]["passes"]) + 2


def test_bench_api_solve_matches_reference_solve():
    """The record's passes and rho are the reference's solve on the graph."""
    import repro.core as ref_core
    from repro.graph.generators import chung_lu_power_law

    args = port_api.parse_args(["--n", "3000", "--grid", "2", "--repeats", "1",
                                "--device", "cpu", "--out", ""])
    got = port_api.run(args)["solve"]
    edges = chung_lu_power_law(3000, exponent=2.0, avg_deg=8.0, seed=0)
    want = ref_core.solve(edges, ref_core.Problem.undirected(eps=0.5, max_passes=48,
                                                             compaction="off"))
    assert got["passes"] == int(want.passes)
    assert got["rho"] == round(float(want.best_density), 4)


def test_bench_stream_matches_reference(tmp_path):
    argv = ["--n", "8000", "--chunk", "1024", "--repeats", "1"]
    port, ref = _both(port_stream, ref_stream, tmp_path, argv, "stream")
    for k in ("eps", "chunk", "n_chunks", "workers", "prefetch"):
        assert port[k] == ref[k], k
    assert port["graph"] == ref["graph"]
    keys = ("passes", "rho", "peak_resident_chunks", "peak_resident_edges", "compactions",
            "spill_rungs", "speculative_reissues", "bit_identical_to_sync")
    assert port["modes"].keys() == ref["modes"].keys()
    for mode, got in port["modes"].items():
        assert _pick(got, keys) == _pick(ref["modes"][mode], keys), mode
        assert got["bit_identical_to_sync"] is True
    assert port["spill_residency_reduction_x"] == ref["spill_residency_reduction_x"]


def test_port_benchmarks_raise_without_cuda_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    for mod in (port_engine, port_peel, port_api, port_stream, port_turnstile, port_serve,
                port_resilience):
        args = mod.parse_args(["--out", ""])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(args)


def test_port_benchmarks_write_under_experiments_bench_torch():
    for mod in (port_engine, port_peel, port_api, port_stream, port_turnstile, port_serve,
                port_resilience):
        out = mod.parse_args([]).out
        assert Path(out).parent == Path("experiments", "bench", "torch"), mod.__name__
