"""Port parity: the turnstile, serving and resilience benchmarks of
``benchmarks/torch_port/`` against the reference's at the same tiny
arguments, on the CPU (the rest are in ``test_torch_benchmarks.py``).

Every field that does not time anything equals the reference's: the
trials' sample levels and densities, the envelope pass rate, the engine's
buckets and lanes, the sweep's work counters, the storm's outcome
histogram and ``answered_fraction``.  The reference serving bench's
cold-start children compile XLA programs, so it runs with
``--skip-cold-start`` and the port's children are checked on their own.
The resilience benches run with a deadline no CPU solve can reach, in both
packages, so the storm's outcomes do not depend on how busy the machine is.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import bench_resilience as ref_resilience  # noqa: E402
from benchmarks import bench_serve as ref_serve  # noqa: E402
from benchmarks import bench_turnstile as ref_turnstile  # noqa: E402
from benchmarks.torch_port import bench_resilience as port_resilience  # noqa: E402
from benchmarks.torch_port import bench_serve as port_serve  # noqa: E402
from benchmarks.torch_port import bench_turnstile as port_turnstile  # noqa: E402
from test_torch_benchmarks import _both, _pick  # noqa: E402


def test_bench_turnstile_matches_reference(tmp_path):
    argv = ["--n", "1500", "--planted-k", "60", "--trials", "2", "--batch", "4096",
            "--sample-edges", "1024", "--query-repeats", "1", "--scaling-deg", "8"]
    port, ref = _both(port_turnstile, ref_turnstile, tmp_path, argv, "turnstile")
    assert port["config"] == ref["config"]
    keys = ("seed", "m_inserted", "m_deleted", "m_live", "sample_level",
            "sample_edges_recovered", "recovery_failures", "density_turnstile",
            "density_exact_peel", "ratio", "in_envelope")
    for got, want in zip(port["trials"], ref["trials"]):
        assert _pick(got, keys) == _pick(want, keys)
        assert got["k3_launches"] == 0 and got["batches_applied"] > 0
    assert len(port["trials"]) == len(ref["trials"]) == 2
    assert port["accuracy"] == ref["accuracy"]
    assert [s["m_live"] for s in port["scaling"]] == [s["m_live"] for s in ref["scaling"]]
    assert (port["update_throughput"]["steady_state_trials"]
            == ref["update_throughput"]["steady_state_trials"])


def test_bench_serve_matches_reference(tmp_path):
    argv = ["--n", "2000", "--queries", "8", "--max-batch", "4", "--repeats", "1",
            "--sweep-sizes", "2000,3000", "--sweep-queries", "4", "--skip-cold-start"]
    port, ref = _both(port_serve, ref_serve, tmp_path, argv, "serve")
    assert port["config"] == ref["config"]
    keys = ("distinct_buckets", "lanes_solved", "pad_lanes")
    assert _pick(port["batched"], keys) == _pick(ref["batched"], keys)
    assert port["bit_identical_to_solve"] is ref["bit_identical_to_solve"] is True
    sw, rsw = port["local_vs_bfs_sweep"], ref["local_vs_bfs_sweep"]
    for k in ("sizes", "queries", "bfs_radius", "local_budget", "local_work_growth_x",
              "bfs_work_growth_x"):
        assert sw[k] == rsw[k], k
    for mode, keys in (("bfs", ("n", "mean_extracted_nodes")),
                       ("local", ("n", "mean_extracted_nodes", "mean_nodes_touched",
                                  "mean_edges_scanned"))):
        assert [_pick(p, keys) for p in sw[mode]] == [_pick(p, keys) for p in rsw[mode]]


def test_bench_serve_cold_start_children(tmp_path):
    """The port's cold-start protocol on the CPU: two fresh processes that
    import neither JAX nor the JAX package answer the same density, and
    the second runs no build (the kernels load only on the card)."""
    args = port_serve.parse_args(["--n", "2000", "--device", "cpu",
                                  "--cache-dir", str(tmp_path / "cache")])
    got = port_serve.cold_start(args, port_serve.common.device_of(args), seed=5)
    assert got["kernels"] == []
    assert got["uncached_nvcc_runs"] == got["warm_disk_nvcc_runs"] == 0
    assert "jax" not in port_serve._CHILD and "repro." not in port_serve._CHILD


@pytest.fixture
def far_deadline(monkeypatch):
    """Both packages' resilience benches with a deadline out of reach."""
    import dataclasses

    for mod in (ref_resilience, port_resilience):
        real = mod.ResilienceConfig
        monkeypatch.setattr(mod, "ResilienceConfig", lambda real=real, **kw: dataclasses.replace(
            real(**kw), deadline_ms=600_000.0))


def test_bench_resilience_matches_reference(tmp_path, far_deadline):
    argv = ["--n", "2000", "--queries", "16", "--max-batch", "4", "--repeats", "1"]
    port, ref = _both(port_resilience, ref_resilience, tmp_path, argv, "resilience")
    cfg, rcfg = dict(port["config"]), dict(ref["config"])
    assert cfg == rcfg
    assert port["fault_free_bit_identical"] is ref["fault_free_bit_identical"] is True
    keys = ("storm_seed", "fail_prob", "injected_failures", "solve_hits", "outcomes",
            "answered_fraction", "fabricated_results", "solve_retries", "deadline_stops",
            "breaker_open_skips")
    assert _pick(port["fault_storm"], keys) == _pick(ref["fault_storm"], keys)
    assert port["fault_storm"]["fabricated_results"] == 0
