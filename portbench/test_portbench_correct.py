"""What decides ``correct``, driven through the rest of a run on the CPU at a
test size: the program comes out correct; the control (the reference in
bfloat16 in the program's place) and each fault planted in the program
come out not correct."""

import dataclasses

import pytest
import torch

from portbench import run as harness
from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
TINY = {"n_nodes": 3000, "draws": 15000}
# At 3,000 nodes some seeds give a best set whose density bfloat16 holds
# exactly; from 20,000 nodes on, the control's densities depart.
CONTROL_SIZE = {"n_nodes": 20000, "draws": 100000}


def _sized(cell_name, size):
    cell = spec.load_cell(cell_name)
    return dataclasses.replace(cell, config=dict(cell.config, **size))


def _run(cell_name, size=TINY, seed=2**31 + 99, **kw):
    return harness.run_cell(_sized(cell_name, size), seed, 0.2, False, "cpu",
                            log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    want = {m.name for m in spec.load_cell(cell).metrics_of("end_to_end")}
    assert set(out["metrics"]) == want - {"peak_device_mb"}  # no allocator peak on the CPU


@pytest.mark.parametrize("seed", [7, 123, 2**31 + 99])
@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell, seed):
    out = _run(cell, CONTROL_SIZE, seed, control="bfloat16")
    assert not out["correct"]
    c = out["checks"]
    assert c["wrong_answers"]["value"] > 0
    assert c["density_gap"]["value"] > c["density_gap"]["limit"]


def test_density_gap_counts_only_past_its_limit():
    # The float32 sum's last place (a gap under the limit) is no wrong
    # answer; a gap past it is, as are a set, a size or passes that differ.
    import numpy as np

    from portbench import check
    from portbench.queries import Result
    from portbench.reference import Answer

    ref = Answer(nodes=np.arange(5), density=14.2355318, size=5, passes=7)
    lim = check.LIMITS["density_gap"]

    def answer(**kw):
        return Result(answers=(ref._replace(**kw),), provenance=None)

    results = [answer(density=ref.density * (1 + lim / 4)), answer(density=ref.density * (1 + 4 * lim)),
               answer(passes=8), answer(nodes=np.arange(1, 6))]
    c = check.compare(results, [ref], {})
    assert c["wrong_answers"]["value"] == 3
    assert c["density_gap"]["value"] == pytest.approx(4 * lim)
    assert c["density_gap"]["limit"] == lim
    assert check.is_correct(check.compare(results[:1], [ref], {}), 1)


def _state_unchanged(monkeypatch):
    from repro_torch.core import engine

    def removal(self, s_alive, t_alive, deg_s, deg_t, stats):
        return torch.zeros_like(s_alive), None

    monkeypatch.setattr(engine.UndirectedThreshold, "removal", removal)


def _half_the_edges(monkeypatch):
    """Degrees from the first half of the edges, doubled."""
    from repro_torch.core import engine
    from repro_torch.kernels.peel_degree import ops

    def halve(w):
        w = w.clone()
        w[..., w.shape[-1] // 2:] = 0
        return 2 * w

    exact = engine.segment_degree_count
    tiled = ops.tiled_degrees
    monkeypatch.setattr(engine, "segment_degree_count",
                        lambda src, dst, w, n: exact(src, dst, halve(w), n))
    monkeypatch.setattr(ops, "tiled_degrees",
                        lambda tiling, w, n_nodes: tiled(tiling, halve(w), n_nodes=n_nodes))


def _answer_altered(monkeypatch):
    """Node 0, the top hub, flipped in the answer where the front door
    makes it."""
    from repro_torch.core import api

    wrap = api.Solver._wrap

    def altered(self, out, *a, **kw):
        res = wrap(self, out, *a, **kw)
        best = res.best_alive.clone()
        best[..., 0] = ~best[..., 0]
        return dataclasses.replace(res, best_alive=best)

    monkeypatch.setattr(api.Solver, "_wrap", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_edges": _half_the_edges,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"], (fault, out["checks"])
    assert out["checks"]["wrong_answers"]["value"] > 0
