"""The JAX golden fixture for the card stays true: every entry of
tests/fixtures/torch_port/golden.json (cells exact, pallas, sketch and
turnstile, on two graphs; Algorithms 2 and 3 and an eps sweep; the
semi-streaming substrate; the §5.2 mesh substrate on 4 devices; per-seed
serving in both extraction modes and the local front door; the REDUCED
llama3.2-3b's prefill logits, greedy tokens and margins; one training
step of each LM arch's REDUCED config; one training step of each GNN arch's
and the two-tower model's REDUCED config, the two-tower serve and top-k
scores, and the communities of examples/community_gnn.py) is recomputed with ``repro`` here, and the port's CPU
answers meet it too (``chip_smoke.py`` holds the port's CUDA answers
against the same file, on a machine without JAX)."""

import functools
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_port_golden as golden  # noqa: E402


def _load():
    with open(golden.GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(golden.GRAPHS))
@pytest.mark.parametrize("backend", golden.CELLS)
def test_golden_fixture_matches_reference(name, backend):
    fixture = _load()
    assert fixture["eps"] == golden.EPS
    assert fixture["graphs"][name]["kwargs"] == golden.GRAPHS[name][1]
    assert fixture["answers"][name][backend] == golden.reference_entry(name, backend)


@pytest.mark.parametrize("name", sorted(golden.GRAPHS))
@pytest.mark.parametrize("backend", golden.CELLS)
def test_port_cpu_meets_golden(name, backend):
    from repro_torch.graph import generators

    gen, kw = golden.GRAPHS[name]
    out = getattr(generators, gen)(**kw, device="cpu")
    edges = out[0] if isinstance(out, tuple) else out
    assert golden.port_entry(edges, backend) == _load()["answers"][name][backend]


# -- the objectives entries (at_least_k, directed, one eps sweep) -------------


@pytest.mark.parametrize("case", golden.OBJECTIVE_CASES)
def test_objective_golden_matches_reference(case):
    fixture = _load()["objectives"]
    assert fixture["at_least_k"] == golden.AT_LEAST_K
    assert fixture["directed"]["kwargs"] == golden.DIRECTED_GRAPH[1]
    assert fixture["answers"][case] == golden.reference_objective_entry(case)


@pytest.mark.parametrize("case", golden.OBJECTIVE_CASES)
def test_port_cpu_meets_objective_golden(case):
    assert golden.port_objective_entry(case, "cpu") == _load()["objectives"]["answers"][case]


# -- the streaming entries (the semi-streaming substrate) ---------------------


@pytest.mark.parametrize("case", sorted(golden.STREAM_CASES))
def test_stream_golden_matches_reference(case):
    fixture = _load()["streaming"]
    assert fixture["cases"][case] == golden.STREAM_CASES[case]
    assert fixture["answers"][case] == golden.reference_stream_entry(case)


@pytest.mark.parametrize("case", sorted(golden.STREAM_CASES))
def test_port_cpu_meets_stream_golden(case):
    assert golden.port_stream_entry(case, "cpu") == _load()["streaming"]["answers"][case]


# -- the mesh entries (the §5.2 mesh substrate on 4 devices) -----------------


@functools.lru_cache(maxsize=1)
def _mesh_reference() -> dict:
    """Every mesh entry, recomputed by the JAX package in one child process
    with 4 host devices (at most 600 s)."""
    return golden.reference_mesh_entries(timeout=600)


@pytest.mark.parametrize("case", sorted(golden.MESH_CASES))
def test_mesh_golden_matches_reference(case):
    """The port's 4 gloo ranks meet these entries in
    tests/test_torch_mapreduce.py."""
    fixture = _load()["mesh"]
    assert fixture["devices"] == golden.MESH_DEVICES
    assert fixture["cases"][case] == golden.MESH_CASES[case]
    assert fixture["answers"][case] == _mesh_reference()[case]


# -- the serve entries (the query engine in both modes, the local front door) --


@pytest.mark.parametrize("case", golden.SERVE_CASES)
def test_serve_golden_matches_reference(case):
    fixture = _load()["serve"]
    assert fixture["problem"] == golden.SERVE_PROBLEM and fixture["engine"] == golden.SERVE_ENGINE
    assert fixture["queries"] == golden.SERVE_QUERIES
    assert fixture["answers"][case] == golden.reference_serve_entry(case)


@pytest.mark.parametrize("case", golden.SERVE_CASES)
def test_port_cpu_meets_serve_golden(case):
    assert golden.port_serve_entry(case, "cpu") == _load()["serve"]["answers"][case]


# -- the LM entries (REDUCED llama3.2-3b, float32 compute) ---------------------


@pytest.mark.parametrize("case", sorted(golden.LM_CASES))
def test_lm_golden_matches_reference(case):
    """The JAX package recomputes the entry: tokens equal, floats within
    1e-6 (XLA's CPU code may sum in another order on another machine)."""
    fixture = _load()["lm"]
    assert fixture["arch"] == golden.LM_ARCH and fixture["seed"] == golden.LM_SEED
    want = fixture["answers"][case]
    assert golden.lm_mismatch(golden.reference_lm_entry(case), want, tol=1e-6) is None
    # No tie can flip a token: every greedy token leads the runner-up by
    # far more than the logits' tolerance.
    least = min(min(m) for m in want["margins"])
    assert least > 5 * golden.LM_LOGITS_TOL * (1 + np.abs(want["prefill_logits"]).max())


@pytest.mark.parametrize("case", sorted(golden.LM_CASES))
def test_port_cpu_meets_lm_golden(case):
    got = golden.port_lm_entry(case, "cpu")
    assert golden.lm_mismatch(got, _load()["lm"]["answers"][case]) is None


# -- the LM training entries (the five LM archs' REDUCED configs, float32) -----


@pytest.mark.parametrize("arch", golden.LM_TRAIN_ARCHS)
def test_lm_train_golden_matches_reference(arch):
    """The JAX package recomputes the entry: the loss, its metrics and the
    grad norm within 1e-6, the leaf sums within 1e-6 plus the sums' own
    allowance (XLA's CPU code may sum in another order on another machine)."""
    fixture = _load()["lm_train"]
    assert fixture["seed"] == golden.LM_SEED and fixture["case"] == golden.LM_TRAIN_CASE
    want = fixture["answers"][arch]
    assert golden.lm_train_mismatch(golden.reference_lm_train_entry(arch), want, tol=1e-6) is None


@pytest.mark.parametrize("arch", golden.LM_TRAIN_ARCHS)
def test_port_cpu_meets_lm_train_golden(arch):
    got = golden.port_lm_train_entry(arch, "cpu")
    assert golden.lm_train_mismatch(got, _load()["lm_train"]["answers"][arch]) is None


# -- the GNN and recsys training entries (REDUCED configs, float32) -------------


@pytest.mark.parametrize("arch", golden.GNN_TRAIN_ARCHS)
def test_gnn_train_golden_matches_reference(arch):
    """The JAX package recomputes the entry within 1e-6 (the sums within
    1e-6 plus their own allowance)."""
    fixture = _load()["gnn_train"]
    assert fixture["case"] == golden.GNN_TRAIN_CASE and fixture["shape"] == golden.GNN_TRAIN_SHAPE
    assert fixture["recsys_batch"] == golden.RECSYS_TRAIN_BATCH
    assert fixture["retrieval"] == golden.RECSYS_RETRIEVAL
    want = fixture["answers"][arch]
    assert golden.gnn_train_mismatch(golden.reference_gnn_train_entry(arch), want,
                                     tol=1e-6) is None


@pytest.mark.parametrize("arch", golden.GNN_TRAIN_ARCHS)
def test_port_cpu_meets_gnn_train_golden(arch):
    got = golden.port_gnn_train_entry(arch, "cpu")
    assert golden.gnn_train_mismatch(got, _load()["gnn_train"]["answers"][arch]) is None


def test_community_golden_matches_reference_and_port():
    """examples/community_gnn.py's communities: the reference recomputes
    them exactly, and the port's peel on the CPU meets them exactly (unit
    weights: the densities are the same floats)."""
    fixture = _load()["gnn_train"]["community"]
    assert fixture["case"] == {**golden.COMMUNITY, "p_in": list(golden.COMMUNITY["p_in"])}
    assert golden.reference_community_entry() == fixture["answers"]
    assert golden.port_community_entry("cpu") == fixture["answers"]
