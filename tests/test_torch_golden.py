"""The JAX golden fixture for the card stays true: every entry of
tests/fixtures/torch_port/golden.json (cells exact, pallas, sketch and
turnstile, on two graphs) is recomputed with ``repro`` here, and the port's
CPU answers meet it too (``chip_smoke.py`` holds the port's CUDA
answers against the same file, on a machine without JAX)."""

import json
import os
import sys

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
