"""Mirror of tests/test_property_core.py: the reference's three hypothesis
properties of the core peeling algorithms, run against the port
(``repro_torch``) on the CPU, at the reference's example counts.

The port refuses a default device without CUDA (``graph/edgelist.py``), so
every graph is built with ``device="cpu"``; the strategies and assertions
are the reference's.
"""

import numpy as np
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="hypothesis not installed; property tests skipped"
)
from hypothesis import given, settings, strategies as st

from repro_torch.core import (
    densest_subgraph,
    densest_subgraph_at_least_k,
    densest_subgraph_brute,
    density_of,
    max_passes_bound,
)
from repro_torch.graph import from_numpy


@st.composite
def small_graphs(draw):
    n = draw(st.integers(4, 12))
    m = draw(st.integers(3, 30))
    src = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m).map(np.asarray))
    dst = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m).map(np.asarray))
    keep = src != dst
    if keep.sum() == 0:
        src = np.asarray([0])
        dst = np.asarray([1])
        keep = np.asarray([True])
    return from_numpy(src[keep], dst[keep], n, device="cpu")


@given(small_graphs(), st.sampled_from([0.1, 0.5, 1.0]))
@settings(max_examples=25, deadline=None)
def test_property_approximation_and_passes(edges, eps):
    _, rho_star = densest_subgraph_brute(edges)
    res = densest_subgraph(edges, eps=eps)
    # (2+2eps) guarantee and validity.
    assert float(res.best_density) >= rho_star / (2 * (1 + eps)) - 1e-5
    assert float(res.best_density) <= rho_star + 1e-5
    # Pass bound.
    assert int(res.passes) <= max_passes_bound(edges.n_nodes, eps)
    # Reported density is the density of the reported set.
    assert float(density_of(edges, res.best_alive)) == pytest.approx(
        float(res.best_density), rel=1e-5, abs=1e-6
    )


@given(small_graphs(), st.integers(2, 6))
@settings(max_examples=15, deadline=None)
def test_property_topk_size(edges, k):
    res = densest_subgraph_at_least_k(edges, k=min(k, edges.n_nodes), eps=0.5)
    assert int(res.best_size) >= min(k, edges.n_nodes)


@given(
    st.integers(8, 40),
    st.floats(0.05, 1.5),
    st.integers(0, 10_000),
)
@settings(max_examples=15, deadline=None)
def test_property_monotone_under_weight_scaling(n, scale, seed):
    """rho scales linearly with uniform edge-weight scaling; the best set is
    unchanged."""
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    if keep.sum() < 2:
        return
    w = rng.uniform(0.5, 2.0, keep.sum()).astype(np.float32)
    e1 = from_numpy(src[keep], dst[keep], n, weight=w, device="cpu")
    e2 = from_numpy(src[keep], dst[keep], n, weight=w * scale, device="cpu")
    r1 = densest_subgraph(e1, eps=0.5)
    r2 = densest_subgraph(e2, eps=0.5)
    assert float(r2.best_density) == pytest.approx(scale * float(r1.best_density), rel=1e-4)
    assert (np.asarray(r1.best_alive) == np.asarray(r2.best_alive)).all()
