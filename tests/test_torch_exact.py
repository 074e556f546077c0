"""Port parity: the numpy baselines and host helpers of this slice —
``core/exact.py`` (Goldberg max-flow and the brute-force oracles, the
mirror of tests/test_exact.py), ``core/charikar.py``,
``graph/edgelist.py::to_csr``, the directed generators and
``core/density.py``'s statistics — against the reference on the same
seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import charikar as ref_charikar
from repro.core import density as ref_density
from repro.core import exact as ref_exact
from repro.graph import edgelist as ref_edgelist
from repro.graph import from_numpy as ref_from_numpy
from repro.graph import generators as ref_gen
from repro_torch.core import charikar, density, exact
from repro_torch.graph import edgelist, generators
from repro_torch.graph.edgelist import from_numpy


def _port(e):
    return edgelist.from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


@pytest.mark.parametrize("seed", range(6))
def test_flow_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = 11
    m = rng.integers(8, 26)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    edges = from_numpy(src[keep], dst[keep], n, device="cpu")
    _, rho_brute = exact.densest_subgraph_brute(edges)
    nodes, rho_flow = exact.densest_subgraph_exact(edges)
    assert rho_flow == pytest.approx(rho_brute, abs=1e-9)
    s, d = src[keep], dst[keep]
    inset = np.zeros(n, bool)
    inset[nodes] = True
    assert np.sum(inset[s] & inset[d]) / len(nodes) == pytest.approx(rho_brute)
    ref = ref_from_numpy(src[keep], dst[keep], n)
    ref_nodes, ref_rho = ref_exact.densest_subgraph_exact(ref)
    np.testing.assert_array_equal(nodes, ref_nodes)
    assert rho_flow == ref_rho
    assert exact.densest_subgraph_brute(edges)[1] == ref_exact.densest_subgraph_brute(ref)[1]


def test_exact_on_clique_with_tail():
    src = [0, 0, 0, 0, 1, 1, 1, 2, 2, 3] + list(range(4, 14))
    dst = [1, 2, 3, 4, 2, 3, 4, 3, 4, 4] + list(range(5, 15))
    nodes, rho = exact.densest_subgraph_exact(from_numpy(src, dst, 15, device="cpu"))
    assert rho == pytest.approx(2.0)
    assert set(nodes.tolist()) == {0, 1, 2, 3, 4}


def test_exact_scales_to_moderate_graphs():
    ref = ref_gen.erdos_renyi(300, avg_deg=10, seed=0)
    nodes, rho = exact.densest_subgraph_exact(_port(ref))
    assert rho >= 5.0 and 0 < len(nodes) <= 300
    ref_nodes, ref_rho = ref_exact.densest_subgraph_exact(ref)
    np.testing.assert_array_equal(nodes, ref_nodes)
    assert rho == ref_rho


@pytest.mark.parametrize("seed", range(3))
def test_directed_brute_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 6
    src, dst = rng.integers(0, n, 12), rng.integers(0, n, 12)
    keep = src != dst
    got = exact.densest_directed_brute(from_numpy(src[keep], dst[keep], n, directed=True,
                                                  device="cpu"))
    want = ref_exact.densest_directed_brute(ref_from_numpy(src[keep], dst[keep], n,
                                                           directed=True))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("graph", ["er", "planted", "weighted"])
def test_charikar_and_to_csr_match_reference(graph):
    if graph == "er":
        ref = ref_gen.erdos_renyi(400, avg_deg=6, seed=2)
    elif graph == "planted":
        ref = ref_gen.planted_dense_subgraph(300, avg_deg=4, k=20, p_dense=0.8, seed=1)[0]
    else:
        ref = ref_gen.weighted_preferential(40, seed=0)
    pe = _port(ref)
    for weights in (False, True):
        got = edgelist.to_csr(pe, return_weights=weights)
        want = ref_edgelist.to_csr(ref, return_weights=weights)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    if graph != "weighted":
        nodes, rho = charikar.charikar_greedy(pe)
        ref_nodes, ref_rho = ref_charikar.charikar_greedy(ref)
        np.testing.assert_array_equal(nodes, ref_nodes)
        assert rho == ref_rho


def test_to_csr_directed_is_the_out_adjacency():
    ref = ref_gen.directed_planted(200, avg_deg=3, ks=10, kt=8, p_dense=0.5, seed=0)[0]
    for g, w in zip(edgelist.to_csr(_port(ref)), ref_edgelist.to_csr(ref)):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kw", [dict(n=300, avg_deg=3, ks=20, kt=15, p_dense=0.9, seed=1),
                                dict(n=20_000, avg_deg=5.0, ks=200, kt=50, p_dense=0.3, seed=0)])
def test_directed_planted_equals_reference(kw):
    got, s_ids, t_ids = generators.directed_planted(**kw, device="cpu")
    want, rs, rt = ref_gen.directed_planted(**kw)
    for f in ("src", "dst", "weight", "mask"):
        assert getattr(got, f).numpy().tobytes() == np.asarray(getattr(want, f)).tobytes(), f
    assert got.directed and got.n_nodes == want.n_nodes
    np.testing.assert_array_equal(s_ids, rs)
    np.testing.assert_array_equal(t_ids, rt)


def test_bipartite_spam_equals_reference():
    kw = dict(n_users=500, n_items=300, avg_deg=4, spam_users=20, spam_items=10, p_spam=0.8,
              seed=3)
    got, su, si = generators.bipartite_spam(**kw, device="cpu")
    want, rsu, rsi = ref_gen.bipartite_spam(**kw)
    for f in ("src", "dst", "weight", "mask"):
        assert getattr(got, f).numpy().tobytes() == np.asarray(getattr(want, f)).tobytes(), f
    np.testing.assert_array_equal(su, rsu)
    np.testing.assert_array_equal(si, rsi)


def test_density_stats_match_reference():
    ref = ref_gen.directed_planted(250, avg_deg=4, ks=15, kt=10, p_dense=0.7, seed=2)[0]
    pe = _port(ref)
    s_al = np.random.default_rng(0).random(ref.n_nodes) < 0.7
    t_al = np.random.default_rng(1).random(ref.n_nodes) < 0.6
    got = density.directed_stats(pe, torch.from_numpy(s_al), torch.from_numpy(t_al))
    want = ref_density.directed_stats(ref, jnp.asarray(s_al), jnp.asarray(t_al))
    for g, w in zip(got[:5], want[:5]):
        assert g.numpy().tobytes() == np.asarray(w).astype(g.numpy().dtype).tobytes()
    # The reference's CPU code multiplies by an approximate rsqrt: 1 ulp.
    ulps = abs(int(got.density.numpy().view(np.int32)) - int(np.asarray(want.density).view(np.int32)))
    assert ulps <= 1
    und = ref_gen.planted_dense_subgraph(250, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]
    got_u = density.undirected_stats(_port(und), torch.from_numpy(s_al))
    want_u = ref_density.undirected_stats(und, jnp.asarray(s_al))
    for g, w in zip(got_u, want_u):
        assert g.numpy().tobytes() == np.asarray(w).astype(g.numpy().dtype).tobytes()
    assert float(density.density_of(_port(und), torch.from_numpy(s_al))) == float(
        ref_density.density_of(und, jnp.asarray(s_al)))


@pytest.mark.parametrize("directed", [False, True])
def test_dedup_edges_equals_reference(directed):
    """Self loops dropped, duplicates (and, undirected, reversed pairs)
    kept once, in the reference's key order."""
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 300, 5000), rng.integers(0, 300, 5000)
    got = edgelist.dedup_edges(src, dst, directed=directed)
    want = ref_edgelist.dedup_edges(src, dst, directed=directed)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and g.tobytes() == np.asarray(w).tobytes()
    empty = edgelist.dedup_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), directed=directed)
    assert all(e.shape == (0,) and e.dtype == np.int32 for e in empty)
