"""Port parity of the layered neighbor sampler (``repro_torch.graph.sampler``)
against ``repro.graph.sampler``: the CSR (``indptr`` and ``indices``) and
every hop array and mask, bit for bit, on graphs with isolated nodes,
low-degree nodes (sampled without replacement) and hubs (with
replacement); the cursor's ``checkpoint_state``/``restore`` round trip;
and the synthetic batches the cells draw (``gnn_full_batch``,
``gnn_molecule_batch``), equal to the reference's arrays."""

import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.graph import sampler as ref_sampler
from repro_torch.data import synthetic
from repro_torch.graph import sampler


def _graph(seed, n=300, e=1500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 20, e).astype(np.int32)  # nodes n-20.. stay isolated
    dst = rng.integers(0, n - 20, e).astype(np.int32)
    hub = rng.integers(0, n - 20, 200).astype(np.int32)  # node 0: a hub
    return np.concatenate([src, np.zeros(200, np.int32)]), np.concatenate([dst, hub]), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_equals_reference_bitwise(seed):
    src, dst, n = _graph(seed)
    want = ref_sampler.CSRGraph.from_edges(src, dst, n)
    got = sampler.CSRGraph.from_edges(src, dst, n, device="cpu")
    assert got.indptr.dtype == want.indptr.dtype == np.int64
    assert got.indices.dtype == want.indices.dtype == np.int32
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.n_nodes == want.n_nodes == n
    # The control: an unstable order of the same sources gives other indices.
    order = np.argsort(np.concatenate([src, dst]), kind="quicksort")
    assert not np.array_equal(np.concatenate([dst, src])[order], want.indices)


def test_csr_takes_tensors():
    src, dst, n = _graph(3)
    want = ref_sampler.CSRGraph.from_edges(src, dst, n)
    got = sampler.CSRGraph.from_edges(torch.from_numpy(src), torch.from_numpy(dst), n,
                                      device="cpu")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.indptr, want.indptr)


def _samplers(seed, fanout=(6, 4), batch_nodes=32):
    src, dst, n = _graph(seed)
    labels = np.random.default_rng(seed + 10).integers(0, 7, n).astype(np.int32)
    ref = ref_sampler.LayeredSampler(ref_sampler.CSRGraph.from_edges(src, dst, n), labels,
                                     batch_nodes, fanout, seed=seed)
    port = sampler.LayeredSampler(sampler.CSRGraph.from_edges(src, dst, n, device="cpu"),
                                  labels, batch_nodes, fanout, seed=seed)
    return ref, port


def _assert_block_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_hops_equal_reference_bitwise(seed):
    ref, port = _samplers(seed)
    kinds = set()
    for _ in range(4):
        want, got = next(ref), next(port)
        _assert_block_equal(got, want)
        m1 = want["hop1_mask"]
        kinds |= {"masked" if (m1 == 0).any() else "full"}
    assert port.step == ref.step == 4
    # Isolated roots self-loop, masked out; hub 0 is sampled with replacement.
    assert "masked" in kinds


def test_sampler_covers_all_three_cases():
    """A root of degree 0 (self-loop, mask 0), of degree <= fanout (all its
    neighbors once) and of degree > fanout (fanout draws)."""
    src, dst, n = _graph(0)
    g = sampler.CSRGraph.from_edges(src, dst, n, device="cpu")
    deg = np.diff(g.indptr)
    nodes = np.asarray([n - 1, int(np.argmax((deg > 0) & (deg <= 6))), 0], np.int32)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    out, mask = sampler._sample_neighbors(g, nodes, 6, rng_a)
    want_out, want_mask = ref_sampler._sample_neighbors(
        ref_sampler.CSRGraph(g.indptr, g.indices), nodes, 6, rng_b)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(mask, want_mask)
    assert (out[0] == n - 1).all() and mask[0].sum() == 0
    assert mask[1].sum() == deg[nodes[1]] and mask[2].sum() == 6


def test_restore_round_trip():
    """A sampler restored from another's cursor draws the same blocks, and
    the port resumes the reference's cursor (and back)."""
    ref, port = _samplers(4)
    for _ in range(3):
        next(port)
        next(ref)
    state = port.checkpoint_state()
    assert state == ref.checkpoint_state() == {"seed": 4, "step": 3}
    ahead = [next(port) for _ in range(2)]
    fresh = _samplers(4)[1]
    fresh.restore(state)
    for want in ahead:
        _assert_block_equal(next(fresh), want)
    ref2 = _samplers(4)[0]
    ref2.restore(state)
    _assert_block_equal(ahead[0], next(ref2))
    # The control: a cursor one step off draws another block.
    off = _samplers(4)[1]
    off.restore({"seed": 4, "step": 4})
    assert not np.array_equal(next(off)["hop0"], ahead[0]["hop0"])


@pytest.mark.parametrize("positions", [False, True])
def test_synthetic_graph_batches_equal_reference(positions):
    want = ref_synthetic.gnn_full_batch(np.random.default_rng(7), 50, 200, 6, 3, positions)
    got = synthetic.gnn_full_batch(np.random.default_rng(7), 50, 200, 6, 3, positions,
                                   device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    want = ref_synthetic.gnn_molecule_batch(np.random.default_rng(8), 3, 10, 20, 4, positions)
    got = synthetic.gnn_molecule_batch(np.random.default_rng(8), 3, 10, 20, 4, positions,
                                       device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_needs_positions_matches_reference():
    for arch in ("mace", "egnn", "equiformer-v2", "graphsage-reddit", "two-tower-retrieval"):
        assert synthetic._gnn_needs_positions(arch) == ref_synthetic._gnn_needs_positions(arch)
