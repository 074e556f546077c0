"""Port parity: the tiled-degree kernel's plain version against the
reference's K1 (``repro.kernels.peel_degree``), run as the reference's own
tests run it on the CPU (Pallas in interpret mode, and its jnp oracle).

Integer-valued weights are bitwise equal; float weights agree within
rtol/atol 1e-5 (f32 reassociation: the sums are taken in another order).
The kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against this plain version and skips here with a reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.partition import bucket_edges_by_tile as ref_bucket
from repro.kernels.peel_degree.ops import tiled_degrees as ref_tiled_degrees
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels.peel_degree.ops import tiled_degrees
from repro_torch.kernels.peel_degree.ref import degrees_from_tiled

# The shapes of tests/test_kernels.py::test_peel_degree_kernel_matches_ref.
SHAPES = [
    (100, 400, 32, 64),
    (1000, 5000, 128, 128),
    (257, 1000, 64, 256),  # n_nodes not a tile multiple
    (64, 50, 64, 64),  # single tile, fewer edges than block
]


def _case(n_nodes, n_edges, integer, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    if integer:
        w = rng.integers(0, 4, n_edges).astype(np.float32)  # 0 = a dead edge
    else:
        w = rng.random(n_edges).astype(np.float32)
    return src, dst, w


def _port_tiling(src, dst, n_nodes, tile_size, device="cpu"):
    return bucket_edges_by_tile(
        torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device),
        n_nodes, tile_size=tile_size,
    )


def _assert_match(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_nodes,n_edges,tile_size,block_e", SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_plain_matches_reference_k1(n_nodes, n_edges, tile_size, block_e, integer):
    src, dst, w = _case(n_nodes, n_edges, integer)
    dense = ref_bucket(src, dst, n_nodes, tile_size, block_e)
    tl, ei, wa = jnp.asarray(dense.target_local), jnp.asarray(dense.edge_index), jnp.asarray(w)
    kw = dict(tile_size=tile_size, n_nodes=n_nodes)
    want_pallas = np.asarray(ref_tiled_degrees(tl, ei, wa, use_pallas=True, interpret=True, **kw))
    want_oracle = np.asarray(ref_tiled_degrees(tl, ei, wa, use_pallas=False, **kw))

    tiling = _port_tiling(src, dst, n_nodes, tile_size)
    got = tiled_degrees(tiling, torch.from_numpy(w), n_nodes=n_nodes).numpy()
    assert got.dtype == np.float32 and got.shape == (n_nodes,)
    _assert_match(got, want_oracle, integer)
    _assert_match(got, want_pallas, integer)

    # And against a direct numpy count.
    deg = np.zeros(n_nodes, np.float64)
    np.add.at(deg, src, w)
    np.add.at(deg, dst, w)
    np.testing.assert_allclose(got, deg, rtol=1e-5, atol=1e-4)
    if integer:
        np.testing.assert_array_equal(got, deg.astype(np.float32))


def _dense_as_ragged(tiling: TiledEdges, block: int, pad_tl: int, pad_ei: int):
    """The reference's dense rectangle, fed to the port as a ragged layout
    whose every row is a tile (padding slots included)."""
    tl, sg, ei = tiling.to_dense(block)
    pad = ei < 0
    tl[pad] = pad_tl
    ei[pad] = pad_ei
    n_tiles, width = tl.shape
    return TiledEdges.from_ragged(
        torch.arange(n_tiles + 1, dtype=torch.int64) * width,
        tl.reshape(-1), sg.reshape(-1), ei.reshape(-1),
        tile_size=tiling.tile_size, n_nodes=tiling.n_nodes, n_edges=tiling.n_edges,
    )


@pytest.mark.parametrize("pad_tl,pad_ei", [(0, -1), (-1, -1), (-1, 0)])
def test_plain_ignores_dense_padding(pad_tl, pad_ei):
    """Padding slots add nothing under either convention of the reference:
    ``target_local`` 0 with ``edge_index`` -1 (partition.py), or
    ``target_local`` -1 (the oracle's docstring), whatever its edge index."""
    n_nodes, tile_size = 257, 64
    src, dst, w = _case(n_nodes, 1000, integer=True, seed=3)
    tiling = _port_tiling(src, dst, n_nodes, tile_size)
    want = tiled_degrees(tiling, torch.from_numpy(w), n_nodes=n_nodes)
    dense = _dense_as_ragged(tiling, 256, pad_tl, pad_ei)
    got = tiled_degrees(dense, torch.from_numpy(w), n_nodes=n_nodes)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_rejects_bad_inputs():
    src, dst, w = _case(100, 400, integer=True)
    tiling = _port_tiling(src, dst, 100, 32)
    wt = torch.from_numpy(w)
    with pytest.raises(ValueError, match="float32"):
        tiled_degrees(tiling, wt.double(), n_nodes=100)
    with pytest.raises(ValueError, match="entries"):
        tiled_degrees(tiling, wt[:-1].contiguous(), n_nodes=100)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_degrees(tiling, torch.stack([wt, wt], 1)[:, 0], n_nodes=100)
    with pytest.raises(ValueError, match="node range"):
        tiled_degrees(tiling, wt, n_nodes=10_000)
    big = _port_tiling(src, dst, 100, 100_000)
    with pytest.raises(ValueError, match="shared-memory"):
        tiled_degrees(big, wt, n_nodes=100)


def test_degrees_from_tiled_drops_tile_padding():
    deg = torch.arange(12, dtype=torch.float32)
    np.testing.assert_array_equal(degrees_from_tiled(deg, 10).numpy(), np.arange(10))
