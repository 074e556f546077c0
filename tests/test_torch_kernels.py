"""Port parity: the kernels' plain versions against the reference's
kernels, run as the reference's own tests run them on the CPU (Pallas in
interpret mode, and their jnp oracles): K1 tiled degrees
(``repro.kernels.peel_degree``), K2 the Count-Sketch update
(``repro.kernels.count_sketch``), K3 the l0-sampler update
(``repro.kernels.l0_sampler``).

Integer-valued weights and K3's integer sums are bitwise equal; float
weights agree within rtol/atol 1e-5 (K1) and 1e-4 (K2, the tolerance of
tests/test_kernels.py): f32 reassociation, the sums are taken in another
order.  The kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions and skips here with a reason.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.countsketch import make_sketch_params as ref_sketch_params
from repro.graph.partition import bucket_edges_by_tile as ref_bucket
from repro.kernels.count_sketch.ops import count_sketch_update as ref_cs_update
from repro.kernels.count_sketch.ops import sketch_edges as ref_sketch_edges
from repro.kernels.l0_sampler import ops as ref_l0
from repro.kernels.peel_degree.ops import tiled_degrees as ref_tiled_degrees
from repro_torch.core.countsketch import make_sketch_params
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels import hashing, source_digest
from repro_torch.kernels.count_sketch import ops as cs_ops
from repro_torch.kernels.l0_sampler import ops as l0_ops
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


# -- K2: the Count-Sketch update's plain version against the reference --------

# The shapes of tests/test_kernels.py::test_count_sketch_kernel_matches_ref.
CS_SHAPES = [(1000, 3, 256, 256), (4096, 5, 2048, 512), (999, 2, 128, 128), (512, 1, 4096, 512)]


@pytest.mark.parametrize("n_endpoints,t,b,block_e", CS_SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_count_sketch_plain_matches_reference_k2(n_endpoints, t, b, block_e, integer):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 10_000, n_endpoints, dtype=np.int32)
    y = rng.integers(0, 10_000, n_endpoints, dtype=np.int32)
    w = (rng.integers(0, 3, n_endpoints) if integer else rng.random(n_endpoints)).astype(np.float32)
    rp, p = ref_sketch_params(t, b, seed=7), make_sketch_params(t, b, seed=7)
    xj, yj, wj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
    xt, yt, wt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)
    cases = [
        (cs_ops.count_sketch_update(xt, wt, p),
         [ref_cs_update(xj, wj, rp, use_pallas=False),
          ref_cs_update(xj, wj, rp, use_pallas=True, block_e=block_e, interpret=True)]),
        (cs_ops.sketch_edges(xt, yt, wt, p),
         [ref_sketch_edges(xj, yj, wj, rp, use_pallas=False)]),
    ]
    for got, wants in cases:
        assert got.dtype == torch.float32 and got.shape == (t, b)
        for want in wants:
            _assert_close_k2(got.numpy(), np.asarray(want), integer)


def _assert_close_k2(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:  # the tolerance of tests/test_kernels.py: f32 reassociation
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_count_sketch_plan_covers_the_counters():
    cap = cs_ops.WINDOW_BYTES // 4  # the queues of folded adds take the rest
    for t, b in [(5, 8192), (1, 128), (8, 32768), (2, 100_003), (16, 1), (5, 1 << 17)]:
        window, groups = cs_ops.plan(t, b)
        assert window <= cap and (groups - 1) * window < t * b <= groups * window
        if t * b <= cap:
            assert groups == 1  # every edge read once
        elif b <= cap:
            assert window % b == 0  # whole tables per window
    assert cs_ops.plan(5, 8192) == (40960, 1)
    assert cs_ops.plan(5, 32768) == (32768, 5)


def test_count_sketch_wrapper_rejects_bad_inputs():
    p = make_sketch_params(5, 256)
    x = torch.zeros(10, dtype=torch.int32)
    w = torch.ones(10)
    with pytest.raises(ValueError, match="int32"):
        cs_ops.count_sketch_update(x.long(), w, p)
    with pytest.raises(ValueError, match="float32"):
        cs_ops.count_sketch_update(x, w.double(), p)
    with pytest.raises(ValueError, match="weights"):
        cs_ops.sketch_edges(x, x[:5].contiguous(), w, p)
    with pytest.raises(ValueError, match="tables"):
        cs_ops.count_sketch_update(x, w, make_sketch_params(17, 256))


# -- K3: the l0-sampler update's plain version against the reference ----------


def _l0_rows(n, seed, n_nodes=3000):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_nodes, n).astype(np.int32)
    v = rng.integers(0, n_nodes, n).astype(np.int32)
    v[::9] = u[::9]  # self-loops: sign-zeroed
    s = np.where(rng.random(n) < 0.6, 1, -1).astype(np.int32)
    s[::5] = 0  # padding rows
    return u, v, s


@pytest.mark.parametrize("case", ["random", "wrapping"])
def test_l0_plain_matches_reference_k3(case):
    """At tests/test_turnstile.py's Pallas shape (300 rows, L=8, C=256),
    against the reference's segment-sum and its Pallas kernel in interpret
    mode, bit for bit; 'wrapping' pushes every field's sum past 2^31."""
    p = l0_ops.make_l0_params(n_levels=8, n_cells=1 << 8, n_tables=3, seed=4)
    rp = ref_l0.make_l0_params(n_levels=8, n_cells=1 << 8, n_tables=3, seed=4)
    if case == "random":
        u, v, s = _l0_rows(300, seed=2)
    else:
        u = np.full(256, 2**31 - 7, np.int32)
        v = np.full(256, 2**31 - 2, np.int32)
        s = np.ones(256, np.int32)
    got = l0_ops.l0_delta(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(s), p)
    args = (jnp.asarray(u), jnp.asarray(v), jnp.asarray(s), rp)
    want_ref = np.asarray(ref_l0.l0_delta(*args, use_pallas=False))
    want_pallas = np.asarray(ref_l0.l0_delta(*args, use_pallas=True, interpret=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 3, 256, 4)
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    if case == "wrapping":
        assert (want_ref < 0).any()


def test_l0_update_adds_in_place_and_wraps():
    p = l0_ops.make_l0_params(n_levels=4, n_cells=64, n_tables=3, seed=1)
    u, v, s = (torch.from_numpy(a) for a in _l0_rows(500, seed=3, n_nodes=200))
    delta = l0_ops.l0_delta(u, v, s, p)
    tables = torch.full(l0_ops.l0_sketch_shape(p), 2**31 - 1, dtype=torch.int32)
    want = hashing.to_i32(tables.long() + delta.long())
    assert l0_ops.l0_update(tables, u, v, s, p) is tables
    assert torch.equal(tables, want)
    with pytest.raises(ValueError, match="tables"):
        l0_ops.l0_update(torch.zeros(4, 3, 65, 4, dtype=torch.int32), u, v, s, p)
    with pytest.raises(ValueError, match="int32"):
        l0_ops.l0_delta(u.long(), v, s, p)


# -- the build: a kernel's library name covers its headers --------------------


@pytest.mark.parametrize("ops", [cs_ops, l0_ops], ids=["count_sketch", "l0_sampler"])
def test_library_digest_covers_the_hash_header(ops, tmp_path, monkeypatch):
    """Editing kernels/csrc/hashing.cuh renames (so rebuilds) both kernels'
    libraries."""
    import repro_torch.kernels as kernels

    hdr = kernels.CSRC_DIR / "hashing.cuh"
    assert '#include "hashing.cuh"' in ops.SOURCE.read_text()
    before = source_digest(ops.SOURCE)
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    src = tmp_path / ops.SOURCE.name
    shutil.copy(ops.SOURCE, src)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    assert source_digest(src) == before
    (csrc / "hashing.cuh").write_text(hdr.read_text() + "\n// edited\n")
    assert source_digest(src) != before
