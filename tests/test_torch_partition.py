"""Port parity: graph generators and the tile bucketing.

The port's ragged tiling must hold exactly the reference's buckets: its
``to_dense`` rebuild is bitwise equal to ``repro.graph.partition.
bucket_edges_by_tile`` and, with the padding dropped, the dense layout is
the ragged one.  The generators must build byte-identical edge arrays.
"""

import numpy as np
import pytest
import torch

from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.graph import generators as gen
from repro_torch.graph import partition as part

GRAPHS = {
    "er": dict(
        ref=lambda: ref_gen.erdos_renyi(700, avg_deg=6, seed=1),
        port=lambda: gen.erdos_renyi(700, avg_deg=6, seed=1, device="cpu"),
    ),
    "chung_lu": dict(
        ref=lambda: ref_gen.chung_lu_power_law(1500, exponent=2.2, avg_deg=6, seed=2),
        port=lambda: gen.chung_lu_power_law(
            1500, exponent=2.2, avg_deg=6, seed=2, device="cpu"
        ),
    ),
}


def _edges_np(e):
    return np.array(e.src), np.array(e.dst)


@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 255, 256, 257, 1000, 4096, 5067])
@pytest.mark.parametrize("floor", [1, 128, 256])
def test_pow2_bucket_equal(x, floor):
    assert part.pow2_bucket(x, floor) == ref_part.pow2_bucket(x, floor)


@pytest.mark.parametrize("m0,floor,stride", [(1, 1, 2), (5000, 256, 2), (70000, 4096, 4), (3, 8, 2)])
def test_ladder_schedule_equal(m0, floor, stride):
    assert part.ladder_schedule(m0, floor, stride) == ref_part.ladder_schedule(m0, floor, stride)
    with pytest.raises(ValueError):
        part.ladder_schedule(m0, floor, 1)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_byte_identical(name):
    ref = GRAPHS[name]["ref"]()
    port = GRAPHS[name]["port"]()
    assert port.n_nodes == ref.n_nodes and port.directed == ref.directed
    for field in ("src", "dst", "weight", "mask"):
        a = np.asarray(getattr(ref, field))
        b = getattr(port, field).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_planted_generator_byte_identical():
    ref, ref_planted = ref_gen.planted_dense_subgraph(2000, 4, 60, 0.6, seed=7)
    port, planted = gen.planted_dense_subgraph(2000, 4, 60, 0.6, seed=7, device="cpu")
    np.testing.assert_array_equal(planted, ref_planted)
    for field in ("src", "dst", "weight", "mask"):
        assert np.asarray(getattr(ref, field)).tobytes() == getattr(port, field).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("pow2_pad", [False, True])
@pytest.mark.parametrize("tile_size", [128, 300])  # 300: n not a tile multiple
def test_to_dense_matches_reference(name, block, pow2_pad, tile_size):
    src, dst = _edges_np(GRAPHS[name]["ref"]())
    n = 1500 if name == "chung_lu" else 700
    want = ref_part.bucket_edges_by_tile(
        src, dst, n, tile_size=tile_size, block=block, pow2_pad=pow2_pad
    )
    tiled = part.bucket_edges_by_tile(
        torch.from_numpy(src), torch.from_numpy(dst), n, tile_size=tile_size
    )
    tl, sg, ei = tiled.to_dense(block, pow2_pad)
    for got, ref in ((tl, want.target_local), (sg, want.source), (ei, want.edge_index)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    # The ragged layout is the dense one with the padding dropped.
    real = want.edge_index >= 0
    np.testing.assert_array_equal(tiled.target_local.numpy(), want.target_local[real])
    np.testing.assert_array_equal(tiled.source.numpy(), want.source[real])
    np.testing.assert_array_equal(tiled.edge_index.numpy(), want.edge_index[real])
    np.testing.assert_array_equal(
        np.diff(tiled.tile_ptr.numpy()), real.sum(axis=1)
    )


def test_chunk_list_covers_every_slot_once():
    """Each tile's slot range is cut into ``chunk_slots`` pieces; together
    the real chunks cover every slot exactly once (a hub tile spans many
    chunks), and the plan's padding entries (tile -1) cover none."""
    e = gen.chung_lu_power_law(30000, avg_deg=8, seed=0, device="cpu")
    tiled = part.bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=1024)
    ptr = tiled.tile_ptr.numpy()
    cs = tiled.chunk_slots
    assert cs == part.chunk_slots_for(tiled.n_slots)
    assert np.diff(ptr).max() > cs  # the hub tile needs >1 chunk
    assert tiled.chunk_tile.numel() == tiled.n_tiles + -(-tiled.n_slots // cs)
    covered = np.zeros(tiled.n_slots, np.int64)
    for tile, start in zip(tiled.chunk_tile.numpy(), tiled.chunk_start.numpy()):
        if tile < 0:
            continue
        stop = min(start + cs, ptr[tile + 1])
        assert ptr[tile] <= start <= stop and (start < stop or ptr[tile] == ptr[tile + 1])
        covered[start:stop] += 1
    np.testing.assert_array_equal(covered, 1)


def test_with_padding():
    e = gen.erdos_renyi(50, avg_deg=3, seed=0, device="cpu")
    p = e.with_padding(64)
    assert p.n_edges_padded % 64 == 0
    assert int(p.num_real_edges()) == int(e.num_real_edges())
    assert p.src.dtype == torch.int32 and p.weight.dtype == torch.float32
