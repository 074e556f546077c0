"""The rule the rung tiling's counting sort (``kernels/tile_bucket``)
follows, checked on the CPU through its plain version (the kernels run
only on the card, in tests/test_torch_cuda.py): slot ``s`` has a fixed
target, source and edge index (``ref.slot_fields``), and the plain
``bucket_edges_by_tile`` lists the slots of each tile in slot order.
"""

import numpy as np
import pytest
import torch

from repro_torch.graph import generators as gen
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels.tile_bucket import ops, ref


def _graph(name):
    """(src, dst, n_nodes) int32 on the CPU."""
    rng = np.random.default_rng(11)
    if name == "chung_lu":
        e = gen.chung_lu_power_law(3000, avg_deg=10, seed=1, device="cpu")
        return e.src, e.dst, e.n_nodes
    if name == "self_loops":  # random pairs, every tenth a self-loop
        src = rng.integers(0, 700, 5000)
        dst = rng.integers(0, 700, 5000)
        dst[::10] = src[::10]
    elif name == "padded":  # a rung buffer: real edges, then (0, 0) padding
        e = gen.erdos_renyi(500, avg_deg=6, seed=2, device="cpu").with_padding(4096)
        return e.src, e.dst, e.n_nodes
    elif name == "empty_tiles":  # nodes 300..899 have no edge
        src = np.concatenate([rng.integers(0, 300, 800), rng.integers(900, 1200, 800)])
        dst = np.concatenate([rng.integers(0, 300, 800), rng.integers(900, 1200, 800)])
    elif name == "hub":  # node 3 in half the edges: one tile far above chunk_slots
        src = np.full(6000, 3)
        dst = rng.integers(0, 2000, 6000)
        src[::2] = rng.integers(0, 2000, 3000)
    elif name == "one_edge":
        src, dst = np.array([5]), np.array([2])
    elif name == "no_edge":
        src = dst = np.zeros(0)
    else:
        raise ValueError(name)
    n = int(max(src.max(initial=0), dst.max(initial=0))) + 1
    as32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    return as32(src), as32(dst), n


GRAPHS = ["chung_lu", "self_loops", "padded", "empty_tiles", "hub", "one_edge", "no_edge"]


def _assert_same_tiling(got: TiledEdges, want: TiledEdges):
    for f in ("tile_ptr", "target_local", "source", "edge_index", "chunk_tile", "chunk_start"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in ("tile_size", "n_nodes", "n_edges", "chunk_slots"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("directed", [False, True])
def test_slot_rule_matches_plain(name, directed):
    """The plain tiling is the slots of ``slot_fields``, stably sorted by
    tile: target_local, source and edge_index of every position follow the
    rule for the slot that lands there (self-loops give both slots)."""
    src, dst, n = _graph(name)
    ts = 128
    t = bucket_edges_by_tile(src, dst, n, tile_size=ts, directed=directed)
    halves = 1 if directed else 2
    slots = torch.arange(halves * src.shape[0])
    target, source, edge_index = ref.slot_fields(src, dst, slots, directed)
    order = torch.sort(target.to(torch.int64) // ts, stable=True).indices
    assert torch.equal(t.target_local, (target % ts)[order])
    assert torch.equal(t.source, source[order])
    assert torch.equal(t.edge_index, edge_index[order])
    assert torch.equal(t.tile_of_slot(), (target.to(torch.int64) // ts)[order])
    if not directed:  # the two slots of edge e: (dst, src) and (src, dst)
        e = src.shape[0]
        assert torch.equal(target[:e], dst) and torch.equal(target[e:], src)
        assert torch.equal(edge_index[e:], edge_index[:e])


def test_wrapper_on_cpu_runs_the_plain_version():
    src, dst, n = _graph("chung_lu")
    before = ops.bucket_slots.launches
    _assert_same_tiling(ops.bucket_slots(src, dst, n, 256, False),
                        bucket_edges_by_tile(src, dst, n, tile_size=256))
    assert ops.bucket_slots.launches == before


@pytest.mark.parametrize("bad", ["int64", "strided", "lengths", "tile_size", "n_nodes"])
def test_wrapper_rejects(bad):
    src = torch.arange(10, dtype=torch.int32)
    dst = torch.arange(10, dtype=torch.int32)
    n, ts = 10, 4
    if bad == "int64":
        src = src.to(torch.int64)
    elif bad == "strided":
        dst = torch.arange(20, dtype=torch.int32)[::2]
    elif bad == "lengths":
        dst = dst[:5]
    elif bad == "tile_size":
        ts = 0
    else:
        n = -1
    with pytest.raises(ValueError):
        ops.bucket_slots(src, dst, n, ts, False)
