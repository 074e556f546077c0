"""The rules the redesigned K1 and the tiling that feeds it follow, checked
on the CPU through their plain versions (the kernel itself runs only on the
card, in tests/test_torch_cuda.py).

K1 folds each run of equal targets inside a 128-slot warp step of a chunk
into one ``(bin, Σw)`` add (``peel_degree/ref.py::fold_runs``); the
histogram of the folded stream equals the raw one's and the reference's,
bitwise on integer weights.  The chunk plan (``TiledEdges.from_ragged``)
gives a tile of at most ``chunk_slots`` slots one chunk and cuts a larger
one, in a plan padded to a length the host knows, so that building a
tiling reads nothing back from the device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.partition import bucket_edges_by_tile as ref_bucket
from repro.kernels.peel_degree.ref import tiled_degrees_ref as ref_tiled_degrees_ref
from repro_torch import hostsync
from repro_torch.graph import generators as gen
from repro_torch.graph import partition as part
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels.peel_degree.ref import STEP_GROUPS, fold_runs, tiled_degrees_ref


def _ragged(counts, targets, tile_size, w_len=None):
    """A hand-made ragged layout: tile i holds counts[i] slots whose
    targets are ``targets`` (cut in order); slot s reads edge s."""
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64)
    tl = torch.as_tensor(np.asarray(targets, np.int32))
    s = tl.shape[0]
    return TiledEdges.from_ragged(
        ptr, tl, torch.zeros(s, dtype=torch.int32), torch.arange(s, dtype=torch.int32),
        tile_size=tile_size, n_nodes=len(counts) * tile_size, n_edges=w_len or s,
    )


def _stream(case, seed=0):
    """(tiling, integer weights 0..3) of one layout shape."""
    rng = np.random.default_rng(seed)
    if case == "sorted_lo":  # the (lo, hi) order: lower endpoints sorted
        e = gen.chung_lu_power_law(3000, avg_deg=10, seed=seed, device="cpu")
        t = bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=256)
    elif case == "shuffled":  # the same slots, each tile's order shuffled
        e = gen.chung_lu_power_law(3000, avg_deg=10, seed=seed, device="cpu")
        t = bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=256)
        key = t.tile_of_slot() * t.n_slots + torch.from_numpy(rng.permutation(t.n_slots))
        perm = torch.argsort(key)
        t = TiledEdges.from_ragged(t.tile_ptr, t.target_local[perm], t.source[perm],
                                   t.edge_index[perm], tile_size=t.tile_size,
                                   n_nodes=t.n_nodes, n_edges=t.n_edges)
    elif case == "one_node":  # every slot on node 5: one split tile
        t = _ragged([0, 5000, 3], [5] * 5000 + [1, 1, 2], 64)
    elif case == "runs":  # runs of 3, 5, 130 and 1500 slots, across lanes, steps, chunks
        lens = [3, 5, 130, 1500, 1, 7, 300]
        tl = np.repeat(np.arange(len(lens)) * 3 % 64, lens)
        t = _ragged([1, len(tl) - 1], tl, 64)
    elif case == "dense_padding":  # the reference's rectangle, padding slots included
        e = gen.erdos_renyi(700, avg_deg=6, seed=seed, device="cpu")
        base = bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=128)
        tl, sg, ei = base.to_dense(256)
        tl[ei < 0] = -1
        n_tiles, width = tl.shape
        t = TiledEdges.from_ragged(torch.arange(n_tiles + 1) * width, tl.reshape(-1),
                                   sg.reshape(-1), ei.reshape(-1), tile_size=128,
                                   n_nodes=e.n_nodes, n_edges=base.n_edges)
    else:
        raise ValueError(case)
    w = torch.from_numpy(rng.integers(0, 4, t.n_edges).astype(np.float32))
    return t, w


CASES = ["sorted_lo", "shuffled", "one_node", "runs", "dense_padding"]


def _add_count_by_loop(t: TiledEdges, w: torch.Tensor) -> int:
    """The fold rule spelled out chunk by chunk and step by step."""
    tl, ei = t.target_local.tolist(), t.edge_index.tolist()
    ptr, wl = t.tile_ptr.tolist(), w.tolist()
    adds = 0
    for tile, start in zip(t.chunk_tile.tolist(), t.chunk_start.tolist()):
        if tile < 0:
            continue
        key, total, step = None, 0.0, None
        for s in range(start, min(start + t.chunk_slots, ptr[tile + 1])):
            k = tl[s] if ei[s] >= 0 and 0 <= tl[s] < t.tile_size else -1
            st = ((s >> 2) - (start >> 2)) // STEP_GROUPS
            if k != key or st != step:
                adds += key is not None and key >= 0 and total != 0
                key, total, step = k, 0.0, st
            total += wl[ei[s]] if k >= 0 else 0.0
        adds += key is not None and key >= 0 and total != 0
    return adds


@pytest.mark.parametrize("case", CASES)
def test_fold_runs_reproduces_the_histogram(case):
    t, w = _stream(case)
    pos, sums = fold_runs(t, w)
    want = tiled_degrees_ref(t, w)
    got = torch.zeros_like(want).index_add_(0, pos, sums)
    assert torch.equal(got, want)
    assert len(pos) == _add_count_by_loop(t, w)
    assert len(pos) <= int((t.edge_index >= 0).sum())


@pytest.mark.parametrize("case", ["sorted_lo", "shuffled", "dense_padding"])
def test_fold_runs_matches_the_jax_reference(case):
    """The folded stream's degrees equal the JAX oracle's over the
    reference's dense layout of the same graph."""
    t, w = _stream(case)
    if case == "dense_padding":
        tl, ei = t.target_local.reshape(t.n_tiles, -1), t.edge_index.reshape(t.n_tiles, -1)
    else:
        tl, _, ei = t.to_dense(256)
    wd = torch.where(ei >= 0, w[ei.long().clamp(min=0)], 0.0)  # the reference wrapper's gather
    want = np.asarray(ref_tiled_degrees_ref(jnp.asarray(tl.numpy()), jnp.asarray(wd.numpy()),
                                            tile_size=t.tile_size))
    pos, sums = fold_runs(t, w)
    got = torch.zeros(t.n_tiles * t.tile_size).index_add_(0, pos, sums)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def test_fold_runs_folds_the_sorted_half():
    """Sorted lower endpoints fold; a shuffled tile leaves more adds; a
    single node folds to one add per 128-slot step."""
    sorted_adds = len(fold_runs(*_stream("sorted_lo"))[0])
    shuffled_adds = len(fold_runs(*_stream("shuffled"))[0])
    assert sorted_adds < 0.9 * shuffled_adds
    t, _ = _stream("one_node")
    pos, sums = fold_runs(t, torch.ones(t.n_edges))
    assert len(pos) == -(-5000 // 128) + 2  # steps of the hub (chunk starts align) + 2 singles


@pytest.mark.parametrize("n,deg,tile_size", [(30000, 8, 1024), (3000, 6, 64), (5, 2, 4)])
def test_padded_plan_covers_every_slot_once(n, deg, tile_size):
    e = gen.chung_lu_power_law(n, avg_deg=deg, seed=1, device="cpu")
    t = bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=tile_size)
    cs = t.chunk_slots
    ct, cst, ptr = t.chunk_tile.numpy(), t.chunk_start.numpy(), t.tile_ptr.numpy()
    assert len(ct) == t.n_tiles + -(-t.n_slots // cs)
    real = ct >= 0
    counts = np.diff(ptr)
    assert real.sum() == np.maximum(1, -(-counts // cs)).sum()
    assert not real[real.argmin():].any() or real.all()  # padding only at the end
    assert (cst[~real] == 0).all()  # padding entries read slot 0 and add nothing
    covered = np.zeros(t.n_slots, np.int64)
    for tile, start in zip(ct[real], cst[real]):
        stop = min(start + cs, ptr[tile + 1])
        covered[start:stop] += 1
    np.testing.assert_array_equal(covered, 1)


def test_chunk_slots_rule():
    assert part.chunk_slots_for(0) == part.CHUNK_FLOOR
    assert part.chunk_slots_for(1_000_000) == 1024
    assert part.chunk_slots_for(14_131_720) == 16384  # flickr_sm's first rung
    for s in (1, 10**6 + 1, 3 * 10**7):
        cs = part.chunk_slots_for(s)
        assert cs & (cs - 1) == 0 and -(-s // cs) <= part.CHUNK_TARGET


@pytest.mark.parametrize("extra", [0, 1])
def test_tile_at_chunk_slots_and_one_over(extra):
    """A tile of exactly chunk_slots slots is one chunk; one slot more
    makes two, the second of one slot."""
    cs = part.chunk_slots_for(3000)
    t = _ragged([7, cs + extra, 3000 - 10 - cs - extra, 3], np.arange(3000) % 64, 64)
    assert t.chunk_slots == cs
    ct, cst = t.chunk_tile.tolist(), t.chunk_start.tolist()
    mine = [s for tile, s in zip(ct, cst) if tile == 1]
    assert mine == ([7] if extra == 0 else [7, 7 + cs])
    assert len(ct) - ct.count(-1) == 5 + extra  # tiles 0 and 3 whole, tile 2 in two


@pytest.mark.parametrize("tile_size", [64, 300, 1024])
def test_tile_ptr_by_searchsorted_equals_bincount_and_reference(tile_size):
    e = gen.chung_lu_power_law(1500, exponent=2.2, avg_deg=6, seed=2, device="cpu")
    t = bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=tile_size)
    targets = torch.cat([e.dst, e.src]).long()
    counts = torch.bincount(targets // tile_size, minlength=t.n_tiles)
    assert torch.equal(t.tile_ptr, torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]))
    want = ref_bucket(e.src.numpy(), e.dst.numpy(), e.n_nodes, tile_size, 128)
    np.testing.assert_array_equal(np.diff(t.tile_ptr.numpy()), (want.edge_index >= 0).sum(1))


@pytest.mark.parametrize("n_tiles", [3, 700, 40000])
def test_int16_sort_keys_give_the_int32_permutation(n_tiles):
    rng = np.random.default_rng(n_tiles)
    keys = torch.from_numpy(rng.integers(0, n_tiles, 200_000).astype(np.int32))
    _, want = torch.sort(keys, stable=True)
    if n_tiles < 2**15:
        _, got = torch.sort(keys.to(torch.int16), stable=True)
        assert torch.equal(got, want)
    dst = torch.flip(keys, [0]).contiguous()
    t = bucket_edges_by_tile(keys, dst, n_tiles, tile_size=1)
    order32 = torch.sort(torch.cat([dst, keys]), stable=True)[1]
    eidx = torch.arange(keys.shape[0], dtype=torch.int32)
    assert torch.equal(t.edge_index, torch.cat([eidx, eidx])[order32])


def test_bucketing_reads_nothing_back():
    """Building a tiling makes no counted host sync and converts no tensor
    to a Python value."""
    e = gen.chung_lu_power_law(5000, avg_deg=8, seed=0, device="cpu")
    before = hostsync.read.count
    names = ("item", "tolist", "__int__", "__float__", "__bool__", "__index__", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*a, **k):
        raise AssertionError("a tensor was read back to the host")

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        t = bucket_edges_by_tile(e.src, e.dst, e.n_nodes, tile_size=256)
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    assert hostsync.read.count == before
    assert t.chunk_tile.numel() == t.n_tiles + -(-t.n_slots // t.chunk_slots)
