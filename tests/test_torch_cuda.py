"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (tiled degrees) and the rung tiling's counting sort that feeds it, K2
(Count-Sketch update), K3 (l0-sampler update) and K4 (flash attention), and
the paths through them on the card against the port on the CPU.

These tests need an NVIDIA GPU (the kernels are CUDA C++ and have no CPU
mode) and skip with that reason without one.  They import neither JAX nor
the JAX package, so they run on a machine with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import Problem, solve
from repro_torch.core.countsketch import _hash_bucket, make_sketch_params
from repro_torch.core.turnstile import TurnstileSketch
from repro_torch.graph import generators
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels.count_sketch.ops import count_sketch_update, sketch_edges
from repro_torch.kernels.count_sketch.ref import count_sketch_update_ref, sketch_edges_ref
from repro_torch.kernels.l0_sampler.ops import (
    add_wrapped, canonicalize_edges, l0_delta, l0_update, make_l0_params,
)
from repro_torch.kernels.l0_sampler.ref import l0_delta_ref
from repro_torch.kernels.flash_attention.ops import (
    KV_TILE_BF16, KV_TILE_F32, Q_BLOCK_BF16, flash_attention, tile_bounds,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, tile_bounds_ref
from repro_torch.kernels.peel_degree.ops import tiled_degrees
from repro_torch.kernels.peel_degree.ref import tiled_degrees_ref

pytestmark = pytest.mark.cuda

SHAPES = [(100, 400, 32), (1000, 5000, 128), (257, 1000, 64), (64, 50, 64), (20_000, 300_000, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _tiling(src, dst, n, tile_size, device):
    return bucket_edges_by_tile(
        torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device), n, tile_size=tile_size
    )


@pytest.mark.parametrize("n_nodes,n_edges,tile_size", SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_kernel_matches_plain(cuda, n_nodes, n_edges, tile_size, integer):
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    w = (rng.integers(0, 4, n_edges) if integer else rng.random(n_edges)).astype(np.float32)
    tiling = _tiling(src, dst, n_nodes, tile_size, cuda)
    wt = torch.from_numpy(w).to(cuda)
    before = tiled_degrees.launches
    got = tiled_degrees(tiling, wt, n_nodes=n_nodes)
    torch.cuda.synchronize()
    assert tiled_degrees.launches == before + 1
    if integer:
        assert torch.equal(got, tiled_degrees_ref(tiling, wt)[:n_nodes])
    else:  # f32 reassociation (atomics add in no fixed order): vs the plain version in f64
        want = tiled_degrees_ref(tiling, wt.double())[:n_nodes].float()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_tl,pad_ei", [(0, -1), (-1, -1), (-1, 0)])
def test_kernel_ignores_dense_padding(cuda, pad_tl, pad_ei):
    rng = np.random.default_rng(3)
    n, tile_size = 257, 64
    src = rng.integers(0, n, 1000).astype(np.int32)
    dst = rng.integers(0, n, 1000).astype(np.int32)
    w = torch.from_numpy(rng.integers(0, 4, 1000).astype(np.float32)).to(cuda)
    base = _tiling(src, dst, n, tile_size, cuda)
    tl, sg, ei = base.to_dense(256)
    pad = ei < 0
    tl[pad], ei[pad] = pad_tl, pad_ei
    n_tiles, width = tl.shape
    dense = TiledEdges.from_ragged(
        torch.arange(n_tiles + 1, dtype=torch.int64, device=cuda) * width,
        tl.reshape(-1), sg.reshape(-1), ei.reshape(-1),
        tile_size=tile_size, n_nodes=n, n_edges=base.n_edges,
    )
    assert torch.equal(tiled_degrees(dense, w, n_nodes=n), tiled_degrees(base, w, n_nodes=n))


def _k1_ragged(counts, targets, tile_size, device, offset=0, seed=0, integer=True):
    """A hand-made ragged layout on ``device`` (tile i holds counts[i]
    slots, targets cut in order, slot s reads edge s) and its weights.
    ``offset`` > 0 hands the kernel views that start ``4*offset`` bytes
    past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    s = int(np.sum(counts))
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64, device=device)
    tl = torch.zeros(s + offset, dtype=torch.int32, device=device)
    tl[offset:] = torch.as_tensor(np.asarray(targets, np.int32), device=device)
    ei = torch.arange(-offset, s, dtype=torch.int32, device=device)
    t = TiledEdges.from_ragged(ptr, tl[offset:], torch.zeros(s, dtype=torch.int32, device=device),
                               ei[offset:], tile_size=tile_size, n_nodes=len(counts) * tile_size,
                               n_edges=s)
    w = rng.integers(0, 4, s) if integer else rng.random(s)
    return t, torch.from_numpy(w.astype(np.float32)).to(device)


def _k1_cases(device):
    """(name, tiling, integer weights) of the layouts the redesign must get right."""
    rng = np.random.default_rng(5)
    lens = [3, 5, 130, 1500, 1, 7, 300, 2049, 4, 129, 128]  # across a lane, a step, a chunk
    runs = np.repeat(np.arange(len(lens)) * 7 % 64, lens)
    cases = {
        "runs": _k1_ragged([1, len(runs) - 1], runs, 64, device),
        "runs_misaligned_view": _k1_ragged([3, len(runs) - 3], runs, 64, device, offset=1),
        "one_node": _k1_ragged([0, 50_000, 3], [5] * 50_000 + [1, 1, 2], 64, device),
    }
    cs = 1024  # chunk_slots_for any slot count below 1M
    for extra in (0, 1):
        n = 3000
        cases[f"tile_at_chunk_plus{extra}"] = _k1_ragged(
            [7, cs + extra, n - 10 - cs - extra, 3], rng.integers(0, 64, n), 64, device)
    for tile_size in (1024, 20_000, 58_112):  # 8, 2 and 1 histogram copies
        n = 3 * tile_size - 5
        src = rng.integers(0, n, 200_000).astype(np.int32)
        dst = np.sort(rng.integers(0, n, 200_000)).astype(np.int32)
        t = _tiling(src, dst, n, tile_size, device)
        w = torch.from_numpy(rng.integers(0, 4, 200_000).astype(np.float32)).to(device)
        cases[f"tile_size_{tile_size}"] = (t, w)
    return cases


K1_CASES = ["runs", "runs_misaligned_view", "one_node", "tile_at_chunk_plus0",
            "tile_at_chunk_plus1", "tile_size_1024", "tile_size_20000", "tile_size_58112"]


@pytest.mark.parametrize("name", K1_CASES)
def test_k1_redesign_cases(cuda, name):
    """Integer weights bitwise, twice; float weights within rtol = atol =
    1e-5 of the plain version in float64."""
    t, w = _k1_cases(cuda)[name]
    want = tiled_degrees_ref(t, w)[: t.n_nodes]
    first = tiled_degrees(t, w, n_nodes=t.n_nodes)
    second = tiled_degrees(t, w, n_nodes=t.n_nodes)
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(second, want)
    wf = torch.from_numpy(np.random.default_rng(2).random(w.shape[0]).astype(np.float32)).to(cuda)
    got = tiled_degrees(t, wf, n_nodes=t.n_nodes)
    torch.testing.assert_close(got, tiled_degrees_ref(t, wf.double())[: t.n_nodes].float(),
                               rtol=1e-5, atol=1e-5)


def test_k1_plan_is_built_without_a_sync(cuda):
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, 50_000, 300_000).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(0, 50_000, 300_000).astype(np.int32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = bucket_edges_by_tile(src, dst, 50_000, tile_size=1024)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    w = torch.ones(300_000, device=cuda)
    assert torch.equal(tiled_degrees(t, w, n_nodes=50_000), tiled_degrees_ref(t, w)[:50_000])


@pytest.mark.parametrize("compaction", ["off", "geometric", "twophase"])
def test_solve_on_card_equals_cpu(cuda, compaction):
    answers = []
    for device, backend in (("cuda", "pallas"), ("cuda", "exact"), ("cpu", "pallas")):
        edges, _ = generators.planted_dense_subgraph(3000, 6, 80, 0.5, seed=1, device=device)
        res = solve(edges, Problem.undirected(eps=0.3, backend=backend, compaction=compaction,
                                              track_history=True, tile_size=256))
        answers.append(res)
    for res in answers[1:]:
        for f in ("best_alive", "best_density", "best_size", "alive", "history_n",
                  "history_m", "history_rho"):
            assert torch.equal(getattr(res, f).cpu(), getattr(answers[0], f).cpu()), f
        assert res.passes == answers[0].passes


# -- the rung tiling's counting sort (kernels/tile_bucket) --------------------


def _tile_bucket_case(name):
    """(src, dst, n_nodes, tile_size) as int32 numpy arrays and ints."""
    rng = np.random.default_rng(7)
    if name.startswith("shape"):
        n, m, ts = SHAPES[int(name[5:])]
        return (rng.integers(0, n, m).astype(np.int32), rng.integers(0, n, m).astype(np.int32),
                n, ts)
    if name == "hub":  # node 3 in half the edges: one tile far above chunk_slots
        n, m = 300_000, 2_000_000
        src = rng.integers(0, n, m)
        src[::2] = 3
        return src.astype(np.int32), rng.integers(0, n, m).astype(np.int32), n, 1024
    if name == "power_law":  # sorted (lo, hi) edges, hubs at the low ids, as in portbench
        e = generators.chung_lu_power_law(200_000, avg_deg=20, seed=3, device="cpu")
        return e.src.numpy(), e.dst.numpy(), e.n_nodes, 1024
    if name == "empty_tiles":  # nodes 5,000..49,999 have no edge
        a = np.concatenate([rng.integers(0, 5000, 40_000), rng.integers(50_000, 60_000, 40_000)])
        b = np.concatenate([rng.integers(0, 5000, 40_000), rng.integers(50_000, 60_000, 40_000)])
        return a.astype(np.int32), b.astype(np.int32), 60_000, 256
    if name == "global_counters":  # 70,000 tiles: too many for shared-memory counters
        n = 70_000
        return (rng.integers(0, n, 500_000).astype(np.int32),
                rng.integers(0, n, 500_000).astype(np.int32), n, 1)
    if name.startswith("tile_size_"):  # 300: not a power of two
        ts = int(name[10:])
        src = rng.integers(0, 100_000, 400_000)
        dst = rng.integers(0, 100_000, 400_000)
        dst[::9] = src[::9]  # self-loops
        return src.astype(np.int32), dst.astype(np.int32), 100_000, ts
    if name == "padded_rung":  # a rung buffer: real edges, then (0, 0) padding
        e = generators.erdos_renyi(30_000, avg_deg=10, seed=4, device="cpu").with_padding(1 << 18)
        return e.src.numpy(), e.dst.numpy(), e.n_nodes, 1024
    if name == "two_groups":  # 6M slots: more CTA tiles than one group of the last pass
        n, m = 1_000_000, 3_000_000
        return (rng.integers(0, n, m).astype(np.int32), rng.integers(0, n, m).astype(np.int32),
                n, 1024)
    if name == "one_edge":
        return np.array([5], np.int32), np.array([2], np.int32), 10, 4
    if name == "no_edge":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 10, 4
    raise ValueError(name)


TILE_BUCKET_CASES = [f"shape{i}" for i in range(len(SHAPES))] + [
    "hub", "power_law", "empty_tiles", "global_counters", "tile_size_256", "tile_size_1024",
    "tile_size_300", "padded_rung", "two_groups", "one_edge", "no_edge"]


@pytest.mark.parametrize("name", TILE_BUCKET_CASES)
@pytest.mark.parametrize("directed", [False, True])
def test_tile_bucket_kernel_equals_plain(cuda, name, directed):
    """The counting sort's tiling equals the plain function's, run on CPU
    copies, bitwise in every field and in the chunk plan; the launch
    counter moves once for the CUDA tensor and not for the CPU one."""
    from repro_torch.kernels.tile_bucket.ops import bucket_slots

    src, dst, n, ts = _tile_bucket_case(name)
    before = bucket_slots.launches
    want = bucket_edges_by_tile(torch.from_numpy(src), torch.from_numpy(dst), n, tile_size=ts,
                                directed=directed)
    assert bucket_slots.launches == before
    got = bucket_edges_by_tile(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda), n,
                               tile_size=ts, directed=directed)
    torch.cuda.synchronize()
    assert bucket_slots.launches == before + 1
    for f in ("tile_ptr", "target_local", "source", "edge_index", "chunk_tile", "chunk_start"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a.cpu(), b), f
    assert (got.n_tiles, got.chunk_slots, got.n_edges) == (want.n_tiles, want.chunk_slots,
                                                           want.n_edges)


@pytest.mark.parametrize("n_tiles,passes", [(0, 1), (1, 1), (127, 1), (128, 2), (4727, 2),
                                            (16383, 2), (16384, 3), (2**21, 4)])
def test_tile_bucket_plan(cuda, n_tiles, passes):
    """The library's plan: 7-bit digit passes over buckets 0..n_tiles (a
    target outside the tiles goes to bucket n_tiles), at least one; CTA
    tiles of 4,096 slots; 128 digits a pass."""
    import ctypes

    from repro_torch.kernels.tile_bucket import ops

    plan = (ctypes.c_int * 3)()
    assert ops._library().tile_bucket_plan(n_tiles, plan) == 0
    assert list(plan) == [passes, 4096, 128]


# -- K2: the Count-Sketch update kernel ---------------------------------------

CS_SHAPES = [  # (n_edges, t, b): b=32768 splits the tables over CTA groups,
    (1000, 3, 256),  # b=100_003 splits one table (and is not a power of two)
    (4097, 5, 8192),
    (999, 1, 128),
    (30_001, 8, 32768),
    (5_000, 2, 100_003),
]


def _cs_case(n_edges, integer, seed=0, n_nodes=10_000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    w = (rng.integers(0, 3, n_edges) if integer else rng.random(n_edges)).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("n_edges,t,b", CS_SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_count_sketch_kernel_matches_plain(cuda, n_edges, t, b, integer):
    p = make_sketch_params(t, b, seed=7)
    src, dst, w = (torch.from_numpy(a).to(cuda) for a in _cs_case(n_edges, integer))
    before = count_sketch_update.launches
    got_one = count_sketch_update(src, w, p)
    got_two = sketch_edges(src, dst, w, p)
    torch.cuda.synchronize()
    assert count_sketch_update.launches == before + 2
    if integer:
        assert torch.equal(got_one, count_sketch_update_ref(src, w, p))
        assert torch.equal(got_two, sketch_edges_ref(src, dst, w, p))
    else:  # f32 reassociation (atomics add in no fixed order): vs the plain version in f64
        torch.testing.assert_close(got_one, count_sketch_update_ref(src, w.double(), p).float(),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got_two, sketch_edges_ref(src, dst, w.double(), p).float(),
                                   rtol=1e-4, atol=1e-4)


def test_count_sketch_kernel_adversarial(cuda):
    p = make_sketch_params(5, 8192, seed=1)
    hub = torch.full((100_003,), 42, dtype=torch.int32, device=cuda)  # one node, every endpoint
    ones = torch.ones(100_003, dtype=torch.float32, device=cuda)
    assert torch.equal(sketch_edges(hub, hub, ones, p), sketch_edges_ref(hub, hub, ones, p))
    zero = torch.zeros_like(ones)  # every edge dead: all counters stay +0.0
    got = sketch_edges(hub, hub, zero, p)
    assert torch.equal(got, torch.zeros_like(got)) and not torch.signbit(got).any()
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = sketch_edges(empty, empty, torch.zeros(0, device=cuda), p)
    assert got.shape == (5, 8192) and not got.any()


# K2 folds runs of equal endpoints inside each 32-edge step.  Streams whose
# runs cross steps, with the three window routes: one window (t=5,
# b=8192), whole tables per window (t=8, b=32768), a split table (t=2,
# b=100,003).  Unit weights bitwise; float weights within chip_smoke.py's
# MASS_TOL of each counter's absolute mass, against the plain version in
# float64.
CS_MASS_TOL = 3e-6
CS_ROUTES = [(5, 8192), (8, 32768), (2, 100_003)]


def _cs_stream(kind, n=200_003, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sorted":  # a lower-endpoint-sorted edge list: runs of 1..200
        x0 = np.sort(rng.integers(0, n // 40, n))
    else:  # one hub takes every lower endpoint
        x0 = np.full(n, 123_457)
    x1 = rng.integers(0, 1_000_000, n)
    return (torch.from_numpy(a.astype(np.int32)).cuda() for a in (x0, x1))


def _cs_mass_err(got, w, p, *endpoints):
    want = torch.zeros_like(got, dtype=torch.float64)
    mass = torch.ones_like(want)
    for x in endpoints:
        count_sketch_update_ref(x, w.double(), p, out=want)
        mass.scatter_add_(1, _hash_bucket(p, x).long(), w.double().abs().expand(p.n_tables, -1))
    return ((got.double() - want).abs() / mass).max().item()


@pytest.mark.parametrize("kind", ["sorted", "hub"])
@pytest.mark.parametrize("t,b", CS_ROUTES)
def test_count_sketch_kernel_folds_runs(cuda, kind, t, b):
    p = make_sketch_params(t, b, seed=5)
    x0, x1 = _cs_stream(kind)
    ones = torch.ones(x0.shape[0], device=cuda)
    assert torch.equal(sketch_edges(x0, x1, ones, p), sketch_edges_ref(x0, x1, ones, p))
    assert torch.equal(count_sketch_update(x0, ones, p), count_sketch_update_ref(x0, ones, p))
    w = torch.from_numpy(np.random.default_rng(1).random(x0.shape[0]).astype(np.float32)).cuda()
    assert _cs_mass_err(sketch_edges(x0, x1, w, p), w, p, x0, x1) <= CS_MASS_TOL
    assert _cs_mass_err(count_sketch_update(x0, w, p), w, p, x0) <= CS_MASS_TOL
    torch.cuda.synchronize()


# -- K3: the l0-sampler update kernel -----------------------------------------

L0_SHAPES = [(300, 8, 256), (5000, 32, 16384), (2049, 1, 1000), (70_000, 32, 256)]


def _l0_case(n_rows, seed=0, n_nodes=3000):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_nodes, n_rows).astype(np.int32)
    v = rng.integers(0, n_nodes, n_rows).astype(np.int32)
    v[::7] = u[::7]  # self-loops
    s = rng.choice(np.array([1, -1, 0, 3], np.int32), n_rows)
    return u, v, s


@pytest.mark.parametrize("n_rows,n_levels,n_cells", L0_SHAPES)
def test_l0_kernel_matches_plain(cuda, n_rows, n_levels, n_cells):
    p = make_l0_params(n_levels=n_levels, n_cells=n_cells, n_tables=3, seed=4)
    u, v, s = (torch.from_numpy(a).to(cuda) for a in _l0_case(n_rows))
    before = l0_delta.launches
    got = l0_delta(u, v, s, p)
    want = l0_delta_ref(*canonicalize_edges(u, v, s), p)
    assert torch.equal(got, want)
    tables = want.clone()
    assert l0_update(tables, v, u, s, p) is tables
    torch.cuda.synchronize()
    assert l0_delta.launches == before + 2
    assert torch.equal(tables, add_wrapped(want, want))


def test_l0_kernel_wraps_mod_2_32(cuda):
    """Large node ids and repeated rows push every field's sum past 2^31."""
    p = make_l0_params(n_levels=4, n_cells=256, n_tables=3, seed=0)
    u = torch.full((4096,), 2**31 - 5, dtype=torch.int32, device=cuda)
    v = torch.full((4096,), 2**31 - 1, dtype=torch.int32, device=cuda)
    s = torch.ones(4096, dtype=torch.int32, device=cuda)
    got = l0_delta(u, v, s, p)
    assert torch.equal(got, l0_delta_ref(*canonicalize_edges(u, v, s), p))
    assert (got < 0).any()  # the sums did wrap


def _l0_check(u, v, s, p):
    want = l0_delta_ref(*canonicalize_edges(u, v, s), p)
    assert torch.equal(l0_delta(u, v, s, p), want)
    tables = torch.full_like(want, 2**31 - 3)
    assert torch.equal(l0_update(tables, u, v, s, p), add_wrapped(torch.full_like(want, 2**31 - 3),
                                                                   want))
    torch.cuda.synchronize()


@pytest.mark.parametrize("repeats", [32, 1000])
def test_l0_kernel_hot_cell(cuda, repeats):
    """One edge repeated in consecutive rows: every lane of a warp adds
    into the same cell."""
    p = make_l0_params(n_levels=32, n_cells=1 << 14, n_tables=3, seed=1)
    u, v, s = (torch.from_numpy(a).to(cuda) for a in _l0_case(4096, seed=3))
    u[100:100 + repeats], v[100:100 + repeats], s[100:100 + repeats] = 17, 4242, 1
    _l0_check(u, v, s, p)


@pytest.mark.parametrize("n_rows", [1, 3, 129, 1001, 70_003])
def test_l0_kernel_ragged_rows_sign0_and_self_loops(cuda, n_rows):
    """n_rows % 4 != 0, rows with sign 0 and self-loops mixed in."""
    p = make_l0_params(n_levels=32, n_cells=1 << 14, n_tables=3, seed=2)
    _l0_check(*(torch.from_numpy(a).to(cuda) for a in _l0_case(n_rows, seed=n_rows)), p)


@pytest.mark.parametrize("start", [1, 2, 3])
def test_l0_kernel_misaligned_slice(cuda, start):
    """Views that start 4, 8 or 12 bytes past a 16-byte boundary."""
    p = make_l0_params(n_levels=8, n_cells=256, n_tables=3, seed=3)
    u, v, s = (torch.from_numpy(a).to(cuda) for a in _l0_case(10_000, seed=4))
    _l0_check(u[start:], v[start:], s[start:], p)
    _l0_check(u[start:-5], v[3:-5 - start + 3], s[start:-5], p)


@pytest.mark.parametrize("stream_mode", ["insert", "turnstile"])
def test_sketch_and_turnstile_solves_on_card_equal_cpu(cuda, stream_mode):
    kw = dict(eps=0.5, track_history=True)
    if stream_mode == "turnstile":
        kw.update(stream_mode="turnstile", sample_edges=1 << 11, backend="pallas")
    else:
        kw.update(backend="sketch")
    answers = []
    for device in ("cuda", "cpu"):
        edges = generators.chung_lu_power_law(20_000, avg_deg=8, seed=3, device=device)
        answers.append(solve(edges, Problem.undirected(**kw)))
    got, want = answers
    for f in ("best_alive", "best_density", "best_size", "alive", "history_n",
              "history_m", "history_rho"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert got.passes == want.passes


# -- Algorithms 2 and 3 and the sweep driver through K1 and K2 ----------------

OUTCOME_FIELDS = ("best_alive", "best_t", "best_density", "best_size", "alive", "t_alive",
                  "history_n", "history_m", "history_rho")


def _equal_results(got, want):
    for f in OUTCOME_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f
    assert got.passes == want.passes


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
def test_at_least_k_pallas_equals_exact_on_card(cuda, variant):
    fb = variant == "floor_fallback"
    kw = dict(k=2_000, eps=0.5, min_deg_fallback=fb, ceil_count=not fb, track_history=True,
              tile_size=256)
    answers = []
    for device, backend in (("cuda", "pallas"), ("cuda", "exact"), ("cpu", "pallas")):
        edges = generators.chung_lu_power_law(20_000, avg_deg=8, seed=3, device=device)
        before = tiled_degrees.launches
        res = solve(edges, Problem.at_least_k(backend=backend, **kw))
        if device == "cuda":
            assert tiled_degrees.launches - before == (res.passes if backend == "pallas" else 0)
        answers.append(res)
    assert int(answers[0].best_size) >= 2_000
    for res in answers[1:]:
        _equal_results(res, answers[0])


@pytest.mark.parametrize("variant", ["floor_fallback", "ceil_plain"])
def test_at_least_k_rank_ties_on_card_equal_cpu(cuda, variant):
    """The (degree, id) rank with many equal degrees and signed zeros at a
    size where the card's sort takes its radix path: the removal bitmap
    equals the CPU's, alone and as lanes."""
    from repro_torch.core.engine import AtLeastKFraction, PassStats

    rng = np.random.default_rng(7)
    n = 200_000
    deg = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0, 3.0], np.float32), size=(2, n))
    alive = rng.random((2, n)) < 0.9
    fb = variant == "floor_fallback"
    answers = []
    for device in (cuda, "cpu"):
        eps = torch.tensor([0.5, 1.0], device=device)
        pol = AtLeastKFraction(k=10, eps=eps, min_deg_fallback=fb, ceil_count=not fb)
        a = torch.from_numpy(alive).to(device)
        d = torch.from_numpy(deg).to(device)
        n_s = a.sum(-1)
        stats = PassStats(rho=torch.full((2,), 1.0, device=device), total=n_s.float(),
                          n_s=n_s, n_t=n_s)
        answers.append(pol.removal(a, a, d, d, stats)[0].cpu())
    assert torch.equal(*answers)


def test_directed_sketch_pass_tables_equal_plain(cuda):
    """One directed sketch pass on the card: two K2 launches, out and in
    tables equal to the plain version's (integer weights), and the
    backend's degrees equal the CPU's."""
    from repro_torch.core.countsketch import SketchBackend, sketch_endpoint_counters

    edges, _, _ = generators.directed_planted(30_000, 6, 300, 80, 0.3, seed=2, device=cuda)
    p = make_sketch_params(5, 8192, seed=0)
    w = torch.from_numpy(np.random.default_rng(1).integers(0, 3, edges.n_edges_padded)
                         .astype(np.float32)).to(cuda)
    for ids in (edges.src, edges.dst):
        assert torch.equal(sketch_endpoint_counters(p, ids, w),
                           count_sketch_update_ref(ids, w, p))
    before = count_sketch_update.launches
    out_deg, in_deg, total = SketchBackend(p).directed(edges, w)
    assert count_sketch_update.launches == before + 2
    cpu_e, _, _ = generators.directed_planted(30_000, 6, 300, 80, 0.3, seed=2, device="cpu")
    want = SketchBackend(p).directed(cpu_e, w.cpu())
    for g, x in zip((out_deg, in_deg, total), want):
        assert torch.equal(g.cpu(), x)


@pytest.mark.parametrize("c", [None, 4.0])
@pytest.mark.parametrize("backend", ["exact", "sketch"])
def test_directed_solves_on_card_equal_cpu(cuda, c, backend):
    kw = dict(c=c, eps=0.5, backend=backend, track_history=True)
    answers = []
    for device in ("cuda", "cpu"):
        edges, _, _ = generators.directed_planted(20_000, 5.0, 200, 50, 0.3, seed=0,
                                                  device=device)
        before = count_sketch_update.launches
        res = solve(edges, Problem.directed(**kw))
        if device == "cuda" and backend == "sketch" and c is not None:
            assert count_sketch_update.launches - before == 2 * res.passes
        answers.append(res)
    _equal_results(*answers)
    if c is None:
        assert answers[0].extras["best_c"] == answers[1].extras["best_c"]
        assert (answers[0].extras["c_density"] == answers[1].extras["c_density"]).all()


def test_eps_sweep_lanes_equal_standalone_on_card(cuda):
    from repro_torch.core import solve_batch

    eps = [0.25, 0.5, 1.0]
    edges = generators.chung_lu_power_law(20_000, avg_deg=8, seed=3, device=cuda)
    prob = Problem.undirected(backend="pallas", track_history=True, tile_size=256)
    before = tiled_degrees.launches
    sweep = solve_batch(edges, prob, eps=eps)
    assert tiled_degrees.launches - before == sum(sweep.passes)
    for i, e in enumerate(eps):
        one = solve(edges, Problem.undirected(eps=e, backend="pallas", compaction="off",
                                              track_history=True, tile_size=256,
                                              max_passes=sweep.provenance.max_passes))
        for f in OUTCOME_FIELDS:
            assert torch.equal(getattr(sweep, f)[i], getattr(one, f)), f
        assert sweep.passes[i] == one.passes
    cpu = solve_batch(generators.chung_lu_power_law(20_000, avg_deg=8, seed=3, device="cpu"),
                      prob, eps=eps)
    _equal_results(sweep, cpu)


def test_c_sweep_on_card_launches_k2_twice_a_live_lane(cuda):
    from repro_torch.core import solve_batch

    edges, _, _ = generators.directed_planted(20_000, 5.0, 200, 50, 0.3, seed=0, device=cuda)
    cs = [0.25, 1.0, 4.0, 16.0]
    before = count_sketch_update.launches
    sweep = solve_batch(edges, Problem.directed(backend="sketch"), c=cs)
    assert count_sketch_update.launches - before == 2 * sum(sweep.passes)
    exact = solve_batch(edges, Problem.directed(), c=cs)
    for i, c in enumerate(cs):
        one = solve(edges, Problem.directed(c=c, compaction="off"))
        for f in OUTCOME_FIELDS:
            assert torch.equal(getattr(exact, f)[i], getattr(one, f)), f


def test_turnstile_update_launches_once_per_batch(cuda):
    """The counterpart of the reference's one-compile-per-bucket test: on
    the card every applied batch is one K3 launch, whatever its bucket."""
    sk = TurnstileSketch(2000, 1 << 9, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    before = l0_delta.launches
    for _ in range(4):
        sk.apply(insert_edges=rng.integers(0, 2000, (500, 2)).astype(np.int32))
    assert l0_delta.launches == before + 4
    assert sk.batches_applied == 4 and sk.updates_applied == 2000
    sk.apply(insert_edges=rng.integers(0, 2000, (3000, 2)).astype(np.int32))
    assert l0_delta.launches == before + 5


# (B, S, Hq, Hkv, D, window, q_from): the reference's test shapes, then
# head dims 16/24/32 and groups 1-4, ragged lengths, and windows whose
# first kv tiles are all masked (queries the tail of the keys); then
# lengths around the 128-key tile, with and without q_from, and head dims
# 8 and 40 (padded to 64 columns on the bf16 route).
FLASH_SHAPES = [
    (2, 256, 4, 4, 64, None, 0), (1, 256, 8, 2, 64, None, 0), (2, 384, 4, 2, 32, 128, 0),
    (1, 300, 2, 1, 64, None, 0), (1, 200, 6, 2, 24, None, 0), (1, 129, 3, 1, 16, 40, 0),
    (2, 1000, 8, 2, 128, None, 0), (1, 777, 12, 4, 128, 100, 0), (1, 640, 4, 1, 64, 64, 512),
    (1, 127, 2, 1, 128, None, 0), (1, 128, 2, 2, 64, None, 0), (2, 129, 4, 2, 128, None, 0),
    (1, 257, 2, 1, 128, 100, 0), (1, 127, 2, 1, 64, None, 60), (1, 128, 2, 2, 128, None, 100),
    (1, 129, 4, 2, 64, None, 1), (1, 257, 2, 1, 128, None, 129), (1, 300, 4, 2, 8, None, 0),
    (2, 257, 4, 1, 40, 64, 0), (1, 129, 2, 2, 40, None, 64),
]
# K4 against its plain version: rtol = atol elementwise (the reference
# tests' own), and a limit on each row's relative L2 error, which holds the
# long rows whose outputs are smaller than that atol (chip_smoke.py's
# FLASH_TOL and FLASH_ROW_TOL).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _flash_outside(got, want, dtype):
    """(values outside the elementwise limit, rows outside the row limit)."""
    got, want = got.float(), want.float()
    tol = FLASH_TOL[dtype]
    row = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return (int(((got - want).abs() > tol + tol * want.abs()).sum()),
            int((row > FLASH_ROW_TOL[dtype]).sum()))


def _flash_controls(q, k, v, qpos, kpos, window, want, tile):
    """The plain version with the diagonal dropped from every row, from the
    second half of the rows only, and with one allowed kv tile (the one
    before the middle query's diagonal) dropped."""
    half = q.shape[1] // 2
    late = want.clone()
    late[:, half:] = flash_attention_ref(q[:, half:], k, v, qpos[half:], kpos + 1, window=window)
    key = int(torch.searchsorted(kpos.long(), qpos[half:half + 1].long())[0])
    start = max(0, (key // tile - 1) * tile)
    kp = kpos.clone()
    kp[start:start + tile] = 2 ** 30
    return {"diagonal": flash_attention_ref(q, k, v, qpos, kpos + 1, window=window),
            "late_diagonal": late,
            "interior_tile": flash_attention_ref(q, k, v, qpos, kp, window=window)}


def _flash_check(q, k, v, qpos, kpos, window, dtype):
    """K4 within both limits, one launch; each control fails one of them."""
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, qpos, kpos, window=window)
    assert _flash_outside(got, want, dtype) == (0, 0)
    tile = KV_TILE_BF16 if dtype == torch.bfloat16 else KV_TILE_F32  # K4's kv tile
    for name, ctrl in _flash_controls(q, k, v, qpos, kpos, window, want, tile).items():
        assert _flash_outside(ctrl, want, dtype) != (0, 0), name


@pytest.mark.parametrize("b,s,hq,hkv,d,window,q_from", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, s, hq, hkv, d, window, q_from, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s - q_from, hq, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    kpos = torch.arange(s, dtype=torch.int32, device=cuda) + 7
    _flash_check(q, k, v, kpos[q_from:], kpos, window, dtype)


# (S, D, window, q_from, stride): kv positions that are not a shifted
# arange.  A stride of 3 (window 3 * 200 = 600 positions), and windows
# whose first allowed key falls inside a 128-key tile, so that tile is
# masked per element while the ones before it are skipped.
FLASH_POSITIONS = [
    (500, 128, None, 0, 3), (700, 64, 600, 0, 3), (1000, 128, 200, 0, 1),
    (600, 64, 129, 300, 1), (513, 128, 250, 129, 1),
]


@pytest.mark.parametrize("s,d,window,q_from,stride", FLASH_POSITIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_positions(cuda, s, d, window, q_from, stride, dtype):
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn(1, s - q_from, 4, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, s, 2, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    kpos = stride * torch.arange(s, dtype=torch.int32, device=cuda) + 5
    _flash_check(q, k, v, kpos[q_from:], kpos, window, dtype)


@pytest.mark.parametrize("seed", range(4))
def test_flash_plan_matches_plain(cuda, seed):
    """The bf16 route's first launch (each tile's position bounds) equals
    its plain version bitwise, on shuffled positions and ragged tails."""
    rng = np.random.default_rng(seed)
    sk = int(rng.integers(1, 5000))
    kpos = torch.from_numpy(rng.permutation(3 * sk)[:sk].astype(np.int32))
    qpos = kpos[int(rng.integers(0, sk)):]
    got = tile_bounds(qpos.to(cuda), kpos.to(cuda))
    assert torch.equal(got.cpu(), tile_bounds_ref(qpos, kpos, Q_BLOCK_BF16, KV_TILE_BF16))


def test_flash_kernel_many_heads(cuda):
    """B * Hq = 65,600 (batch * heads) above gridDim.y's 65,535: the grid
    is linear, so the launch still covers every head."""
    b, s, hq, hkv, d = 4100, 20, 16, 4, 32
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, s, hq, d, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    want = flash_attention_ref(q, k, v, pos, pos)
    assert _flash_outside(got, want, torch.bfloat16) == (0, 0)


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as column slices of one packed [B, S, (Hq + 2 Hkv) D] tensor:
    read through their strides, no copy."""
    b, s, hq, hkv, d = 1, 300, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, s, (hq + 2 * hkv) * d, generator=g, device=cuda).bfloat16()
    q = qkv[..., :hq * d].view(b, s, hq, d)
    k = qkv[..., hq * d:(hq + hkv) * d].view(b, s, hkv, d)
    v = qkv[..., (hq + hkv) * d:].view(b, s, hkv, d)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), pos, pos)
    assert _flash_outside(got, want, torch.bfloat16) == (0, 0)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "starcoder2-7b", "qwen2-72b"])
@pytest.mark.parametrize("window", [None, 16])
def test_reduced_prefill_on_card_equals_cpu(cuda, arch, window):
    """The REDUCED config's prefill through K4 (f32 compute) on the card ==
    the port on the CPU within 2e-5 (f32 reassociation); one K4 launch per
    layer."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import params_from_reference, prefill
    from repro_torch.train.step import init_model_params

    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.reduced_config, compute_dtype=torch.float32,
                              attn_impl="pallas", window=window)
    cpu_params = init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg, device="cpu")
    gpu_params = params_from_reference(_numpy_tree(cpu_params), cfg, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    before = flash_attention.launches
    got, got_cache, _ = prefill(gpu_params, cfg, tokens.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    want, want_cache, _ = prefill(cpu_params, cfg, tokens)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    for key in ("k", "v"):  # bf16 cache: the f32 tolerance, then one bf16 ulp
        torch.testing.assert_close(got_cache[key].cpu().float(), want_cache[key].float(),
                                   rtol=2.0 ** -7, atol=2e-5)


def test_flash_attention_refuses_autograd_on_card(cuda):
    """Under autograd K4 raises on the card as on the CPU (its output would
    carry no grad_fn); with grad off it launches once."""
    b, s, hq, hkv, d = 1, 128, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda) for h in (hq, hkv, hkv))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention_trainable"):
        flash_attention(q.requires_grad_(), k, v, q_positions=pos, kv_positions=pos)
    assert flash_attention.launches == before
    with torch.no_grad():
        flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    assert flash_attention.launches == before + 1


# K4b (flash_attention_bwd) against its plain version, the chunked vjp at
# the same chunks, on (dq, dk, dv) together (chip_smoke.py's
# TRAINABLE_BWD_TOL): elementwise |got - want| <= elem * (scale + |want|),
# scale the rms of the plain gradients, and the relative L2 error over the
# three.  f32: summation order.  bf16: K4b rounds P and dS to bf16 for
# wgmma where the chunked vjp keeps them in f32, and the chunked vjp
# itself lies up to 0.06 of (scale + |truth|) off the exact gradient in
# the first rows and keys (chip_smoke.py's vs_f64_truth).  K4's
# log-sum-exp against the plain one: LSE_TOL, absolute.
BWD_TOL = {torch.float32: (2.0 ** -12, 2.0 ** -14), torch.bfloat16: (2.0 ** -3, 2.0 ** -7)}
LSE_TOL = 1e-4


def _bwd_outside(got, want, dtype):
    """(elements outside the elementwise limit, whether the relative L2
    error is past its limit)."""
    elem, rel = BWD_TOL[dtype]
    want = [w.double() for w in want]
    scale = (sum(w.square().sum() for w in want) / sum(w.numel() for w in want)).sqrt()
    errs = [(g.double() - w).abs() for g, w in zip(got, want)]
    outside = sum(int((e > elem * (scale + w.abs())).sum()) for e, w in zip(errs, want))
    l2 = (sum(e.square().sum() for e in errs) / sum(w.square().sum() for w in want)).sqrt()
    return outside, bool(l2 > rel)


def _dense_grads_without_delta(q, k, v, dout, qpos, kpos, window):
    """(dq, dk, dv) of dense attention with delta dropped from dS = P (dP -
    delta): a fault a wrong backward could have."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d)
    do = dout.float().reshape(b, sq, hkv, hq // hkv, d)
    ok = kpos.long()[None, :] <= qpos.long()[:, None]
    if window is not None:
        ok &= kpos.long()[None, :] > qpos.long()[:, None] - window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / d ** 0.5
    p = torch.softmax(s.masked_fill(~ok, -torch.inf), dim=-1).nan_to_num(0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    ds = p * torch.einsum("bqhgd,bkhd->bhgqk", do, v.float()) / d ** 0.5
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(q.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _bwd_controls(q, k, v, dout, qpos, kpos, window, want, chunks):
    """Three faults a wrong K4b could have: delta dropped; the diagonal
    excluded (each key one position later); dK and dV from the first query
    head of each group only (the other heads' dout zeroed; only where a
    group has more than one head)."""
    from repro_torch.models.attention import chunked_vjp

    kw = dict(q_positions=qpos, window=window, q_chunk=chunks[0], kv_chunk=chunks[1])
    controls = {"no_delta": _dense_grads_without_delta(q, k, v, dout, qpos, kpos, window),
                "no_diagonal": chunked_vjp(q, k, v, dout, kv_positions=kpos + 1, **kw)}
    g = q.shape[2] // k.shape[2]
    if g > 1:
        first = dout.clone()
        first.view(*q.shape[:2], k.shape[2], g, q.shape[3])[:, :, :, 1:] = 0
        _, dk, dv = chunked_vjp(q, k, v, first, kv_positions=kpos, **kw)
        controls["one_head_per_group"] = (want[0], dk, dv)
    return controls


def _trainable_check(q, k, v, dout, qpos, kpos, window, chunks=(64, 128)):
    """The trainable route on the card: K4 and K4b once each; dq, dk, dv
    within the limits of the chunked vjp, each control outside them; K4's
    log-sum-exp within LSE_TOL of the plain one (+inf where a row has no
    key); its output bitwise the no-grad call's."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_lse_ref
    from repro_torch.models.attention import chunked_vjp

    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = ops.flash_attention_trainable(*xs, q_positions=qpos, kv_positions=kpos, window=window,
                                        bwd_q_chunk=chunks[0], bwd_kv_chunk=chunks[1])
    got = torch.autograd.grad(out, xs, dout)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches, ops.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(g.dtype == q.dtype and g.shape == x.shape for g, x in zip(got, (q, k, v)))
    want = chunked_vjp(q, k, v, dout, q_positions=qpos, kv_positions=kpos, window=window,
                       q_chunk=chunks[0], kv_chunk=chunks[1])
    assert _bwd_outside(got, want, q.dtype) == (0, False)
    for name, ctrl in _bwd_controls(q, k, v, dout, qpos, kpos, window, want, chunks).items():
        assert _bwd_outside(ctrl, want, q.dtype) != (0, False), name
    with torch.no_grad():
        plain_out = ops.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos,
                                        window=window)
    out_l, lse = ops._kernel_forward(q, k, v, qpos, kpos, window, with_lse=True)
    assert torch.equal(out_l, plain_out) and torch.equal(out.detach(), plain_out)
    lse_ref = flash_attention_lse_ref(q, k, qpos, kpos, window=window)
    assert torch.equal(torch.isposinf(lse), torch.isposinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    assert ((lse[fin] - lse_ref[fin]).abs() <= LSE_TOL).all()


# (B, S, Hq, Hkv, D, window, q_from, stride of the positions): S in {1,
# 129, 300, 1000, 1024}, heads 6/2, 4/4, 8/1 and the training layout's
# 24/8, D in {64, 72, 128}, windows, queries that are the tail of the keys,
# positions that are not an arange.
BWD_CASES = [
    (1, 1, 6, 2, 64, None, 0, 1), (1, 129, 6, 2, 64, None, 0, 1),
    (2, 300, 4, 4, 128, None, 0, 1), (1, 300, 8, 1, 72, 64, 0, 1),
    (1, 1024, 6, 2, 128, None, 0, 1), (1, 1024, 8, 1, 64, 64, 300, 1),
    (1, 129, 4, 4, 72, 64, 1, 1), (1, 300, 6, 2, 128, 200, 0, 3),
    (1, 1000, 24, 8, 128, None, 0, 1),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window,q_from,stride", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda, b, s, hq, hkv, d, window, q_from, stride, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, dout = (torch.randn(b, s - q_from, hq, d, generator=g, device=cuda).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    kpos = stride * torch.arange(s, dtype=torch.int32, device=cuda) + 7
    _trainable_check(q, k, v, dout, kpos[q_from:], kpos, window)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_bitwise_deterministic(cuda, window, dtype):
    """Two K4b calls on the same inputs give bitwise-equal dq, dk and dv
    (the bf16 dQ is a kernel of its own, no atomics), causal and windowed,
    at the training layout (24/8 heads, D=128) over 1,000 rows."""
    from repro_torch.kernels.flash_attention import ops

    b, s, hq, hkv, d = 1, 1000, 24, 8, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    q, dout = (torch.randn(b, s, hq, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    out, lse = ops._kernel_forward(q, k, v, pos, pos, window, with_lse=True)
    first, second = (ops.flash_attention_bwd(q, k, v, out, dout, lse, q_positions=pos,
                                             kv_positions=pos, window=window)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_from_a_fresh_thread(cuda, dtype):
    """K4 and K4b called first from a host thread that has made no CUDA
    call yet, as autograd's device thread does when it runs a backward:
    the entry points bind the device's context before encoding their TMA
    tensor maps (cuTensorMapEncodeTiled needs one), and the results equal
    this thread's."""
    import threading

    from repro_torch.kernels.flash_attention import ops

    b, s, hq, hkv, d = 1, 300, 6, 2, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    q, dout = (torch.randn(b, s, hq, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)

    def run():
        out, lse = ops._kernel_forward(q, k, v, pos, pos, None, with_lse=True)
        return (out, *ops.flash_attention_bwd(q, k, v, out, dout, lse, q_positions=pos,
                                              kv_positions=pos))

    got, errors = [], []
    thread = threading.Thread(target=lambda: _catch(lambda: got.extend(run()), errors))
    thread.start()
    thread.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, run()))


def _catch(fn, errors):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - reported by the test's thread
        errors.append(repr(e))


def test_flash_bwd_kernel_reads_strided_views(cuda):
    """q/k/v as column slices of one packed [B, S, (Hq + 2 Hkv) D] tensor
    and dout a transposed view: read through their strides (dout made
    contiguous by the wrapper when TMA cannot read it)."""
    b, s, hq, hkv, d = 1, 300, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, s, (hq + 2 * hkv) * d, generator=g, device=cuda).bfloat16()
    q = qkv[..., :hq * d].view(b, s, hq, d)
    k = qkv[..., hq * d:(hq + hkv) * d].view(b, s, hkv, d)
    v = qkv[..., (hq + hkv) * d:].view(b, s, hkv, d)
    dout = torch.randn(b, hq, s, d, generator=g, device=cuda).bfloat16().transpose(1, 2)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    _trainable_check(q, k, v, dout, pos, pos, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_trainable_on_card(cuda, dtype):
    """flash_attention_trainable on the card: K4 once and K4b once, dq/dk/dv
    within BWD_TOL of the chunked vjp at the same chunks (K4b rounds P and
    dS to bf16 for wgmma, so not bitwise); f32 within rtol 2e-4 / atol 1e-5
    of dense autodiff (O(1) cotangents)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd, flash_attention_trainable
    from repro_torch.models.attention import _chunked_gqa, gqa_attention

    b, s, hq, hkv, d = 1, 300, 6, 2, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, w = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
                  for h in (hq, hkv, hkv, hq))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)

    def grads(fn):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*xs), xs, w)

    before = (flash_attention.launches, flash_attention_bwd.launches)
    got = grads(lambda a, b_, c: flash_attention_trainable(
        a, b_, c, q_positions=pos, kv_positions=pos, bwd_q_chunk=64, bwd_kv_chunk=128))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    chunked = grads(lambda a, b_, c: _chunked_gqa(
        a, b_, c, q_positions=pos, kv_positions=pos, kv_valid=None, window=None,
        q_chunk=64, kv_chunk=128))
    assert _bwd_outside(got, chunked, dtype) == (0, False)
    if dtype == torch.float32:
        dense = grads(lambda a, b_, c: gqa_attention(a, b_, c, q_positions=pos,
                                                     kv_positions=pos, impl="xla"))
        for x, y in zip(got, dense):
            torch.testing.assert_close(x, y, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("d", [8, 32, 40, 64, 72, 128])
def test_flash_f32_kernels_fit_and_scratch_matches(cuda, d):
    """Every float32 (split-TF32) CTA of K4 and K4b at head dim ``d`` fits
    Hopper's 227 KB of shared memory a block, and the scratch the built
    libraries carve equals ``ops.f32_scratch_bytes``, which the wrapper
    allocates."""
    from repro_torch.kernels import MAX_SMEM_BYTES
    from repro_torch.kernels.flash_attention import ops

    assert all(0 < n <= MAX_SMEM_BYTES for n in ops.f32_smem_bytes(d).values())
    for b, sq, sk, hq, hkv in ((1, 4096, 4096, 24, 8), (2, 129, 257, 6, 2), (3, 1, 7, 4, 4)):
        for backward in (False, True):
            assert ops.f32_scratch_bytes_built(b, sq, sk, hq, hkv, d, backward=backward) == (
                ops.f32_scratch_bytes(b, sq, sk, hq, hkv, d, backward=backward))


def _numpy_tree(params):
    if isinstance(params, dict):
        return {k: _numpy_tree(v) for k, v in params.items()}
    return params.numpy()


# -- per-seed serving and the cache of built kernels ---------------------------

SERVE_FIELDS = ("qid", "seed", "density", "seed_in_set", "n_ego", "m_ego", "bucket",
                "status", "fallback", "error", "attempts")


def _serve_graph(device, weights=None):
    edges = generators.chung_lu_power_law(20_000, avg_deg=8, seed=3, device=device)
    if weights is not None:
        edges = dataclasses.replace(edges, weight=weights.to(device))
    return edges


@pytest.mark.parametrize("extraction", ["bfs", "local"])
def test_query_engine_on_card_equals_cpu(cuda, extraction):
    """The engine on the card answers what it answers on the CPU (unit
    weights: bitwise), one stacked solve per bucket group, no kernel built
    after the first query."""
    from repro_torch import kernels
    from repro_torch.serve import DensestQueryEngine

    seeds = np.random.default_rng(0).integers(0, 20_000, 48).tolist()
    answers = []
    for device in (cuda, "cpu"):
        eng = DensestQueryEngine(_serve_graph(device), Problem.undirected(eps=0.5),
                                 extraction=extraction, radius=1, max_ego_nodes=128,
                                 max_batch=16, time_fn=lambda: 0.0)
        assert eng.device.type == torch.device(device).type
        answers.append(eng.query_many(seeds))
        built = dict(kernels.BUILD_LOG)
        answers[-1] += eng.query_many(seeds[:16])
        assert kernels.BUILD_LOG == built
    for a, b in zip(*answers):
        for f in SERVE_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.nodes, b.nodes)


def test_query_engine_float_weights_on_card(cuda):
    """Float weights: the card's atomics sum each lane's degrees in another
    order, so densities are held to rtol 1e-5 (f32 reassociation)."""
    from repro_torch.serve import DensestQueryEngine

    m = _serve_graph("cpu").n_edges_padded
    w = torch.from_numpy(np.random.default_rng(1).random(m).astype(np.float32) + 0.5)
    seeds = np.random.default_rng(2).integers(0, 20_000, 32).tolist()
    got, want = (DensestQueryEngine(_serve_graph(dev, w), Problem.undirected(eps=0.5),
                                    radius=1, max_ego_nodes=128).query_many(seeds)
                 for dev in (cuda, "cpu"))
    for a, b in zip(got, want):
        assert a.bucket == b.bucket and a.n_ego == b.n_ego
        assert a.density == pytest.approx(b.density, rel=1e-5, abs=1e-6)


def test_local_front_door_on_card_equals_cpu(cuda):
    for seed in (0, 17, 4242):
        got, want = (solve(_serve_graph(dev), Problem(substrate="local"), seed=seed)
                     for dev in (cuda, "cpu"))
        assert got.best_alive.device.type == "cuda"
        _equal_results(got, want)
        assert got.extras["local"]["bucket"] == want.extras["local"]["bucket"]


def test_turnstile_service_on_card(cuda):
    """K3 once per applied batch; the pallas sample peel through K1 once a
    pass; the same density as the service on the CPU."""
    from repro_torch.serve import TurnstileDensityService

    edges = _serve_graph("cpu")
    src, dst = edges.src.numpy(), edges.dst.numpy()
    prob = Problem.undirected(stream_mode="turnstile", sample_edges=1 << 11, backend="pallas")
    got = TurnstileDensityService(edges.n_nodes, prob, device=cuda)
    want = TurnstileDensityService(edges.n_nodes, prob, device="cpu")
    k3, k1 = l0_delta.launches, tiled_degrees.launches
    for svc in (got, want):
        svc.apply(insert_edges=(src, dst))
        svc.apply(delete_edges=(src[:500], dst[:500]))
    assert l0_delta.launches == k3 + 2
    res = got.result()
    assert tiled_degrees.launches - k1 == res.passes > 0
    assert got.density() == want.density()
    assert got.stats()["queries_computed"] == 1


def test_warm_build_directory_builds_nothing_in_a_fresh_process(cuda, tmp_path):
    """All four libraries built into a fresh directory with nvcc; a fresh
    process loads them with no build; one changed nvcc flag misses."""
    import concurrent.futures
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch import kernels
    from repro_torch.kernels.count_sketch import ops as cs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.l0_sampler import ops as l0_ops
    from repro_torch.kernels.peel_degree import ops as pd_ops

    sources = [pd_ops.SOURCE, cs_ops.SOURCE, l0_ops.SOURCE, fa_ops.SOURCE]
    counters = kernels.CacheCounters()

    def build(src):
        with kernels.kernel_cache(tmp_path, counters):
            return kernels.load_library(src)

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build, sources))
    assert counters.disk_misses == 4 and counters.disk_store_errors == 0
    child = (
        "import sys; from pathlib import Path; from repro_torch import kernels\n"
        "def never(*a): raise SystemExit('nvcc ran')\n"
        "flags = tuple('-O2' if f == '-O3' else f for f in kernels.NVCC_FLAGS)\n"
        "c = kernels.CacheCounters()\n"
        f"with kernels.kernel_cache({str(tmp_path)!r}, c):\n"
        f"    for s in {[str(s) for s in sources]!r}: kernels.load_library(Path(s), build=never)\n"
        "    assert kernels.BUILD_LOG == {} and c.disk_hits == 4, (kernels.BUILD_LOG, vars(c))\n"
        f"    kernels.load_library(Path({str(l0_ops.SOURCE)!r}), flags=flags)\n"
        "assert c.disk_misses == 1 and list(kernels.BUILD_LOG) == ['l0_sampler.cu']\n"
        "print('WARM_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0 and "WARM_OK" in out.stdout, out.stdout + out.stderr


# -- the semi-streaming substrate: node state on the card ---------------------


def _stream_case(seed=1):
    edges, _ = generators.planted_dense_subgraph(3000, 6, 80, 0.5, seed=seed, device="cpu")
    m = edges.mask.numpy()
    return edges.n_nodes, tuple(a.numpy()[m] for a in (edges.src, edges.dst, edges.weight))


def _same_stream_state(got, want):
    assert got.best_rho == want.best_rho and got.pass_idx == want.pass_idx
    assert np.array_equal(got.best_alive, want.best_alive)
    assert np.array_equal(got.alive, want.alive)
    assert got.history == want.history


@pytest.mark.parametrize("compaction", ["off", "geometric"])
def test_streaming_driver_on_card_equals_cpu(cuda, compaction):
    from repro_torch.core.streaming import StreamingDensest, chunked_from_arrays

    n, (src, dst, w) = _stream_case()
    runs = []
    for device in ("cuda", "cpu"):
        drv = StreamingDensest(chunked_from_arrays(src, dst, w, 1000), n, eps=0.3,
                               compaction=compaction, device=device)
        runs.append((drv.run(resume=False), drv))
    _same_stream_state(runs[0][0], runs[1][0])
    assert runs[0][1].bytes_to_device >= 12 * len(src) and runs[1][1].bytes_to_device == 0
    res = solve(generators.planted_dense_subgraph(3000, 6, 80, 0.5, seed=1, device=cuda)[0],
                Problem.undirected(eps=0.3, substrate="streaming", compaction=compaction,
                                   stream_chunk=1000))
    assert res.best_alive.device.type == "cuda"
    assert np.array_equal(res.best_alive.cpu().numpy(), runs[1][0].best_alive)


def test_streaming_stress_on_card_is_bitwise_repeatable(cuda):
    """8 workers, a 2-chunk window, 97-edge chunks, speculation on (half the
    stream duplicated): 20 runs, each equal to the CPU driver, bit for bit."""
    from repro_torch.core.streaming import StreamingDensest, chunked_from_arrays

    n, (src, dst, w) = _stream_case(seed=2)
    kw = dict(n_nodes=n, eps=0.3, n_workers=8, prefetch=2, speculative=True,
              speculate_tail_frac=0.5)
    want = StreamingDensest(chunked_from_arrays(src, dst, w, 97), device="cpu",
                            **kw).run(resume=False)
    for _ in range(20):
        got = StreamingDensest(chunked_from_arrays(src, dst, w, 97), device=cuda,
                               **kw).run(resume=False)
        _same_stream_state(got, want)


def test_streaming_failing_chunk_on_card_keeps_checkpoint(cuda, tmp_path):
    """A malformed chunk of pass 3 (an object weight array) re-raises its
    own TypeError after its one retry, and the checkpoint of pass 2
    survives and resumes to the CPU answer."""
    from repro_torch.core.streaming import StreamingDensest, chunked_from_arrays

    n, (src, dst, w) = _stream_case()
    base = chunked_from_arrays(src, dst, w, 500)
    calls = {"n": 0}

    def poisoned_third_pass():
        calls["n"] += 1
        for i, (s, d, ww) in enumerate(base()):
            bad = calls["n"] == 3 and i == 2
            yield s, d, (np.array(["boom"] * len(ww), object) if bad else ww)

    ck = str(tmp_path / "ck")
    drv = StreamingDensest(poisoned_third_pass, n, eps=0.3, checkpoint_dir=ck, device=cuda)
    with pytest.raises(TypeError):
        drv.run(resume=False)
    st = drv._load()
    assert st is not None and st.pass_idx == 2
    want = StreamingDensest(base, n, eps=0.3, device="cpu").run(resume=False)
    got = StreamingDensest(base, n, eps=0.3, checkpoint_dir=ck, device=cuda).run(resume=True)
    _same_stream_state(got, want)


# -- the §5.2 mesh substrate: NCCL at world size 1 -----------------------------


@pytest.fixture(scope="module")
def card_meshes():
    """A one-rank card mesh (NCCL, bound to the card) and a one-rank CPU mesh
    (gloo) in this process, every group with a 60 s timeout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card mesh reduces over NCCL")
    import datetime

    import torch.distributed as dist

    from repro_torch.core import mapreduce

    saved = mapreduce.GROUP_TIMEOUT
    mapreduce.GROUP_TIMEOUT = datetime.timedelta(seconds=60)
    try:
        yield (mapreduce.make_mesh((1,), ("data",)),
               mapreduce.make_mesh((1,), ("data",), device="cpu"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        mapreduce.GROUP_TIMEOUT = saved


MESH_CELLS = {
    "off": ("undirected", dict(eps=0.5, compaction="off")),
    "twophase": ("undirected", dict(eps=0.5, compaction="twophase", twophase_passes=2)),
    "geometric": ("undirected", dict(eps=0.5, compaction="geometric")),
    "directed.c4": ("directed", dict(c=4.0, eps=0.5)),
    "at_least_k": ("at_least_k", dict(k=2_000, eps=0.5)),
}


def _mesh_graph(objective, device):
    if objective == "directed":
        return generators.directed_planted(20_000, 5.0, 200, 50, 0.3, seed=0, device=device)[0]
    return generators.chung_lu_power_law(n=20_000, seed=0, device=device)


@pytest.mark.parametrize("cell", sorted(MESH_CELLS))
def test_mesh_on_card_equals_jit(card_meshes, cell):
    """NCCL at world size 1: the mesh solve == the jit solve on the card,
    field for field; the geometric ladder is the collective one."""
    from repro_torch import collectives

    mesh, _ = card_meshes
    objective, kw = MESH_CELLS[cell]
    edges = _mesh_graph(objective, "cuda")
    make = getattr(Problem, objective)
    want = solve(edges, make(track_history=True, **kw))
    collectives.reset()
    got = solve(edges, make(substrate="mesh", track_history=True, **kw), mesh=mesh)
    _equal_results(got, want)
    assert got.provenance.substrate == "mesh"
    assert collectives.all_reduce.count >= got.passes
    if got.provenance.compaction == "geometric":
        lad = got.extras["compaction"]
        assert lad["single_program"] and lad["host_round_trips"] == 0
        assert collectives.all_gather.count == 4 * (len(lad["segments"]) - 1)


def test_mesh_sketch_on_card_launches_k2_once_a_pass(card_meshes):
    mesh, _ = card_meshes
    edges = generators.chung_lu_power_law(n=20_000, seed=0, device="cuda")
    kw = dict(eps=0.5, backend="sketch", track_history=True)
    want = solve(edges, Problem.undirected(**kw))
    before = count_sketch_update.launches
    got = solve(edges, Problem.undirected(substrate="mesh", **kw), mesh=mesh)
    assert count_sketch_update.launches - before == got.passes
    _equal_results(got, want)


@pytest.mark.parametrize("compaction", ["off", "geometric"])
def test_mesh_bf16_wire_on_card_equals_cpu(card_meshes, compaction):
    """The bf16 wire on the card (NCCL) == on the CPU (gloo), world size 1."""
    answers = []
    for mesh, device in zip(card_meshes, ("cuda", "cpu")):
        edges = generators.chung_lu_power_law(n=20_000, seed=0, device=device)
        answers.append(solve(edges, Problem.undirected(
            eps=0.5, substrate="mesh", wire_dtype="bf16", compaction=compaction,
            track_history=True), mesh=mesh))
    _equal_results(*answers)


# -- the port's benchmarks and the teardown of make_mesh's world, on the card ---


def _bench(name):
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    return importlib.import_module(f"benchmarks.torch_port.{name}")


def test_bench_engine_on_card_launches_once_a_pass(cuda):
    """``benchmarks.torch_port.bench_engine`` at a small n on the card: K1
    launches once a pass of the pallas run, K2 once a pass of the sketch
    run, and pallas == exact."""
    mod = _bench("bench_engine")
    rep = mod.run(mod.parse_args(["--n", "20000", "--out", ""]))
    rows = {r["backend"]: r for r in rep["rows"]}
    assert rep["device"]["name"] == torch.cuda.get_device_name()
    for backend in ("pallas", "sketch"):
        assert rows[backend]["kernel_launches"] == rows[backend]["passes"] > 0, backend
    assert (rows["pallas"]["rho"], rows["pallas"]["passes"]) == (
        rows["exact"]["rho"], rows["exact"]["passes"])


def test_bench_api_on_card_loads_k1_and_equals_exact(cuda):
    mod = _bench("bench_api")
    rep = mod.run(mod.parse_args(["--n", "20000", "--grid", "3", "--repeats", "1",
                                  "--out", ""]))
    assert rep["kernel_load"]["library_loaded"] and rep["kernel_load"]["equal_to_exact"]
    assert all(e for e, x in zip(rep["solve_batch"]["lane_equal_to_solve"],
                                 rep["solve_batch"]["f32_exact"]) if x)


def test_paper_kernels_row_on_card(cuda):
    mod = _bench("paper_benches")
    (row,) = mod.kernels(n=20_000, e=160_000, repeats=5)
    assert row["equal_to_plain_and_index_add"] and row["timer"] == "cuda events"
    assert row["kernel_launches"] == 3 + 5  # warm-up and timed launches


def test_card_mesh_world_is_torn_down_at_exit(cuda):
    """A fresh process that makes a card mesh (NCCL) and its edge groups,
    solves on it and exits without destroying anything exits 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "from repro_torch.core import Problem, mapreduce, solve\n"
        "from repro_torch.graph.generators import chung_lu_power_law\n"
        "mesh = mapreduce.make_mesh((1,), ('data',))\n"
        "mapreduce.edge_shards(mesh, ('data',))\n"
        "g = chung_lu_power_law(20_000, seed=0, device='cuda')\n"
        "r = solve(g, Problem.undirected(substrate='mesh'), mesh=mesh)\n"
        "print('PASSES', r.passes)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "PASSES" in proc.stdout and "terminate called" not in proc.stderr
