"""K4's tile plan (the bfloat16 route's first launch and the rule that
classifies each (q block, kv tile) pair) held against the dense mask.

``tile_plan_ref`` is the plain version of what the kernel decides from the
per-tile position bounds: a skipped pair has no allowed (query, key), a
full pair has no masked one and no key past Sk, so no allowed pair is
lost and no mask is dropped where one is needed.  Positions, windows and
ragged tails are drawn from a numpy seed; the positions are not assumed to
be an arange.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import Q_BLOCK_BF16, KV_TILE_BF16, tile_bounds
from repro_torch.kernels.flash_attention.ref import tile_bounds_ref, tile_plan_ref


def _dense_allowed(qpos, kpos, window):
    qp, kp = qpos.long()[:, None], kpos.long()[None, :]
    ok = kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def _positions(rng, kind, sk, q_from):
    if kind == "arange":
        kpos = np.arange(sk) + int(rng.integers(0, 50))
    elif kind == "stride3":
        kpos = 3 * np.arange(sk) + int(rng.integers(0, 5))
    elif kind == "gaps":  # increasing, random gaps
        kpos = np.cumsum(rng.integers(0, 4, sk))
    else:  # "shuffled": no order at all
        kpos = rng.permutation(sk * 2)[:sk]
    kpos = kpos.astype(np.int32)
    return torch.from_numpy(kpos[q_from:].copy()), torch.from_numpy(kpos)


def _check_plan(qpos, kpos, window, bq, bkv):
    plan = tile_plan_ref(qpos, kpos, window=window, block_q=bq, block_kv=bkv)
    ok = _dense_allowed(qpos, kpos, window)
    sq, sk = ok.shape
    assert plan.shape == (-(-sq // bq), -(-sk // bkv))
    counts = {0: 0, 1: 0, 2: 0}
    for i in range(plan.shape[0]):
        for j in range(plan.shape[1]):
            blk = ok[i * bq:(i + 1) * bq, j * bkv:(j + 1) * bkv]
            kind = int(plan[i, j])
            counts[kind] += 1
            if kind == 0:  # skipped: no allowed pair is lost
                assert not blk.any(), (i, j)
            elif kind == 2:  # full: no masked pair, no ragged edge
                assert blk.all() and (j + 1) * bkv <= sk, (i, j)
    return counts


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["arange", "stride3", "gaps", "shuffled"])
def test_plan_never_loses_a_pair(seed, kind):
    rng = np.random.default_rng(seed)
    sk = int(rng.integers(1, 700))
    q_from = int(rng.integers(0, sk))
    window = None if seed % 2 == 0 else int(rng.integers(1, 300))
    qpos, kpos = _positions(rng, kind, sk, q_from)
    bq, bkv = [(Q_BLOCK_BF16, KV_TILE_BF16), (64, 32), (16, 48)][seed % 3]
    _check_plan(qpos, kpos, window, bq, bkv)


@pytest.mark.parametrize("s", [127, 128, 129, 257, 1000])
@pytest.mark.parametrize("window", [None, 100, 128, 300])
def test_plan_skips_and_takes_whole_tiles_on_arange(s, window):
    """On pos == arange the plan is as tight as the tiles allow: a causal
    q block takes every tile up to its diagonal, the diagonal tile is mixed,
    and with a window the tiles wholly before it are skipped."""
    pos = torch.arange(s, dtype=torch.int32)
    counts = _check_plan(pos, pos, window, Q_BLOCK_BF16, KV_TILE_BF16)
    plan = tile_plan_ref(pos, pos, window=window, block_q=Q_BLOCK_BF16, block_kv=KV_TILE_BF16)
    n = plan.shape[0]
    assert all(int(plan[i, i]) == 1 for i in range(n))  # the diagonal
    assert all(int(plan[i, j]) == 0 for i in range(n) for j in range(i + 1, n))
    if window is None:
        whole = [(i, j) for i in range(n) for j in range(i) if (j + 1) * KV_TILE_BF16 <= s]
        assert all(int(plan[i, j]) == 2 for i, j in whole)
        assert counts[0] == n * (n - 1) // 2
    else:
        # No tile wholly older than a block's window is visited.
        for i in range(n):
            qmin = i * Q_BLOCK_BF16
            for j in range(i):
                if (j + 1) * KV_TILE_BF16 - 1 <= qmin - window:
                    assert int(plan[i, j]) == 0, (i, j)


def test_window_straddling_a_tile_is_mixed():
    """A window whose first allowed key lies inside a tile leaves that tile
    mixed (masked per element), not skipped and not full."""
    s, window = 512, 200  # block 3's oldest row (384) reaches key 185: tile 1
    pos = torch.arange(s, dtype=torch.int32)
    plan = tile_plan_ref(pos, pos, window=window, block_q=Q_BLOCK_BF16, block_kv=KV_TILE_BF16)
    assert plan[3].tolist() == [0, 1, 1, 1]
    _check_plan(pos, pos, window, Q_BLOCK_BF16, KV_TILE_BF16)


@pytest.mark.parametrize("seed", range(3))
def test_tile_bounds_wrapper_on_cpu_is_the_plain_version(seed):
    rng = np.random.default_rng(seed)
    sk = int(rng.integers(1, 600))
    qpos, kpos = _positions(rng, "shuffled", sk, int(rng.integers(0, sk)))
    got = tile_bounds(qpos, kpos)
    want = tile_bounds_ref(qpos, kpos, Q_BLOCK_BF16, KV_TILE_BF16)
    assert torch.equal(got, want)
    n_kt = -(-sk // KV_TILE_BF16)
    for j in range(n_kt):  # each kv tile's (min, max) over its real keys
        blk = kpos[j * KV_TILE_BF16:(j + 1) * KV_TILE_BF16]
        assert got[2 * j].item() == blk.min().item() and got[2 * j + 1].item() == blk.max().item()
