"""Port parity: the hash family (``repro_torch.kernels.hashing``) against
``repro.kernels.hashing``, bit for bit.

The port holds uint32 values in int64 and masks after every multiply and
add; these tests pin that spelling against the reference's native uint32
arithmetic on random values and on the edge values 0, 1, 2^31-1, 2^31 and
2^32-1, and mirror the reference's own pins (tests/test_turnstile.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import countsketch as ref_cs
from repro.core.turnstile import (
    _np_edge_cells as ref_np_cells,
    _np_edge_fingerprint as ref_np_fp,
    _np_edge_level as ref_np_level,
)
from repro.kernels import hashing as ref_hashing
from repro.kernels.l0_sampler import ops as ref_l0
from repro_torch.core import countsketch
from repro_torch.core.turnstile import _np_edge_cells, _np_edge_fingerprint, _np_edge_level
from repro_torch.kernels import hashing
from repro_torch.kernels.l0_sampler import ops as l0

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)


def _values(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32), EDGES])


def _t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


MULTIPLIERS = [1, 3, 0x7FEB352D, 2**31 + 1, 2**32 - 1]
OFFSETS = [0, 1, 12345, 2**31, 2**32 - 1]


@pytest.mark.parametrize("a,c", list(zip(MULTIPLIERS, OFFSETS)))
def test_mix32_bitwise(a, c):
    x = _values(1)
    want = np.asarray(ref_hashing.mix32(jnp.uint32(a), jnp.uint32(c), jnp.asarray(x)))
    np.testing.assert_array_equal(_u32(hashing.mix32(a, c, _t(x))), want)


@pytest.mark.parametrize("n_buckets", [1, 2, 128, 1000, 8192, 100_003, 2**31 + 11])
def test_bucket32_bitwise(n_buckets):
    h = _values(2)
    want = np.asarray(ref_hashing.bucket32(jnp.asarray(h), n_buckets))
    got = hashing.bucket32(_t(h), n_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sign32_bitwise():
    h = _values(3)
    want = np.asarray(ref_hashing.sign32(jnp.asarray(h)))
    got = hashing.sign32(_t(h))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a_x,a_y,c", [(1, 1, 0), (3, 5, 7), (2**32 - 1, 2**31 + 1, 2**32 - 1),
                                       (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35)])
def test_mix32_pair_bitwise(a_x, a_y, c):
    x, y = _values(4), _values(5)
    want = np.asarray(ref_hashing.mix32_pair(
        jnp.uint32(a_x), jnp.uint32(a_y), jnp.uint32(c), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(_u32(hashing.mix32_pair(a_x, a_y, c, _t(x), _t(y))), want)


@pytest.mark.parametrize("n_levels", [1, 2, 16, 32, 33])
def test_level_from_hash_bitwise(n_levels):
    h = np.concatenate([_values(6), (1 << np.arange(32, dtype=np.int64)).astype(np.uint32)])
    want = np.asarray(ref_l0.level_from_hash(jnp.asarray(h), n_levels))
    got = hashing.level_from_hash(_t(h), n_levels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The CUDA spelling: min(clz32(h), L-1), with clz32(0) = 32.
    clz = np.array([32 - int(v).bit_length() for v in h])
    np.testing.assert_array_equal(got.numpy(), np.minimum(clz, n_levels - 1))


def test_int64_products_wrap_and_keep_the_low_bits():
    """a*x for a, x < 2^32 passes 2^63 and wraps mod 2^64 in int64; the
    low 32 bits, all the mask keeps, are still those of the uint32 product."""
    a, x = 2**32 - 1, torch.tensor([2**32 - 1, 2**32 - 3], dtype=torch.int64)
    prod = a * x
    assert (prod < 0).all() or (prod > 2**62).all()  # it did leave the int64 range
    want = [(a * int(v)) % 2**32 for v in x]
    assert ((prod & hashing.MASK32)).tolist() == want


def test_to_i32_is_the_bitcast():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -1, -(2**33) - 2])
    want = (x.numpy() & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(hashing.to_i32(x).numpy(), want)


def test_hashing_matches_original_countsketch_formula():
    """Mirror of the reference's pin: mix32/bucket32/sign32 equal the
    inline numpy formula on fixed seeds."""
    rng = np.random.default_rng(7)
    a = (rng.integers(0, 1 << 31, 4, dtype=np.uint32) * 2 + 1).astype(np.uint32)
    c = rng.integers(0, 1 << 31, 4, dtype=np.uint32)
    x = rng.integers(0, 1 << 31, 257, dtype=np.uint32)
    for j in range(4):
        with np.errstate(over="ignore"):
            h = np.uint32(a[j]) * x + np.uint32(c[j])
            h = h ^ (h >> np.uint32(16))
        got = hashing.mix32(int(a[j]), int(c[j]), _t(x))
        np.testing.assert_array_equal(_u32(got), h)
        np.testing.assert_array_equal(hashing.bucket32(got, 1 << 10).numpy(),
                                      (h % np.uint32(1 << 10)).astype(np.int32))
        np.testing.assert_array_equal(hashing.sign32(got).numpy(),
                                      np.where((h >> np.uint32(31)) == 0, 1.0, -1.0))


def test_countsketch_hashes_equal_reference_on_fixed_seed():
    p = countsketch.make_sketch_params(3, 512, seed=3)
    rp = ref_cs.make_sketch_params(3, 512, seed=3)
    ids = np.arange(1000, dtype=np.int32)
    np.testing.assert_array_equal(
        countsketch._hash_bucket(p, torch.from_numpy(ids)).numpy(),
        np.asarray(ref_cs._hash_bucket(rp, jnp.asarray(ids))),
    )
    np.testing.assert_array_equal(
        countsketch._hash_sign(p, torch.from_numpy(ids)).numpy(),
        np.asarray(ref_cs._hash_sign(rp, jnp.asarray(ids))),
    )


def test_l0_edge_hashes_and_numpy_mirrors_equal_reference():
    """Torch hashes, the port's numpy decoder mirrors and the reference's
    jnp and numpy spellings agree bit for bit."""
    p = l0.make_l0_params(n_levels=16, n_cells=1 << 9, n_tables=3, seed=11)
    rp = ref_l0.make_l0_params(n_levels=16, n_cells=1 << 9, n_tables=3, seed=11)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 5000, 400).astype(np.int32)
    v = (u + 1 + rng.integers(0, 100, 400)).astype(np.int32)
    uj, vj, ut, vt = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), torch.from_numpy(v)
    lvl = l0.edge_level(p, ut, vt).numpy()
    cells = l0.edge_cells(p, ut, vt).numpy()
    fp = hashing.to_i32(l0.edge_fingerprint(p, ut, vt)).numpy()
    np.testing.assert_array_equal(lvl, np.asarray(ref_l0.edge_level(rp, uj, vj)))
    np.testing.assert_array_equal(cells, np.asarray(ref_l0.edge_cells(rp, uj, vj)))
    ref_fp = np.asarray(ref_l0.edge_fingerprint(rp, uj, vj)).view(np.int32)
    np.testing.assert_array_equal(fp, ref_fp)
    np.testing.assert_array_equal(_np_edge_level(p, u, v), lvl)
    np.testing.assert_array_equal(_np_edge_cells(p, u, v), cells)
    np.testing.assert_array_equal(_np_edge_fingerprint(p, u, v), fp)
    np.testing.assert_array_equal(_np_edge_level(p, u, v), ref_np_level(rp, u, v))
    np.testing.assert_array_equal(_np_edge_cells(p, u, v), ref_np_cells(rp, u, v))
    np.testing.assert_array_equal(_np_edge_fingerprint(p, u, v), ref_np_fp(rp, u, v))
