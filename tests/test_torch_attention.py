"""Port parity of the attention layer: the flash-attention kernel K4's plain
version (``repro_torch.kernels.flash_attention``), ``gqa_attention`` and
``decode_attention`` against the JAX package, on the same numpy inputs.

The reference's Pallas kernel runs in interpret mode, as its own tests run
it (tests/test_kernels.py).  Tolerances are the reference tests' own:
rtol/atol 2e-5 for float32 (f32 reassociation: the sums run in another
order) and 2e-2 for bfloat16.  K4 itself runs only on the card:
tests/test_torch_cuda.py holds it against this plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention

# The five cases of tests/test_kernels.py::test_flash_kernel_matches_ref,
# then windows whose first kv tiles are all masked for every query of a
# block: positions offset from 0, and queries that are the tail of the keys.
CASES = [
    (2, 256, 4, 4, 64, None, "float32", 0, 0),
    (1, 256, 8, 2, 64, None, "float32", 0, 0),  # GQA
    (2, 384, 4, 2, 32, 128, "float32", 0, 0),  # sliding window
    (1, 300, 2, 1, 64, None, "float32", 0, 0),  # padding path
    (1, 256, 4, 4, 64, None, "bfloat16", 0, 0),  # bf16 inputs
    (1, 512, 4, 2, 64, 64, "float32", 1000, 0),  # window, positions from 1000
    (1, 512, 6, 2, 32, 100, "bfloat16", 0, 384),  # window, the last 128 queries
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(rng, b, sq, sk, hq, hkv, d, dtype):
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jx, tx


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype,offset,q_from", CASES)
def test_flash_plain_matches_reference_kernel(b, s, hq, hkv, d, window, dtype, offset, q_from):
    rng = np.random.default_rng(4)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, b, s - q_from, s, hq, hkv, d, dtype)
    kpos = np.arange(s, dtype=np.int32) + offset
    qpos = kpos[q_from:]
    want = ref_flash(jq, jk, jv, q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
                     window=window, block_q=128, block_kv=128, interpret=True)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, q_positions=torch.from_numpy(qpos),
                          kv_positions=torch.from_numpy(kpos), window=window)
    assert flash_attention.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])


def test_flash_kv_valid_raises_in_both():
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 8, 8, 2, 1, 16, "float32")
    pos = np.arange(8, dtype=np.int32)
    with pytest.raises(NotImplementedError):
        ref_flash(jq, jk, jv, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
                  kv_valid=jnp.ones((1, 8), bool))
    with pytest.raises(NotImplementedError):
        flash_attention(tq, tk, tv, q_positions=torch.from_numpy(pos),
                        kv_positions=torch.from_numpy(pos), kv_valid=torch.ones(1, 8, dtype=torch.bool))


@pytest.mark.parametrize("bad", ["window0", "heads", "dtype", "positions"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16)
    pos = torch.arange(8, dtype=torch.int32)
    kw = dict(q_positions=pos, kv_positions=pos)
    if bad == "window0":
        kw["window"] = 0
    elif bad == "heads":
        q = torch.zeros(1, 8, 3, 16)
    elif bad == "dtype":
        k = k.double()
    else:
        kw["q_positions"] = pos[None]
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 48])
def test_gqa_attention_matches_reference(impl, dtype, window):
    rng = np.random.default_rng(6)
    b, s, hq, hkv, d = 2, 160, 6, 3, 32
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, b, s, s, hq, hkv, d, dtype)
    pos = np.arange(s, dtype=np.int32)
    want = ref_attn.gqa_attention(jq, jk, jv, q_positions=jnp.asarray(pos),
                                  kv_positions=jnp.asarray(pos), window=window, impl=impl)
    got = attention.gqa_attention(tq, tk, tv, q_positions=torch.from_numpy(pos),
                                  kv_positions=torch.from_numpy(pos), window=window, impl=impl)
    _close(got, want, TOL[dtype])


def test_flash_matches_gqa_attention_xla():
    """Mirror of test_flash_kernel_matches_gqa_attention_xla, in the port."""
    rng = np.random.default_rng(6)
    b, s, hq, hkv, d = 2, 256, 6, 3, 32
    _, (q, k, v) = _qkv(rng, b, s, s, hq, hkv, d, "float32")
    pos = torch.arange(s, dtype=torch.int32)
    got = flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    want = attention.gqa_attention(q, k, v, q_positions=pos, kv_positions=pos, impl="xla")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["auto", "xla_chunked"])
def test_chunked_impls_are_not_ported(impl):
    x = torch.zeros(1, 4, 2, 8)
    pos = torch.arange(4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.gqa_attention(x, x[:, :, :1], x[:, :, :1], q_positions=pos,
                                kv_positions=pos, impl=impl)


def _filled_cache(rng, b, m, hkv, d, cur_len, window):
    """A cache holding positions 0..cur_len (dense: slot = position;
    rolling: slot = position % m), as prefill then decode leave it."""
    kv = rng.standard_normal((2, b, cur_len + 1, hkv, d)).astype(np.float32)
    cache = np.zeros((2, b, m, hkv, d), np.float32)
    for p in range(cur_len + 1):
        if window is None or p > cur_len - m:
            cache[:, :, p % m if window else p] = kv[:, :, p]
    return cache


@pytest.mark.parametrize("window,cur_len", [
    (None, 0), (None, 9), (None, 31),  # dense: first slot, middle, last slot
    (16, 5), (16, 15), (16, 16), (16, 40),  # rolling: before, at and past the window
])
def test_decode_attention_matches_reference(window, cur_len):
    rng = np.random.default_rng(cur_len)
    b, hq, hkv, d = 2, 4, 2, 32
    m = 32 if window is None else window
    cache = _filled_cache(rng, b, m, hkv, d, cur_len, window)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    jk, jv = (jnp.asarray(c, jnp.bfloat16) for c in cache)
    want = ref_attn.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(cur_len, jnp.int32),
                                     window=window)
    tk, tv = (torch.from_numpy(c).bfloat16() for c in cache)
    got = attention.decode_attention(torch.from_numpy(q), tk, tv, cur_len, window=window)
    assert got.dtype == torch.bfloat16  # probabilities and output in the cache's dtype
    _close(got, want, 2e-5)
    # Per-row lengths: row i at its own cur_len equals a B=1 decode there.
    lens = torch.tensor([cur_len, max(cur_len - 3, 0)])
    rows = attention.decode_attention(torch.from_numpy(q), tk, tv, lens, window=window)
    for i in range(b):
        one = attention.decode_attention(torch.from_numpy(q[i:i + 1]), tk[i:i + 1],
                                         tv[i:i + 1], int(lens[i]), window=window)
        assert torch.equal(rows[i:i + 1], one)


@pytest.mark.parametrize("rolling", [False, True])
def test_cache_update_matches_reference(rolling):
    rng = np.random.default_rng(1)
    b, m, hkv, d = 2, 8, 2, 16
    ck, cv = rng.standard_normal((2, b, m, hkv, d)).astype(np.float32)
    kn, vn = rng.standard_normal((2, b, 1, hkv, d)).astype(np.float32)
    for cur_len in (0, 5, 7, 8, 13):  # dense clamps to the last slot
        want = ref_attn.cache_update(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
                                     jnp.asarray(vn), jnp.asarray(cur_len, jnp.int32), rolling)
        got = attention.cache_update(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
                                     torch.from_numpy(kn), torch.from_numpy(vn), cur_len, rolling)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
