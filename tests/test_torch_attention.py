"""Port parity of the attention layer: the flash-attention kernel K4's plain
version (``repro_torch.kernels.flash_attention``), ``gqa_attention`` and
``decode_attention`` against the JAX package, on the same numpy inputs.

The reference's Pallas kernel runs in interpret mode, as its own tests run
it (tests/test_kernels.py).  Tolerances are the reference tests' own:
rtol/atol 2e-5 for float32 (f32 reassociation: the sums run in another
order) and 2e-2 for bfloat16; gradients rtol 2e-4 / atol 1e-5, the
reference's own limits for its chunked backward.  K4 itself runs only on the card:
tests/test_torch_cuda.py holds it against this plain version.
"""

import jax
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


# -- the chunked path ('xla_chunked', 'auto') and K4's trainable route ---------

# tests/test_attention_chunked.py's five shapes: (sq, sk, hq, hkv, window).
CHUNK_SHAPES = [
    (64, 64, 4, 4, None),
    (64, 64, 8, 2, None),
    (48, 48, 4, 2, 16),  # sliding window
    (37, 37, 6, 3, None),  # not a chunk multiple
    (16, 80, 4, 2, None),  # kv longer than q
]
# The reference's backward cases: (sq, hq, hkv, window, q_chunk, kv_chunk).
BACKWARD_CASES = [
    (32, 4, 4, None, 8, 8),
    (37, 6, 3, None, 16, 8),  # GQA + padding
    (48, 4, 2, 16, 16, 16),  # sliding window
]
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)  # the reference tests' limits on gradients


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sq,sk,hq,hkv,window", CHUNK_SHAPES)
def test_chunked_matches_dense_and_reference(sq, sk, hq, hkv, window):
    """Mirror of test_chunked_matches_dense: the port's 'xla_chunked' equals
    its dense path and the reference's chunked path within 2e-5."""
    rng = np.random.default_rng(0)
    b, d = 2, 16
    q, k, v = _f32(rng, (b, sq, hq, d)), _f32(rng, (b, sk, hkv, d)), _f32(rng, (b, sk, hkv, d))
    qpos, kpos = np.arange(sk - sq, sk, dtype=np.int32), np.arange(sk, dtype=np.int32)
    kw = dict(q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
              window=window)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    dense = attention.gqa_attention(*t, impl="xla", **kw)
    chunked = attention.gqa_attention(*t, impl="xla_chunked", q_chunk=16, kv_chunk=32, **kw)
    torch.testing.assert_close(chunked, dense, rtol=2e-5, atol=2e-5)
    want = ref_attn.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(qpos),
                                  kv_positions=jnp.asarray(kpos), window=window,
                                  impl="xla_chunked", q_chunk=16, kv_chunk=32)
    _close(chunked, want, 2e-5)


def test_chunked_respects_kv_valid():
    """Mirror of test_chunked_respects_kv_valid, against the dense path and
    the reference."""
    rng = np.random.default_rng(1)
    b, s, hq, hkv, d = 2, 32, 4, 2, 8
    q, k, v = _f32(rng, (b, s, hq, d)), _f32(rng, (b, s, hkv, d)), _f32(rng, (b, s, hkv, d))
    valid = rng.random((b, s)) < 0.8
    valid[:, 0] = True  # at least one valid key per row
    pos = np.arange(s, dtype=np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
              kv_valid=torch.from_numpy(valid))
    dense = attention.gqa_attention(*t, impl="xla", **kw)
    chunked = attention.gqa_attention(*t, impl="xla_chunked", q_chunk=8, kv_chunk=8, **kw)
    torch.testing.assert_close(chunked, dense, rtol=2e-5, atol=2e-5)
    want = ref_attn.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(pos),
                                  kv_positions=jnp.asarray(pos), kv_valid=jnp.asarray(valid),
                                  impl="xla_chunked", q_chunk=8, kv_chunk=8)
    _close(chunked, want, 2e-5)


def _torch_grads(fn, arrays, w):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    (out * torch.from_numpy(w)).mean().backward()
    return out.detach(), [x.grad for x in xs]


def _jax_grads(fn, arrays, w):
    def loss(*xs):
        out = fn(*xs)
        return jnp.mean(out * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    return out, grads


@pytest.mark.parametrize("sq,hq,hkv,window,qc,kc", BACKWARD_CASES)
def test_chunked_forward_and_grads_match_reference(sq, hq, hkv, window, qc, kc):
    """The port's ``_chunked_gqa`` (grouped K/V, its custom backward) against
    the reference's on the same inputs: forward within 2e-5, gradients
    within rtol 2e-4 / atol 1e-5."""
    rng = np.random.default_rng(3)
    b, d = 2, 16
    arrays = [_f32(rng, (b, sq, hq, d)), _f32(rng, (b, sq, hkv, d)), _f32(rng, (b, sq, hkv, d))]
    w = _f32(rng, (b, sq, hq, d))
    pos = np.arange(sq, dtype=np.int32)
    out, grads = _torch_grads(lambda q, k, v: attention._chunked_gqa(
        q, k, v, q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
        kv_valid=None, window=window, q_chunk=qc, kv_chunk=kc), arrays, w)
    want, want_grads = _jax_grads(lambda q, k, v: ref_attn._chunked_gqa(
        q, k, v, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos), kv_valid=None,
        window=window, q_chunk=qc, kv_chunk=kc), arrays, jnp.asarray(w))
    _close(out, want, 2e-5)
    for g, wg in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL)


@pytest.mark.parametrize("sq,hq,hkv,window,qc,kc", BACKWARD_CASES)
def test_chunked_backward_matches_dense_autodiff(sq, hq, hkv, window, qc, kc):
    """Mirror of test_flash_backward_matches_dense_autodiff: 'xla_chunked'
    (K/V repeated, the custom backward) against autograd through the dense
    path, rtol 2e-4 / atol 1e-5."""
    rng = np.random.default_rng(3)
    b, d = 2, 16
    arrays = [_f32(rng, (b, sq, hq, d)), _f32(rng, (b, sq, hkv, d)), _f32(rng, (b, sq, hkv, d))]
    w = _f32(rng, (b, sq, hq, d))
    pos = torch.arange(sq, dtype=torch.int32)

    def impl(name):
        return lambda q, k, v: attention.gqa_attention(
            q, k, v, q_positions=pos, kv_positions=pos, window=window, impl=name,
            q_chunk=qc, kv_chunk=kc)

    _, dense = _torch_grads(impl("xla"), arrays, w)
    _, chunked = _torch_grads(impl("xla_chunked"), arrays, w)
    for a, c in zip(dense, chunked):
        torch.testing.assert_close(c, a, **GRAD_TOL)


def test_auto_dispatches_at_the_reference_threshold(monkeypatch):
    """'auto' takes the chunked path exactly when Sq*Sk > 4096*2048, as the
    reference does; small inputs equal the dense path (the reference's
    test_auto_dispatches_small_to_dense)."""
    assert attention.AUTO_CHUNKED_SCORES == 4096 * 2048
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_f32(rng, (1, 8, 2, 4))) for _ in range(3))
    pos = torch.arange(8, dtype=torch.int32)
    out = attention.gqa_attention(q, k, v, q_positions=pos, kv_positions=pos, impl="auto")
    ref = attention.gqa_attention(q, k, v, q_positions=pos, kv_positions=pos, impl="xla")
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)
    calls = []
    monkeypatch.setattr(attention, "_chunked_gqa", lambda q, *a, **kw: calls.append(q.shape[1]) or q)
    for sq, sk in ((2048, 4096), (2049, 4096), (1, 8192 * 1024), (1, 8192 * 1024 + 1)):
        calls.clear()
        x, y = torch.zeros(1, sq, 1, 1), torch.zeros(1, sk, 1, 1)
        attention.gqa_attention(x, y, y, q_positions=torch.zeros(sq, dtype=torch.int32),
                                kv_positions=torch.zeros(sk, dtype=torch.int32), impl="auto")
        assert calls == ([sq] if sq * sk > 4096 * 2048 else [])


def test_flash_trainable_grads_match_reference_and_dense():
    """Mirror of test_flash_trainable_grads_match_dense: the port's
    ``flash_attention_trainable`` (K4's plain version forward on the CPU,
    the chunked backward at 64 x 64) against the reference's (its Pallas
    forward in interpret mode) and against dense autodiff, rtol 2e-4 /
    atol 1e-5; and bitwise equal to the vjp of ``_chunked_gqa``."""
    from repro.kernels.flash_attention.ops import flash_attention_trainable as ref_trainable
    from repro_torch.kernels.flash_attention.ops import flash_attention_trainable

    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 1, 256, 4, 2, 32
    arrays = [_f32(rng, (b, s, hq, d)), _f32(rng, (b, s, hkv, d)), _f32(rng, (b, s, hkv, d))]
    w = _f32(rng, (b, s, hq, d))
    pos = np.arange(s, dtype=np.int32)
    tpos = torch.from_numpy(pos)
    before = flash_attention.launches
    out, grads = _torch_grads(lambda q, k, v: flash_attention_trainable(
        q, k, v, q_positions=tpos, kv_positions=tpos, bwd_q_chunk=64, bwd_kv_chunk=64),
        arrays, w)
    assert flash_attention.launches == before  # the plain version on a CPU tensor
    _, want = _jax_grads(lambda q, k, v: ref_trainable(
        q, k, v, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        bwd_q_chunk=64, bwd_kv_chunk=64), arrays, jnp.asarray(w))
    _, dense = _torch_grads(lambda q, k, v: attention.gqa_attention(
        q, k, v, q_positions=tpos, kv_positions=tpos, impl="xla"), arrays, w)
    _, chunked = _torch_grads(lambda q, k, v: attention._chunked_gqa(
        q, k, v, q_positions=tpos, kv_positions=tpos, kv_valid=None, window=None,
        q_chunk=64, kv_chunk=64), arrays, w)
    for g, wg, dg, cg in zip(grads, want, dense, chunked):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL)
        torch.testing.assert_close(g, dg, **GRAD_TOL)
        assert torch.equal(g, cg)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_refuses_autograd_like_the_reference(which):
    """K4 has no backward: with grad on and q, k or v requiring grad,
    ``flash_attention`` and ``gqa_attention(impl='pallas')`` raise naming
    the trainable route (on the CPU's plain version as on the card), as the
    reference cannot differentiate its Pallas call; with grad off they run."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), tx = _qkv(rng, 1, 16, 16, 4, 2, 16, "float32")
    pos = np.arange(16, dtype=np.int32)
    tpos = torch.from_numpy(pos)
    tx = dict(zip("qkv", tx))
    tx[which].requires_grad_()
    with pytest.raises(RuntimeError, match="flash_attention_trainable"):
        flash_attention(tx["q"], tx["k"], tx["v"], q_positions=tpos, kv_positions=tpos)
    with pytest.raises(RuntimeError, match="flash_attention_trainable"):
        attention.gqa_attention(tx["q"], tx["k"], tx["v"], q_positions=tpos, kv_positions=tpos,
                                impl="pallas")
    with torch.no_grad():
        flash_attention(tx["q"], tx["k"], tx["v"], q_positions=tpos, kv_positions=tpos)
    with pytest.raises(AssertionError):  # the reference's Pallas transpose
        jax.grad(lambda q, k, v: ref_attn.gqa_attention(
            q, k, v, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
            impl="pallas").mean(), argnums=(0, 1, 2))(jq, jk, jv)


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
