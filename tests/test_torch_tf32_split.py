"""The arithmetic of K4's and K4b's float32 kernels, which take every
product on the tensor cores as three TF32 products (hi = x rounded to TF32,
lo = x - hi rounded again; lo hi + hi lo + hi hi into one f32 sum),
emulated on the CPU (``ref.tf32_split_matmul``) and held to the limits the
card's tests hold the kernels to:

- the emulated forward against the reference's Pallas kernel (interpret
  mode, as tests/test_torch_attention.py runs it) within rtol = atol 2e-5
  and each row's relative L2 error within 1e-5 (tests/test_torch_cuda.py's
  FLASH_TOL and FLASH_ROW_TOL for float32);
- the emulated backward against the chunked vjp, K4b's plain version,
  within 2^-12 of (rms + |want|) elementwise and 2^-14 relative L2 over
  (dq, dk, dv) (tests/test_torch_cuda.py's BWD_TOL for float32).

One TF32 product alone (the control) must fail both.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_tf32_ref,
    flash_attention_tf32_ref,
    tf32_round,
    tf32_split_matmul,
)
from repro_torch.models.attention import chunked_vjp

# The float32 cases of tests/test_torch_attention.py's CASES: (b, s, hq,
# hkv, d, window, offset of the positions): causal, GQA, a window, the
# padding path, a window over positions from 1000.
F32_CASES = [
    (2, 256, 4, 4, 64, None, 0),
    (1, 256, 8, 2, 64, None, 0),
    (2, 384, 4, 2, 32, 128, 0),
    (1, 300, 2, 1, 64, None, 0),
    (1, 512, 4, 2, 64, 64, 1000),
]
FLASH_TOL, FLASH_ROW_TOL = 2e-5, 1e-5
BWD_TOL = (2.0 ** -12, 2.0 ** -14)


def _inputs(b, s, hq, hkv, d, offset, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32) + offset
    return q, k, v, dout, pos


def _forward_outside(got: torch.Tensor, want: np.ndarray):
    """(values outside rtol = atol FLASH_TOL, rows past FLASH_ROW_TOL)."""
    want = torch.from_numpy(np.array(want, np.float32)).double()
    got = got.double()
    err = (got - want).abs()
    row = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return (int((err > FLASH_TOL + FLASH_TOL * want.abs()).sum()),
            int((row > FLASH_ROW_TOL).sum()))


def _backward_outside(got, want):
    """(elements outside the elementwise limit, whether the relative L2
    error is past its limit), as tests/test_torch_cuda.py::_bwd_outside."""
    elem, rel = BWD_TOL
    want = [w.double() for w in want]
    scale = (sum(w.square().sum() for w in want) / sum(w.numel() for w in want)).sqrt()
    errs = [(g.double() - w).abs() for g, w in zip(got, want)]
    outside = sum(int((e > elem * (scale + w.abs())).sum()) for e, w in zip(errs, want))
    l2 = (sum(e.square().sum() for e in errs) / sum(w.square().sum() for w in want)).sqrt()
    return outside, bool(l2 > rel)


def _reference_forward(q, k, v, pos, window):
    return ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
                     window=window, block_q=128, block_kv=128, interpret=True)


@pytest.mark.parametrize("seed", range(3))
def test_tf32_round_keeps_ten_bits_and_lo_is_exact(seed):
    """hi has its low 13 bits clear and lies within half a TF32 ulp of x
    (ties away from zero); x - hi is exact in f32 and its own rounding
    leaves x - hi - lo within 2^-22 |x|."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(100_000) * np.exp2(rng.integers(-30, 30, 100_000))).astype(np.float32)
    x[:4] = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11, 0.0]  # ties
    t = torch.from_numpy(x)
    hi = tf32_round(t)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert hi[:4].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9, 0.0]
    x64, hi64 = t.double(), hi.double()
    assert ((x64 - hi64).abs() <= 2.0 ** -11 * x64.abs()).all()
    lo = tf32_round(t - hi)
    assert torch.equal((t - hi).double(), x64 - hi64)  # x - hi is exact
    assert ((x64 - hi64 - lo.double()).abs() <= 2.0 ** -22 * x64.abs()).all()


def test_split_matmul_is_f32_level_and_one_product_is_not():
    """The three products keep a K = 128 product near f32's error; one
    product is 2^-11-level."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    exact = a.double() @ b.double()
    norm = exact.norm()
    assert ((tf32_split_matmul(a, b).double() - exact).norm() / norm) < 1e-6
    assert ((tf32_split_matmul(a, b, products=1).double() - exact).norm() / norm) > 1e-4


@pytest.mark.parametrize("b,s,hq,hkv,d,window,offset", F32_CASES)
def test_split_forward_matches_reference_kernel(b, s, hq, hkv, d, window, offset):
    q, k, v, _, pos = _inputs(b, s, hq, hkv, d, offset)
    want = _reference_forward(q, k, v, pos, window)
    tpos = torch.from_numpy(pos)
    got = flash_attention_tf32_ref(*(torch.from_numpy(a) for a in (q, k, v)), tpos, tpos,
                                   window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _forward_outside(got, want) == (0, 0)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,offset", F32_CASES)
def test_one_product_forward_fails_the_limits(b, s, hq, hkv, d, window, offset):
    q, k, v, _, pos = _inputs(b, s, hq, hkv, d, offset)
    want = _reference_forward(q, k, v, pos, window)
    tpos = torch.from_numpy(pos)
    got = flash_attention_tf32_ref(*(torch.from_numpy(a) for a in (q, k, v)), tpos, tpos,
                                   window=window, products=1)
    assert _forward_outside(got, want) != (0, 0)


def _backward(b, s, hq, hkv, d, window, offset, products):
    q, k, v, dout, pos = (torch.from_numpy(a) for a in _inputs(b, s, hq, hkv, d, offset))
    want = chunked_vjp(q, k, v, dout, q_positions=pos, kv_positions=pos, window=window,
                       q_chunk=128, kv_chunk=128)
    got = flash_attention_bwd_tf32_ref(q, k, v, dout, pos, pos, window=window,
                                       products=products)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
    return _backward_outside(got, want)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,offset", F32_CASES)
def test_split_backward_matches_chunked_vjp(b, s, hq, hkv, d, window, offset):
    assert _backward(b, s, hq, hkv, d, window, offset, products=3) == (0, False)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,offset", F32_CASES)
def test_one_product_backward_fails_the_limits(b, s, hq, hkv, d, window, offset):
    assert _backward(b, s, hq, hkv, d, window, offset, products=1) != (0, False)


def test_f32_scratch_bytes_counts_each_part():
    """``ops.f32_scratch_bytes`` at B=1, Sq=Sk=300, 4/2 heads, D=40 (DP 64,
    the sequence rounded up to 304 for the column copies): the bounds
    (2 x 10 blocks of 32, 8 bytes each), then hi and lo of each copy, each
    part rounded up to 256 bytes."""
    up = lambda n: -(-n // 256) * 256  # noqa: E731
    q_rows, q_cols = 8 * 4 * 300 * 64, 8 * 4 * 64 * 304
    k_rows, k_cols = 8 * 2 * 300 * 64, 8 * 2 * 64 * 304
    assert ops.f32_scratch_bytes(1, 300, 300, 4, 2, 40) == up(160) + q_rows + k_rows + k_cols
    assert ops.f32_scratch_bytes(1, 300, 300, 4, 2, 40, backward=True) == (
        up(160) + 2 * (q_rows + q_cols) + 2 * k_rows + k_cols)
    # D <= 32 pads to 32 columns, D > 64 to 128.
    assert ops.f32_scratch_bytes(1, 8, 8, 1, 1, 8) == up(16) + 3 * up(8 * 8 * 32)
    assert ops.f32_scratch_bytes(1, 8, 8, 1, 1, 72) == up(16) + 3 * 8 * 8 * 128


@pytest.mark.parametrize("backward", [False, True])
def test_f32_wrapper_passes_the_split_scratch(backward, monkeypatch):
    """On the kernel route (forced here on CPU tensors, the library a stub)
    the float32 wrappers hand the C entry, as its ``bounds`` argument, a
    byte scratch of exactly ``f32_scratch_bytes``, and count one launch."""
    made, calls = [], []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        made.append(out)
        return out

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(ops, "use_kernel", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib = types.SimpleNamespace(flash_attention_fwd=entry, flash_attention_bwd=entry)
    monkeypatch.setattr(ops, "_library", lambda: lib)
    monkeypatch.setattr(ops, "_bwd_library", lambda: lib)
    rng = np.random.default_rng(0)
    b, sq, sk, hq, hkv, d = 2, 300, 301, 4, 2, 40
    q, out, dout = (torch.from_numpy(rng.standard_normal((b, sq, hq, d)).astype(np.float32))
                    for _ in range(3))
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, hkv, d)).astype(np.float32))
            for _ in range(2))
    qpos, kpos = torch.arange(sq, dtype=torch.int32) + 1, torch.arange(sk, dtype=torch.int32)
    if backward:
        before = ops.flash_attention_bwd.launches
        ops.flash_attention_bwd(q, k, v, out, dout, torch.zeros(b, hq, sq), q_positions=qpos,
                                kv_positions=kpos)
        assert ops.flash_attention_bwd.launches == before + 1
        ptr = calls[0][11]
    else:
        before = ops.flash_attention.launches
        with torch.no_grad():
            ops.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos)
        assert ops.flash_attention.launches == before + 1
        ptr = calls[0][7]
    assert len(calls) == 1
    scratch = [m for m in made if m.data_ptr() == ptr]
    assert len(scratch) == 1 and scratch[0].dtype == torch.uint8
    assert scratch[0].numel() == ops.f32_scratch_bytes(b, sq, sk, hq, hkv, d, backward=backward)
