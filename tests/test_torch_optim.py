"""Port parity of the optimizer: ``repro_torch.optim`` (AdamW in place, its
int8 quantizer, gradient compression, LR schedules) against ``repro.optim``
on the same numpy inputs, and mirrors of tests/test_optim.py.

Tolerances: the int8 quantizer and the int8 compression payload are
bitwise (the same f32 divisions, round half to even); one AdamW step from
the reference's own non-zero state is held to 1e-6 on parameters and fp32
moments (f32 rounding of the same elementwise formula), to one bf16 ulp on
bf16 moments, and to one int8 step on int8 moments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefConfig
from repro.optim import apply_updates as ref_apply
from repro.optim import init_state as ref_init
from repro.optim.adamw import _dequantize as ref_dequantize
from repro.optim.adamw import _quantize as ref_quantize
from repro.optim.compression import CompressionConfig as RefCompression
from repro.optim.compression import compress_decompress_psum as ref_compress
from repro.optim.schedules import constant as ref_constant
from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
from repro_torch import collectives
from repro_torch.optim import (
    AdamWConfig,
    CompressionConfig,
    Quantized,
    apply_updates,
    compress_decompress_psum,
    constant,
    init_state,
    opt_state_from_reference,
    warmup_cosine,
)
from repro_torch.optim import adamw
from repro_torch.optim.adamw import _dequantize, _quantize

KW = dict(lr=1e-2, weight_decay=0.1)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 17)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "layers": {"k": rng.standard_normal((3, 300)).astype(np.float32)}}


def _grads(rng, params):
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.3, params)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("n,block", [(1000, 256), (4096, 256), (77, 32)])
def test_quantize_is_bitwise_the_reference(n, block):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:8] = [127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, 0.0]  # ties: round half to even
    want = ref_quantize(jnp.asarray(x), block)
    got = _quantize(torch.from_numpy(x), block)
    assert got.shape == tuple(want.shape) and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(_dequantize(got).numpy(), np.asarray(ref_dequantize(want)))


def test_quantize_roundtrip_error_bound():
    """Mirror: per-block absmax int8, error <= absmax / 127."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32) * 3)
    y = _dequantize(_quantize(x, 256))
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 127


def test_int8_state_is_actually_small():
    """Mirror: int8 moments take under 0.3x the bytes of fp32."""
    st = init_state({"w": torch.zeros(1024, 256)}, AdamWConfig(moment_dtype="int8"))
    q = st.mu["w"]
    assert isinstance(q, Quantized) and q.q.dtype == torch.int8
    assert q.q.numel() + q.scale.numel() * 4 < 1024 * 256 * 4 * 0.3


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_apply_updates_matches_reference_from_its_state(dtype):
    """Three reference steps, then one more step in both packages from the
    reference's state (``opt_state_from_reference``) with the same grads."""
    rcfg = RefConfig(moment_dtype=dtype, **KW)
    cfg = AdamWConfig(moment_dtype=dtype, **KW)
    rng = np.random.default_rng(2)
    params = jax.tree.map(jnp.asarray, _params())
    state = ref_init(params, rcfg)
    for _ in range(3):
        params, state, _ = ref_apply(params, jax.tree.map(jnp.asarray, _grads(rng, params)),
                                     state, rcfg)
    grads = _grads(rng, params)
    host = jax.tree.map(np.asarray, (params, state))
    tp, ts = _torch(host[0]), opt_state_from_reference(host[1], device="cpu")
    assert int(ts.step) == 3
    want_p, want_s, want_m = ref_apply(params, jax.tree.map(jnp.asarray, grads), state, rcfg)
    got_p, got_s, got_m = apply_updates(tp, _torch(grads), ts, cfg)
    assert got_p is tp and got_s is ts and int(got_s.step) == 4  # in place
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]), rtol=1e-6)
    for key in ("w", "b"):
        np.testing.assert_allclose(got_p[key].numpy(), np.asarray(want_p[key]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_p["layers"]["k"].numpy(), np.asarray(want_p["layers"]["k"]),
                               rtol=0, atol=1e-6)
    for got_tree, want_tree in ((got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
        for key in ("w", "b"):
            g, w = got_tree[key], want_tree[key]
            if dtype == "int8":
                assert np.abs(g.q.numpy().astype(int) - np.asarray(w.q).astype(int)).max() <= 1
                np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale), rtol=1e-5)
            elif dtype == "bf16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                           rtol=2.0 ** -7, atol=0)
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_chunked_update_changes_nothing(dtype, monkeypatch):
    """The in-place update runs each leaf in flat chunks; chunks of 64
    elements (not a divisor of the leaves, a multiple of the 32 block) give
    the same bits as one chunk a leaf (the global norm's own chunks, which
    set its reduction order, stay as they are)."""
    cfg = AdamWConfig(moment_dtype=dtype, block=32, **KW)
    rng = np.random.default_rng(4)
    grads = [_grads(rng, _params()) for _ in range(3)]

    def run():
        p = _torch(_params())
        s = init_state(p, cfg)
        for g in grads:
            p, s, _ = apply_updates(p, _torch(g), s, cfg)
        return p, s

    whole = run()
    monkeypatch.setattr(adamw, "CHUNK", 64)
    chunked = run()
    for a, b in zip(jax.tree.leaves(whole[0]), jax.tree.leaves(chunked[0])):
        assert torch.equal(a, b)
    for tree_a, tree_b in ((whole[1].mu, chunked[1].mu), (whole[1].nu, chunked[1].nu)):
        for a, b in zip(adamw._moment_leaves(tree_a), adamw._moment_leaves(tree_b)):
            if isinstance(a, Quantized):
                assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_adamw_moment_dtypes_track_fp32(dtype):
    """Mirror of test_adamw_moment_dtypes_under_jit: 5 steps with bf16 or
    int8 moments stay within 5e-3 of the fp32 trajectory."""
    rng = np.random.default_rng(2)
    grads = [_grads(rng, _params()) for _ in range(5)]
    out = {}
    for md in (dtype, "fp32"):
        cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, moment_dtype=md)
        p = _torch(_params())
        s = init_state(p, cfg)
        for g in grads:
            p, s, _ = apply_updates(p, _torch(g), s, cfg)
        out[md] = p
    for a, b in zip(jax.tree.leaves(out[dtype]), jax.tree.leaves(out["fp32"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-3)


def test_clipping_scales_the_grads_on_the_device():
    """Above clip_norm the grads are scaled in place by clip / norm (a
    tensor: no host read); below it they are left as they are."""
    cfg = AdamWConfig(clip_norm=1.0, **KW)
    for scale, factor in ((10.0, None), (0.01, 1.0)):
        g = {"w": torch.full((4,), scale)}
        p = {"w": torch.zeros(4)}
        _, _, m = apply_updates(p, g, init_state(p, cfg), cfg)
        norm = float(m["grad_norm"])
        assert norm == pytest.approx(2 * scale)
        want = 1.0 / norm if factor is None else factor
        np.testing.assert_allclose(g["w"].numpy(), scale * want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["none", "bf16", "int8_ef"])
def test_compression_matches_reference(kind):
    """Three steps with error feedback: the port's output and error state
    equal the reference's (bitwise: the same f32 divisions and rounding)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (300,), "b": (7, 9)}
    rerr = {k: jnp.zeros(s) for k, s in shapes.items()} if kind == "int8_ef" else None
    terr = {k: torch.zeros(s) for k, s in shapes.items()} if kind == "int8_ef" else None
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
        want, rerr, wf = ref_compress(jax.tree.map(jnp.asarray, g), rerr,
                                      RefCompression(kind=kind, block=64))
        got, terr, gf = compress_decompress_psum(_torch(g), terr, CompressionConfig(kind, 64))
        assert gf == wf
        for k in shapes:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32))
            if terr is not None:
                np.testing.assert_array_equal(terr[k].numpy(), np.asarray(rerr[k]))


def test_compression_error_feedback_does_not_accumulate():
    """Mirror: with int8 + error feedback the running sums of the true and
    the compressed grads stay within 0.05 of each other over 30 steps."""
    cfg = CompressionConfig(kind="int8_ef", block=64)
    rng = np.random.default_rng(3)
    true_sum, comp_sum = np.zeros(512), np.zeros(512)
    err = {"g": torch.zeros(512)}
    for _ in range(30):
        g = rng.standard_normal(512).astype(np.float32) * 0.1
        true_sum += g
        out, err, _ = compress_decompress_psum({"g": torch.from_numpy(g)}, err, cfg)
        comp_sum += out["g"].double().numpy()
    assert np.abs(comp_sum - true_sum).max() < 0.05


def test_bf16_compression_halves_and_roundtrips():
    """Mirror: the bf16 wire halves the bytes and round-trips within 1e-2."""
    g = {"g": torch.linspace(-1, 1, 128)}
    out, _, factor = compress_decompress_psum(g, None, CompressionConfig(kind="bf16"))
    assert factor == 0.5
    torch.testing.assert_close(out["g"], g["g"], rtol=0, atol=1e-2)


def test_compression_over_a_group_sums_and_counts(tmp_path):
    """With a one-rank gloo group the reductions go through
    ``repro_torch.collectives`` (a SUM per leaf, and a MAX of the block
    scales for int8) and give the group-less numbers."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        group = dist.new_group([0])
        rng = np.random.default_rng(6)
        g = {"a": torch.from_numpy(rng.standard_normal(200).astype(np.float32))}
        for kind, reduces in (("none", 1), ("bf16", 1), ("int8_ef", 2)):
            cfg = CompressionConfig(kind=kind, block=64)
            err = {"a": torch.zeros(200)} if kind == "int8_ef" else None
            want, want_err, _ = compress_decompress_psum(
                {"a": g["a"].clone()}, None if err is None else dict(err), cfg)
            collectives.reset()
            got, got_err, _ = compress_decompress_psum({"a": g["a"].clone()}, err, cfg, group)
            assert collectives.all_reduce.count == reduces
            assert torch.equal(got["a"], want["a"])
            if err is not None:
                assert torch.equal(got_err["a"], want_err["a"])
    finally:
        dist.destroy_process_group()


def test_schedules_match_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    kw = dict(peak_lr=3e-4, warmup=10, total=30, floor=0.1)
    want = ref_warmup_cosine(jnp.asarray(steps), **kw)
    got = warmup_cosine(torch.from_numpy(steps), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(constant(torch.from_numpy(steps), peak_lr=1e-3).numpy(),
                                  np.asarray(ref_constant(jnp.asarray(steps), peak_lr=1e-3)))


def test_config_defaults_match_reference():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(RefConfig())
    assert dataclasses.asdict(CompressionConfig()) == dataclasses.asdict(RefCompression())
