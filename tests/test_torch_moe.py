"""Port parity of the MoE FFN and the two MoE archs: ``repro_torch.models.moe``
and the MoE branch of ``repro_torch.models.transformer`` against
``repro.models`` on the REDUCED mixtral-8x7b and llama4-maverick-400b-a17b,
with the JAX package's parameters carried across (numpy, seeded).

Tolerances:
* ``moe_apply`` at float32 compute: rtol = atol 1e-5 on ``y`` (f32
  reassociation in the router and the expert products), ``moe_aux`` and
  ``moe_z`` within 1e-6, ``moe_drop_frac`` exact (a count over the tokens);
  at bfloat16: tests/test_torch_transformer.py's bf16 limits, 2e-2 on ``y``.
* The full model at float32: tests/test_torch_transformer.py's 2e-5 on
  logits, its cache limits, 1e-6 on ``moe_loss``.
* The full model at bfloat16 is held to the reference's layers run one by
  one (``_attention_block``, ``_ffn_block``, ``_logits``), at 5e-2, the
  transformer tests' limit for the archs beyond llama.  Not to the
  reference's scanned ``forward``: XLA's fused scan rounds the bf16
  residual stream at other points than the op-by-op layers, and first come
  first served capacity turns one moved claim into other tokens' drops.
  The reference's own scanned forward and its layer loop differ by up to
  3.33 in the REDUCED llama4's logits (2 x 64 tokens), more than the port
  differs from either.
* The mirrors of tests/test_arch_smoke.py's consistency tests keep their
  tolerances (2e-2 / 5e-2; 5e-2 / 6e-2).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train.step import init_model_params

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_port_golden as golden  # noqa: E402

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
LOGITS_TOL = 2e-5
BF16_LAYER_TOL = 5e-2
CACHE_RTOL = 2.0 ** -7


def _f32(a):
    return np.asarray(a, np.float32)


def moe_inputs(arch, dtype="float32", capacity_factor=None, seed=0, skew=3.0):
    """The reference's ``moe_init`` parameters and a seeded [2, 64, D]
    input; ``skew`` adds one shared direction to every token, so the router
    crowds a few experts and the config's own capacity drops tokens."""
    jd, td = DTYPES[dtype]
    rcfg, pcfg = ref_get_arch(arch).reduced_config.moe, get_arch(arch).reduced_config.moe
    if capacity_factor is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=capacity_factor)
        pcfg = dataclasses.replace(pcfg, capacity_factor=capacity_factor)
    d, f = ref_get_arch(arch).reduced_config.d_model, ref_get_arch(arch).reduced_config.d_ff
    ref_p = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg, d, f)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), ref_p)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 64, d)) + skew * rng.standard_normal(d)).astype(np.float32)
    x_ref = jnp.asarray(x).astype(jd)
    x_port = torch.from_numpy(np.array(x_ref, np.float32)).to(td)
    return rcfg, pcfg, ref_p, p, x_ref, x_port, jd, td


def check_moe(arch, dtype, capacity_factor=None, **kw):
    rcfg, pcfg, ref_p, p, x_ref, x_port, jd, td = moe_inputs(arch, dtype, capacity_factor, **kw)
    want_y, want_aux = ref_moe.moe_apply(ref_p, rcfg, x_ref, jd)
    got_y, got_aux = moe.moe_apply(p, pcfg, x_port, td)
    assert got_y.dtype == td and tuple(got_y.shape) == want_y.shape
    tol = Y_TOL[dtype]
    np.testing.assert_allclose(got_y.float().numpy(), _f32(want_y), rtol=tol, atol=tol)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(got_aux[key]), float(want_aux[key]), rtol=AUX_TOL,
                                   atol=AUX_TOL)
    assert float(got_aux["moe_drop_frac"]) == float(want_aux["moe_drop_frac"])
    return float(want_aux["moe_drop_frac"])


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", ["config", "8.0"])
def test_moe_apply_matches_reference(arch, dtype, capacity):
    """At the config's own capacity tokens drop (the skewed input crowds
    the router); at 8.0, as the reference's consistency test runs, none do."""
    drop = check_moe(arch, dtype, None if capacity == "config" else 8.0)
    assert (drop > 0) if capacity == "config" else (drop == 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_one_token_groups(arch):
    """A decode step's shape: one token, one group, capacity top_k."""
    rcfg, pcfg, ref_p, p, x_ref, x_port, jd, td = moe_inputs(arch)
    want_y, _ = ref_moe.moe_apply(ref_p, rcfg, x_ref[:1, :1], jd)
    got_y, aux = moe.moe_apply(p, pcfg, x_port[:1, :1], td)
    np.testing.assert_allclose(got_y.numpy(), _f32(want_y), rtol=1e-5, atol=1e-5)
    assert moe.capacity(pcfg, 1) == pcfg.top_k and float(aux["moe_drop_frac"]) == 0.0


def test_moe_apply_keeps_the_group_assertion():
    _, pcfg, _, p, _, x_port, _, td = moe_inputs("mixtral-8x7b")
    with pytest.raises(ValueError, match="group"):
        moe.moe_apply(p, pcfg, x_port[:, :40].reshape(1, 80, -1), td)


def test_top_k_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4  # many ties
    rows[0] = 0.125  # all tied
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows), k)
        got_v, got_i = moe.top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_router_ties(arch, dtype):
    """Experts 1 and 2 share one router column: every token's two router
    probabilities tie exactly, and the lower expert must win the tie (its
    claim ranks first), as in ``lax.top_k``."""
    rcfg, pcfg, ref_p, p, x_ref, x_port, jd, td = moe_inputs(arch, dtype, skew=0.0)
    w = np.array(ref_p["router"]["w"])
    w[:, 2] = w[:, 1]
    ref_p = dict(ref_p, router={"w": jnp.asarray(w)})
    p = dict(p, router={"w": torch.from_numpy(w)})
    want_y, want_aux = ref_moe.moe_apply(ref_p, rcfg, x_ref, jd)
    got_y, got_aux = moe.moe_apply(p, pcfg, x_port, td)
    tol = Y_TOL[dtype]
    np.testing.assert_allclose(got_y.float().numpy(), _f32(want_y), rtol=tol, atol=tol)
    assert float(got_aux["moe_drop_frac"]) == float(want_aux["moe_drop_frac"])
    logits = x_port.float().reshape(-1, x_port.shape[-1]) @ p["router"]["w"]
    _, top = moe.top_k(torch.softmax(logits, -1), pcfg.top_k)
    assert (top == 1).any()
    first = torch.where(top == 1, torch.arange(pcfg.top_k), pcfg.top_k).min(-1).values
    second = torch.where(top == 2, torch.arange(pcfg.top_k), pcfg.top_k).min(-1).values
    assert bool((first < second)[second < pcfg.top_k].all()) and bool((second == pcfg.top_k).any())


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def configs(arch, dtype="float32", moe_cf=None, **kw):
    jd, td = DTYPES[dtype]
    rc = dataclasses.replace(ref_get_arch(arch).reduced_config, remat=False, compute_dtype=jd, **kw)
    pc = dataclasses.replace(get_arch(arch).reduced_config, remat=False, compute_dtype=td, **kw)
    if moe_cf is not None:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(rc.moe, capacity_factor=moe_cf))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, capacity_factor=moe_cf))
    return rc, pc


def both_params(rc, pc, seed=0):
    ref = ref_tf.init_params(jax.random.PRNGKey(seed), rc)
    return ref, tf.params_from_reference(jax.tree.map(np.asarray, ref), pc, device="cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=tol, atol=tol)


def close_cache(got, want):
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key].float().numpy(), _f32(want[key]),
                                   rtol=CACHE_RTOL, atol=2e-5)


def tokens(rc, shape=(2, 64), seed=0):
    return np.random.default_rng(seed).integers(0, rc.vocab, shape, dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_moe_loss_match_reference(arch, impl):
    rc, pc = configs(arch, attn_impl=impl)
    ref_p, p = both_params(rc, pc)
    toks = tokens(rc)
    want, want_loss = ref_tf.forward(ref_p, rc, jnp.asarray(toks))
    got, got_loss = tf.forward(p, pc, torch.from_numpy(toks))
    close(got, want, LOGITS_TOL)
    assert got_loss.dtype == torch.float32 and float(got_loss) > 0
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=AUX_TOL, atol=AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(arch, impl):
    """Prefill (K4's plain version under pallas, the windowed route for
    mixtral), then one decode step (the dense path: the reference's decode
    has no pallas path) from the reference's own cache, so a bf16 cache
    entry that the two packages' f32 K rounds to neighbouring values does
    not enter the decode comparison."""
    rc, pc = configs(arch, attn_impl=impl)
    ref_p, p = both_params(rc, pc)
    toks = tokens(rc, (1, 128))  # two groups; past mixtral's window of 64
    want_l, want_c, want_len = ref_tf.prefill(ref_p, rc, jnp.asarray(toks), extra_slots=4)
    got_l, got_c, got_len = tf.prefill(p, pc, torch.from_numpy(toks), extra_slots=4)
    assert got_len == int(want_len) and got_c["k"].shape == want_c["k"].shape
    close(got_l, want_l, LOGITS_TOL)
    close_cache(got_c, want_c)
    rc, pc = configs(arch)
    nxt = np.asarray(jnp.argmax(want_l, -1)).astype(np.int32)[:, None]
    cache = {k: torch.from_numpy(_f32(v)).to(torch.bfloat16) for k, v in want_c.items()}
    want_d, want_c2, _ = ref_tf.decode_step(ref_p, rc, want_c, jnp.asarray(nxt), want_len)
    got_d, got_c2, _ = tf.decode_step(p, pc, cache, torch.from_numpy(nxt), got_len)
    close(got_d, want_d, LOGITS_TOL)
    close_cache(got_c2, want_c2)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference_layers(arch):
    rc, pc = configs(arch, "bfloat16")
    ref_p, p = both_params(rc, pc)
    toks = tokens(rc)
    x = jnp.take(ref_p["embed"]["w"], jnp.asarray(toks), axis=0).astype(rc.compute_dtype)
    positions = jnp.arange(toks.shape[1], dtype=jnp.int32)
    loss = 0.0
    for i in range(rc.n_layers):
        lp = jax.tree.map(lambda a: a[i], ref_p["layers"])
        x, _, _ = ref_tf._attention_block(rc, lp, x, positions)
        x, aux = ref_tf._ffn_block(rc, lp, x)
        loss = loss + (aux["moe_aux"] + aux["moe_z"])
    want = ref_tf._logits(rc, ref_p, x)
    got, got_loss = tf.forward(p, pc, torch.from_numpy(toks))
    close(got, want, BF16_LAYER_TOL)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_decode_consistency(arch):
    """Mirror of tests/test_arch_smoke.py::test_lm_prefill_decode_consistency
    (mixtral; llama4 beside it), in the port, capacity 8.0 so no token
    drops, with the reference's tolerances."""
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.reduced_config, remat=False)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_model_params(spec, torch.Generator().manual_seed(2), cfg=cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    logits_full, _ = tf.forward(params, cfg, toks)
    logits_pre, cache, cur_len = tf.prefill(params, cfg, toks, extra_slots=4)
    torch.testing.assert_close(logits_pre, logits_full[:, -1], rtol=2e-2, atol=2e-2)
    nxt = torch.argmax(logits_pre, -1)[:, None]
    logits_dec, cache, cur_len = tf.decode_step(params, cfg, cache, nxt, cur_len)
    logits_full2, _ = tf.forward(params, cfg, torch.cat([toks, nxt], dim=1))
    torch.testing.assert_close(logits_dec, logits_full2[:, -1], rtol=5e-2, atol=5e-2)


def test_lm_swa_rolling_cache_matches_window():
    """Mirror of tests/test_arch_smoke.py::test_lm_swa_rolling_cache_matches_window
    on the REDUCED mixtral with window=16 and capacity 8.0: decode with a
    cache of ``window`` slots == full attention over the last window."""
    spec = get_arch("mixtral-8x7b")
    cfg = dataclasses.replace(spec.reduced_config, remat=False, window=16,
                              moe=dataclasses.replace(spec.reduced_config.moe,
                                                      capacity_factor=8.0))
    params = init_model_params(spec, torch.Generator().manual_seed(3), cfg=cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, 40)))
    logits_pre, cache, cur_len = tf.prefill(params, cfg, toks)
    assert cache["k"].shape[2] == 16
    logits_full, _ = tf.forward(params, cfg, toks)
    torch.testing.assert_close(logits_pre, logits_full[:, -1], rtol=5e-2, atol=5e-2)
    nxt = torch.argmax(logits_pre, -1)[:, None]
    logits_dec, _, _ = tf.decode_step(params, cfg, cache, nxt, cur_len)
    logits_full2, _ = tf.forward(params, cfg, torch.cat([toks, nxt], dim=1))
    torch.testing.assert_close(logits_dec, logits_full2[:, -1], rtol=6e-2, atol=6e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_and_init_match_reference(arch):
    """The ``moe`` subtree leaf for leaf, and the reference's init stds."""
    rc, pc = configs(arch)
    ref = jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0), rc))
    got = tf.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    got_flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert len(got_flat) == len(ref_leaves)
    for path, a in ref_leaves:
        assert tuple(got_flat[jax.tree_util.keystr(path)].shape) == a.shape, path
    m = got["layers"]["moe"]
    for key, d_in in (("w_gate", pc.d_model), ("w_up", pc.d_model), ("w_down", pc.d_ff)):
        assert float(m[key].abs().max()) <= 2 / np.sqrt(d_in)
        assert abs(float(m[key].std()) * np.sqrt(d_in) - 0.880) < 0.03
    assert float(m["router"]["w"].abs().max()) <= 2 / np.sqrt(pc.d_model)
    assert pc.param_count() == rc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    ref, port = ref_get_arch(arch), get_arch(arch)
    assert port.family == ref.family == "lm"
    assert ({k: dataclasses.asdict(v) for k, v in port.shapes.items()}
            == {k: dataclasses.asdict(v) for k, v in ref.shapes.items()})
    assert list(port.param_rules) == list(ref.param_rules)
    assert dict(port.rule_overrides) == dict(ref.rule_overrides)
    for rcfg, pcfg in ((ref.config, port.config), (ref.reduced_config, port.reduced_config)):
        for f in dataclasses.fields(rcfg):
            want, got = getattr(rcfg, f.name), getattr(pcfg, f.name)
            if f.name == "moe":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == dtypes.get(want, want), f.name
        assert pcfg.param_count() == rcfg.param_count()


# --------------------------------------------------------------------------
# serving and the golden entries
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference_engine(arch):
    """Both engines at float32 on the same prompts: the reference vmaps a
    B=1 decode over the slots, the port decodes each MoE slot as its own
    B=1 step, so every slot's token is a one-token MoE group in both."""
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import ServeEngine as RefEngine
    from repro_torch.serve.engine import Request, ServeEngine

    rc, pc = configs(arch)
    ref_p, p = both_params(rc, pc, seed=4)
    prompts = [np.random.default_rng(i).integers(0, rc.vocab, n, dtype=np.int32)
               for i, n in enumerate((5, 17, 11))]
    ref_eng = RefEngine(ref_p, rc, n_slots=2, max_len=64)
    eng = ServeEngine(p, pc, n_slots=2, max_len=64, device="cpu")
    for i, pr in enumerate(prompts):
        ref_eng.submit(RefRequest(rid=i, prompt=pr, max_new=5))
        eng.submit(Request(rid=i, prompt=pr, max_new=5))
    want = sorted(ref_eng.run_to_completion(), key=lambda r: r.rid)
    got = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    assert [r.tokens for r in got] == [r.tokens for r in want]


@pytest.mark.parametrize("arch", golden.LM_MOE_ARCHS)
def test_moe_golden_matches_reference(arch):
    """The JAX package recomputes the entry (floats within 1e-6); every
    greedy token leads its runner-up by far more than the logits' limit."""
    with open(golden.GOLDEN) as f:
        section = json.load(f)["lm_moe"]
    assert section["seed"] == golden.LM_SEED
    want = section["answers"][arch]
    assert golden.lm_moe_mismatch(golden.reference_lm_moe_entry(arch), want, tol=1e-6) is None
    least = min(min(m) for m in want["margins"])
    assert least > 5 * golden.LM_LOGITS_TOL * (1 + np.abs(want["prefill_logits"]).max())
    assert any(d > 0 for d in want["moe_drop_frac"])  # the config's capacity drops tokens


@pytest.mark.parametrize("arch", golden.LM_MOE_ARCHS)
def test_port_cpu_meets_moe_golden(arch):
    with open(golden.GOLDEN) as f:
        want = json.load(f)["lm_moe"]["answers"][arch]
    assert golden.lm_moe_mismatch(golden.port_lm_moe_entry(arch, "cpu"), want) is None
