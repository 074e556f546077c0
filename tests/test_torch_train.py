"""Port parity of the LM training path: ``lm_loss``, ``make_train_step``
(forward, backward with remat, AdamW in place), the serve steps and the
training CLI, against the JAX package on the REDUCED configs of the five
LM archs, with the same numpy-drawn parameters and tokens.

Tolerances, float32 compute:
* the loss and its metrics: rtol/atol 2e-5 (f32 reassociation);
* gradients: rtol 1e-4 / atol 1e-6 per leaf (the same, through a
  backward that sums in another order);
* parameters after one step: 1e-6 + 1e-5 |p| wherever the reference's
  clipped gradient has |g| >= 1e-6.  Below that, the first AdamW step's
  delta g / (|g| + eps) magnifies a gradient's rounding by up to
  1 / eps = 1e8 (a few elements in 10^4): those are held to the update's
  own bound 2 lr (1 + wd |p|).
bfloat16 compute is held to finite values and moved parameters, as
tests/test_arch_smoke.py::test_lm_train_step holds the reference.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_golden as golden

from repro.configs import get_arch as ref_get_arch
from repro.data.synthetic import make_batch as ref_make_batch
from repro.models import transformer as ref_tf
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import init_state as ref_init_state
from repro.train import step as ref_step
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import make_batch
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import step

ARCHS = list(golden.LM_TRAIN_ARCHS)
LR, WD = 1e-3, 0.01


def configs(arch, dtype="float32", **kw):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rc = dataclasses.replace(ref_get_arch(arch).reduced_config, compute_dtype=jd, **kw)
    pc = dataclasses.replace(get_arch(arch).reduced_config, compute_dtype=td, **kw)
    return rc, pc


def both(arch, dtype="float32", **kw):
    """(ref config, port config, ref params, port params, ref batch, port batch)."""
    rc, pc = configs(arch, dtype, **kw)
    host = golden.lm_params(get_arch(arch).reduced_config)
    toks = golden.lm_train_batch()
    return (rc, pc, jax.tree.map(jnp.asarray, host), tf.params_from_reference(host, pc, "cpu"),
            {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


def _ref_leaves(t):
    return [(jax.tree_util.keystr(k), np.asarray(a))
            for k, a in jax.tree_util.tree_flatten_with_path(t)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    rc, pc, rp, tp, rb, tb = both(arch)
    (want, wm), wg = jax.value_and_grad(lambda p: ref_tf.lm_loss(p, rc, rb), has_aux=True)(rp)
    loss, metrics, grads = step.loss_and_grads(step.make_loss_fn(get_arch(arch), "train", pc),
                                               tp, tb)
    assert sorted(metrics) == sorted(wm)
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5, atol=2e-5)
    for k in wm:
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]), rtol=2e-5, atol=2e-5)
    got = list(tree.leaves_with_paths(grads))
    assert [k for k, _ in got] == [k for k, _ in _ref_leaves(wg)]
    for (key, g), (_, w) in zip(got, _ref_leaves(wg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    rc, pc, rp, tp, rb, tb = both(arch)
    ropt, topt = RefAdamW(lr=LR, weight_decay=WD), AdamWConfig(lr=LR, weight_decay=WD)
    rstep = jax.jit(ref_step.make_train_step(ref_step.make_loss_fn(ref_get_arch(arch), "train",
                                                                   cfg=rc), ropt))
    wg = jax.grad(lambda p: ref_tf.lm_loss(p, rc, rb)[0])(rp)
    want_p, want_s, wm = rstep(rp, ref_init_state(rp, ropt), rb)
    factor = min(1.0, 1.0 / float(wm["grad_norm"]))  # clip_norm 1.0
    small = {k: np.abs(g) * factor < 1e-6 for k, g in _ref_leaves(wg)}
    before = {k: v.clone() for k, v in tree.leaves_with_paths(tp)}
    tstep = step.make_train_step(step.make_loss_fn(get_arch(arch), "train", cfg=pc), topt)
    got_p, got_s, gm = tstep(tp, init_state(tp, topt), tb)
    assert got_p is tp and int(got_s.step) == 1  # in place
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]), rtol=2e-5)
    np.testing.assert_allclose(float(gm["total_loss"]), float(wm["total_loss"]), rtol=2e-5)
    for (key, g), (_, w) in zip(tree.leaves_with_paths(got_p), _ref_leaves(want_p)):
        g = g.numpy()
        p0 = before[key].numpy()
        off = (np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)) & ~small[key]
        assert not off.any(), (key, int(off.sum()), int(small[key].sum()))
        bound = 2 * LR * (1 + WD * np.abs(p0))
        assert (np.abs(g - w) <= bound + 1e-6).all(), key
        assert not np.array_equal(g, p0), key  # moved


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_is_finite_and_moves(arch):
    """Mirror of test_lm_train_step: bf16 compute on the reference's
    smoke batch (seq 64, batch 2), one step: finite loss and parameters,
    every leaf moved."""
    spec = get_arch(arch)
    cfg = spec.reduced_config
    batch = make_batch(spec, "train", reduced_shape=dict(seq_len=64, global_batch=2),
                       device="cpu")
    ref = ref_make_batch(ref_get_arch(arch), "train",
                         reduced_shape=dict(seq_len=64, global_batch=2))
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(ref["tokens"]))
    params = step.init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg,
                                    device="cpu")
    before = [p.clone() for p in tree.leaves(params)]
    opt = AdamWConfig(lr=1e-3, weight_decay=0.01)
    new, _, metrics = step.make_train_step(step.make_loss_fn(spec, "train", cfg=cfg), opt)(
        params, init_state(params, opt), batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    for a, b in zip(tree.leaves(new), before):
        assert torch.isfinite(a).all()
        assert not torch.equal(a, b)


def test_chunked_attention_in_lm_loss_matches_reference():
    """lm_loss through 'xla_chunked' (16 x 32 chunks) on the REDUCED llama:
    the loss and gradients against the reference's, at the limits above."""
    rc, pc, rp, tp, rb, tb = both("llama3.2-3b", attn_impl="xla_chunked", q_chunk=16,
                                  kv_chunk=32)
    (want, _), wg = jax.value_and_grad(lambda p: ref_tf.lm_loss(p, rc, rb), has_aux=True)(rp)
    loss, _, grads = step.loss_and_grads(step.make_loss_fn(get_arch("llama3.2-3b"), "train",
                                                           pc), tp, tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5, atol=2e-5)
    for (key, g), (_, w) in zip(tree.leaves_with_paths(grads), _ref_leaves(wg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b"])
def test_per_layer_views_and_remat_change_no_gradient(arch):
    """The train step's per-layer views (their grads accumulated into one
    buffer a leaf) give the gradients of plain autograd on the stacked
    leaves, and remat (torch.utils.checkpoint) changes no bit."""
    _, pc, _, tp, _, tb = both(arch)
    views = step.loss_and_grads(step.make_loss_fn(get_arch(arch), "train", pc), tp, tb)[2]
    leaves = tree.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    for remat in (True, False):
        for leaf in tree.leaves(leaves):
            leaf.grad = None
        loss, _ = tf.lm_loss(leaves, dataclasses.replace(pc, remat=remat), tb)
        loss.backward()
        for a, b in zip(tree.leaves(views), tree.leaves(leaves)):
            assert torch.equal(a, b.grad)


def test_lm_loss_under_pallas_raises_like_the_reference():
    """K4 has no backward, in either package: a loss through
    attn_impl='pallas' cannot be differentiated."""
    rc, pc, rp, tp, rb, tb = both("llama3.2-3b", attn_impl="pallas")
    with pytest.raises(RuntimeError, match="flash_attention_trainable"):
        step.loss_and_grads(step.make_loss_fn(get_arch("llama3.2-3b"), "train", pc), tp, tb)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: ref_tf.lm_loss(p, rc, rb)[0])(rp)
    with torch.no_grad():  # the forward alone runs
        tf.lm_loss(tp, pc, tb)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b"])
def test_lm_prefill_and_decode_steps_match_reference(arch):
    rc, pc = configs(arch, remat=False)
    if pc.moe is not None:  # no drops: a B=1 decode group is the whole batch's
        rc = dataclasses.replace(rc, moe=dataclasses.replace(rc.moe, capacity_factor=8.0))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, capacity_factor=8.0))
    host = golden.lm_params(get_arch(arch).reduced_config)
    rp, tp = jax.tree.map(jnp.asarray, host), tf.params_from_reference(host, pc, "cpu")
    toks = np.random.default_rng(4).integers(0, pc.vocab, (2, 12), dtype=np.int32)
    want = ref_step.make_lm_prefill(rc)(rp, {"tokens": jnp.asarray(toks)})
    got = step.make_lm_prefill(pc)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=2e-5,
                               atol=2e-5)
    assert got["cur_len"] == int(want["cur_len"])
    # The cache of a 12-token prefill has no free slot for a dense decode;
    # decode into one built with room.
    _, cache, cur = tf.prefill(tp, pc, torch.from_numpy(toks), extra_slots=2)
    _, rcache, rcur = ref_tf.prefill(rp, rc, jnp.asarray(toks), extra_slots=2)
    nxt = np.asarray(jnp.argmax(want["logits"], -1)).astype(np.int32)[:, None]
    wd, _, wlen = ref_step.make_lm_decode(rc)(rp, rcache, {"tokens": jnp.asarray(nxt)}, rcur)
    gd, _, glen = step.make_lm_decode(pc)(tp, cache, {"tokens": torch.from_numpy(nxt)}, cur)
    assert glen == int(wlen)
    # The decode reads the bf16 cache: two f32 K/V values within 2e-5 may
    # round to neighbouring bf16 values, which moves a logit by ~2e-5 more.
    np.testing.assert_allclose(gd["logits"].numpy(), np.asarray(wd["logits"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(gd["next"].numpy(), np.asarray(wd["next"]))
    assert gd["next"].dtype == torch.int32


def test_other_families_raise_citing_the_roadmap():
    """Every family with a training step is ported (ROADMAP Queue 1 item
    12.2 brought the GNN and recsys families); the densest-subgraph
    workload has none, and the steps and batches refuse it naming its
    family, as the reference's raise ValueError(family)."""
    spec = get_arch("densest-mapreduce")
    for fn in (lambda: step.make_loss_fn(spec, "train"),
               lambda: step.init_model_params(spec, torch.Generator()),
               lambda: make_batch(spec, "train", reduced_shape={})):
        with pytest.raises(ValueError, match="densest"):
            fn()


def _cli(tmp_path, *extra):
    from repro_torch.launch import train

    return train.main(["--arch", "llama3.2-3b", "--device", "cpu", "--batch", "2", "--seq",
                       "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), *extra])


def test_train_cli_on_cpu_kill_and_resume_is_bitwise(tmp_path, capsys):
    """The CLI over the REDUCED llama on the CPU: 4 steps straight, and 2
    steps then --resume to 4, give equal final checkpoints, bitwise."""
    out = _cli(tmp_path / "a", "--steps", "4")
    assert out["status"] == "done" and out["step"] == 4
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and np.isfinite(line["final_loss"])
    _cli(tmp_path / "b", "--steps", "2")
    capsys.readouterr()
    _cli(tmp_path / "b", "--steps", "4", "--resume")
    assert "resumed from step 2" in capsys.readouterr().out
    with np.load(tmp_path / "a" / "step_4" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step_4" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_train_cli_with_grad_compression(tmp_path, kind):
    out = _cli(tmp_path, "--steps", "3", "--grad-compression", kind)
    assert out["status"] == "done" and np.isfinite(out["loss"])
