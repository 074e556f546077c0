"""Port parity of the recsys family: ``repro_torch.models.recsys`` (the
embedding bags, the towers, the in-batch softmax loss, serving and
retrieval) and its steps against ``repro.models.recsys``, on the REDUCED
two-tower config with the JAX package's parameters carried across and the
batches of both packages' ``make_batch`` (equal bit for bit).

Tolerances, float32 compute: outputs, losses and scores rtol = atol 1e-5;
gradients as tests/test_torch_gnn.py (tree relative L2 1e-4); top-k
scores 1e-5, the indices equal wherever the scores are distinct (a tie can
be ordered either way).  bfloat16: scores and the loss within 1e-2.  Each
limit has a control that must exceed it (the history mask ignored, or the
logQ correction dropped).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.pipeline import recsys_stream as ref_recsys_stream
from repro.data.synthetic import make_batch as ref_make_batch
from repro.models import recsys as ref_recsys
from repro.train import step as ref_step
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import recsys_stream
from repro_torch.data.synthetic import make_batch
from repro_torch.models import recsys
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import step

ARCH = "two-tower-retrieval"
TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2


@functools.lru_cache(maxsize=None)
def case(dtype="float32", batch=32):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rc = dataclasses.replace(ref_get_arch(ARCH).reduced_config, compute_dtype=jd)
    pc = dataclasses.replace(get_arch(ARCH).reduced_config, compute_dtype=td)
    rp = ref_step.init_model_params(ref_get_arch(ARCH), jax.random.PRNGKey(0), cfg=rc)
    tp = recsys.params_from_reference(jax.tree.map(np.asarray, rp), pc, "cpu")
    rb = ref_make_batch(ref_get_arch(ARCH), "train", reduced_shape=dict(batch=batch))
    tb = make_batch(get_arch(ARCH), "train", reduced_shape=dict(batch=batch), device="cpu")
    return rc, pc, rp, tp, rb, tb


def unmasked(batch):
    return {**batch, "hist_mask": torch.ones_like(batch["hist_mask"])}


def assert_close(got, want, tol=TOL, control=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if control is not None:
        ctrl = np.asarray(control, np.float64)
        assert (np.abs(ctrl - want) > tol * (1 + np.abs(want))).any(), "control passes"


def test_batches_and_stream_equal_reference_bitwise():
    _, _, _, _, rb, tb = case()
    assert sorted(rb) == sorted(tb)
    for k in rb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]), err_msg=k)
    cfg = get_arch(ARCH).reduced_config
    a, b = recsys_stream(cfg, 16, seed=3, device="cpu"), ref_recsys_stream(
        ref_get_arch(ARCH).reduced_config, 16, seed=3)
    for _ in range(2):
        got, want = next(a), next(b)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert a.checkpoint_state() == b.checkpoint_state() == {"seed": 3, "step": 2}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches_reference(mode, weighted):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    flat = rng.integers(0, 50, 40).astype(np.int32)
    bags = np.sort(rng.integers(0, 6, 40)).astype(np.int32)
    bags[bags == 5] = 4  # bag 5 stays empty
    w = rng.random(40).astype(np.float32) if weighted else None
    want = ref_recsys.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                           jnp.asarray(bags), 6, mode,
                                           None if w is None else jnp.asarray(w))
    got = recsys.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                      torch.from_numpy(bags), 6, mode,
                                      None if w is None else torch.from_numpy(w))
    want = np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)  # max: -inf when empty
    ctrl = recsys.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                       torch.from_numpy(np.roll(bags, 1)), 6, mode)
    assert_close(got.numpy()[fin], want[fin], control=ctrl.numpy()[fin])


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_padded_matches_reference_and_ragged(mode):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = np.asarray([[1, 2, 3], [10, 11, 0], [20, 0, 0]], np.int32)
    mask = np.asarray([[1, 1, 1], [1, 1, 0], [1, 0, 0]], np.float32)
    want = ref_recsys.embedding_bag_padded(jnp.asarray(table), jnp.asarray(ids),
                                           jnp.asarray(mask), mode)
    got = recsys.embedding_bag_padded(torch.from_numpy(table), torch.from_numpy(ids),
                                      torch.from_numpy(mask), mode)
    ctrl = recsys.embedding_bag_padded(torch.from_numpy(table), torch.from_numpy(ids),
                                       torch.ones(3, 3), mode)
    assert_close(got.numpy(), want, control=ctrl.numpy())
    ragged = recsys.embedding_bag_ragged(
        torch.from_numpy(table), torch.tensor([1, 2, 3, 10, 11, 20]),
        torch.tensor([0, 0, 0, 1, 1, 2]), 3, mode)
    np.testing.assert_allclose(got.numpy(), ragged.numpy(), rtol=1e-6)


def _ref_leaves(t):
    return [(jax.tree_util.keystr(k), np.asarray(a, np.float64))
            for k, a in jax.tree_util.tree_flatten_with_path(t)[0]]


def _grad_rel(got, want):
    g = [v.double().numpy() for v in tree.leaves(got)]
    w = [a for _, a in _ref_leaves(want)]
    return np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(g, w))
                   / sum(np.sum(b ** 2) for b in w))


def test_loss_and_grads_match_reference():
    rc, pc, rp, tp, rb, tb = case()
    ref_loss = ref_step.make_loss_fn(ref_get_arch(ARCH), "train", cfg=rc)
    (want, wm), wg = jax.jit(jax.value_and_grad(lambda p: ref_loss(p, batch=rb),
                                                has_aux=True))(rp)
    loss_fn = step.make_loss_fn(get_arch(ARCH), "train", cfg=pc)
    loss, metrics, grads = step.loss_and_grads(loss_fn, tp, tb)
    c_loss, _, c_grads = step.loss_and_grads(loss_fn, tp, unmasked(tb))
    assert sorted(metrics) == sorted(wm)
    assert_close(float(loss), float(want), control=float(c_loss))
    for k in wm:
        assert_close(float(metrics[k]), float(wm[k]))
    assert [k for k, _ in tree.leaves_with_paths(grads)] == [k for k, _ in _ref_leaves(wg)]
    assert all(g.layout == torch.strided for g in tree.leaves(grads))  # dense
    assert _grad_rel(grads, wg) <= GRAD_TOL < _grad_rel(c_grads, wg)


def test_table_gradient_adds_into_the_preset_buffer():
    """A table's gradient lands in its preset dense buffer in place (the
    gathers hand autograd only their rows): the buffer loss_and_grads
    allocated is the one returned, and it equals the dense index_add_ of
    the rows' gradients."""
    _, pc, _, tp, _, tb = case()
    loss_fn = step.make_loss_fn(get_arch(ARCH), "train", cfg=pc)
    seen = {}
    real = torch.zeros_like

    def spy(x, *a, **k):
        out = real(x, *a, **k)
        seen.setdefault(tuple(x.shape), out)
        return out

    torch.zeros_like = spy
    try:
        _, _, grads = step.loss_and_grads(loss_fn, tp, tb)
    finally:
        torch.zeros_like = real
    table = grads["item_table"]
    assert table is seen[tuple(tp["item_table"].shape)]
    # Rows never gathered keep a zero gradient; the gathered ones do not.
    used = np.unique(np.concatenate([tb["hist"].numpy().ravel(), tb["item_id"].numpy()]))
    rows = table.abs().sum(1).numpy() > 0
    assert not rows[np.setdiff1d(np.arange(len(rows)), used)].any()
    assert rows[used].mean() > 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_scores_match_reference(dtype):
    rc, pc, rp, tp, rb, tb = case(dtype)
    want = np.asarray(jax.jit(ref_step.make_recsys_serve(rc))(rp, rb), np.float64)
    got = step.make_recsys_serve(pc)(tp, tb)
    ctrl = step.make_recsys_serve(pc)(tp, unmasked(tb)).float().numpy()
    assert got.shape == (32,) and got.dtype == torch.float32
    if dtype == "float32":
        assert_close(got.numpy(), want, control=ctrl)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= BF16_TOL < np.abs(ctrl - want).max() / np.abs(want).max()


def test_retrieval_topk_matches_reference():
    rc, pc, rp, tp, _, _ = case()
    rng = np.random.default_rng(0)
    arrays = {
        "user_id": np.asarray([3], np.int32),
        "hist": rng.integers(0, rc.n_items, (1, rc.hist_len), dtype=np.int32),
        "hist_mask": np.ones((1, rc.hist_len), np.float32),
        "cand_ids": rng.integers(0, rc.n_items, 512, dtype=np.int32),  # repeats: ties
    }
    want = jax.jit(ref_step.make_recsys_retrieval(rc, k=10))(
        rp, {k: jnp.asarray(v) for k, v in arrays.items()})
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    got = step.make_recsys_retrieval(pc, k=10)(tp, tb)
    ws, wi = np.asarray(want["scores"]), np.asarray(want["indices"])
    gs, gi = got["scores"].numpy(), got["indices"].numpy()
    assert gi.shape == (10,) and (np.diff(gs) <= 1e-6).all()
    assert_close(gs, ws)
    cand = arrays["cand_ids"]
    np.testing.assert_array_equal(cand[gi], cand[wi])  # the same items
    distinct = np.ones(10, bool)
    distinct[1:] &= np.abs(np.diff(ws)) > 1e-5
    distinct[:-1] &= np.abs(np.diff(ws)) > 1e-5
    np.testing.assert_array_equal(gi[distinct], wi[distinct])
    ctrl = step.make_recsys_retrieval(pc, k=10)(tp, {**tb, "hist_mask": torch.zeros(1, 8)})
    assert (np.abs(ctrl["scores"].numpy() - ws) > TOL).any()


def test_recsys_train_step():
    """Mirror of tests/test_arch_smoke.py::test_recsys_train_step."""
    spec = get_arch(ARCH)
    batch = make_batch(spec, "train", reduced_shape=dict(batch=32), device="cpu")
    params = step.init_model_params(spec, torch.Generator().manual_seed(0),
                                    cfg=spec.reduced_config, device="cpu")
    before = [p.clone() for p in tree.leaves(params)]
    opt = AdamWConfig(lr=1e-3, weight_decay=0.01)
    new, state, metrics = step.make_train_step(step.make_loss_fn(spec, "train"), opt)(
        params, init_state(params, opt), batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    assert new is params and int(state.step) == 1
    assert all(torch.isfinite(p).all() for p in tree.leaves(new))
    assert all(not torch.equal(a, b) for a, b in zip(tree.leaves(new), before))


def test_recsys_serve_and_retrieval_shapes():
    """Mirror of tests/test_arch_smoke.py::test_recsys_serve_and_retrieval."""
    spec = get_arch(ARCH)
    cfg = spec.reduced_config
    params = step.init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg,
                                    device="cpu")
    batch = make_batch(spec, "train", reduced_shape=dict(batch=16), device="cpu")
    scores = step.make_recsys_serve(cfg)(params, batch)
    assert scores.shape == (16,) and torch.isfinite(scores).all()
    rng = np.random.default_rng(0)
    rbatch = {
        "user_id": torch.tensor([3], dtype=torch.int32),
        "hist": torch.from_numpy(rng.integers(0, cfg.n_items, (1, cfg.hist_len),
                                              dtype=np.int32)),
        "hist_mask": torch.ones((1, cfg.hist_len)),
        "cand_ids": torch.from_numpy(rng.integers(0, cfg.n_items, 512, dtype=np.int32)),
    }
    out = step.make_recsys_retrieval(cfg, k=10)(params, rbatch)
    assert out["indices"].shape == (10,)
    assert (np.diff(out["scores"].numpy()) <= 1e-6).all()


def test_train_cli_runs_two_tower_on_cpu(tmp_path, capsys):
    import json

    from repro_torch.launch import train

    out = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "16",
                      "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert out["status"] == "done" and out["step"] == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and np.isfinite(line["final_loss"])
