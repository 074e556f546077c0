"""Port parity of the GNN family: ``repro_torch.models.common``'s segment
ops and ``repro_torch.models.gnn`` (GraphSAGE, EGNN, MACE, EquiformerV2)
against ``repro.models``, on the REDUCED configs with the JAX package's
parameters carried across (``params_from_reference``) and numpy-drawn
batches (``make_batch`` of both packages, equal bit for bit).

Tolerances, float32 compute:
* outputs and losses: rtol = atol 1e-5 (f32 reassociation: the port's
  segment sums add in another order);
* gradients: the relative L2 error over the whole tree at most 1e-4, and
  each leaf's L2 error at most 1e-4 of its own norm plus 1e-6 of the
  tree's (a leaf whose gradient is 0 analytically, such as the last
  attention bias under the shift-invariant edge softmax, carries rounding
  noise of ~1e-10);
* ``segment_softmax``'s gradient: 1e-6, ties in the segment max included
  (JAX sends the max's gradient to the first maximum, ``scatter_reduce``
  splits it among ties; both cancel analytically and here numerically).
bfloat16 compute: outputs and losses within 1e-2 relative L2 of the
reference's bf16 run (the port accumulates bf16 messages in f32 and rounds
once; XLA rounds as it adds).
Each limit has a control that must exceed it: the same computation with
the edge mask ignored (every masked self-loop counted as an edge).
The mirrors of tests/test_gnn_models.py's properties keep its limits.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.synthetic import make_batch as ref_make_batch
from repro.models import common as ref_common
from repro.train import step as ref_step
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import gnn_molecule_batch, make_batch
from repro_torch.models import common
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import step

ARCHS = ["mace", "egnn", "graphsage-reddit", "equiformer-v2"]
MODULES = {"mace": "mace", "egnn": "egnn", "graphsage-reddit": "graphsage",
           "equiformer-v2": "equiformer_v2"}
SHAPES = {
    "full_train": dict(n_nodes=60, n_edges=240, d_feat=12, n_classes=5),
    "molecule_train": dict(batch=4, n_nodes=12, n_edges=24, d_feat=8, n_classes=0),
}
TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def port_module(arch):
    return importlib.import_module(f"repro_torch.models.gnn.{MODULES[arch]}")


def ref_module(arch):
    return importlib.import_module(f"repro.models.gnn.{MODULES[arch]}")


@functools.lru_cache(maxsize=None)
def case(arch, kind, dtype="float32"):
    """(ref cfg, port cfg, ref params, port params, ref batch, port batch)."""
    jd, td = DTYPES[dtype]
    shape = SHAPES[kind]
    rs, ps = ref_get_arch(arch), get_arch(arch)
    rc = dataclasses.replace(ref_step.specialize_gnn_config(rs.reduced_config, shape),
                             compute_dtype=jd)
    pc = dataclasses.replace(step.specialize_gnn_config(ps.reduced_config, shape),
                             compute_dtype=td)
    rp = ref_step.init_model_params(rs, jax.random.PRNGKey(0), cfg=rc)
    tp = port_module(arch).params_from_reference(jax.tree.map(np.asarray, rp), pc, "cpu")
    rb = ref_make_batch(rs, kind, reduced_shape=shape)
    tb = make_batch(ps, kind, reduced_shape=shape, device="cpu")
    return rc, pc, rp, tp, rb, tb


def unmasked(batch):
    """The control: every edge counted, the masked self-loops too."""
    return {**batch, "edge_mask": torch.ones_like(batch["edge_mask"])}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def assert_close(got, want, tol=TOL, control=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if control is not None:
        ctrl = np.asarray(control, np.float64)
        assert (np.abs(ctrl - want) > tol * (1 + np.abs(want))).any(), "control passes"


def ref_leaves(t):
    return [(jax.tree_util.keystr(k), np.asarray(a, np.float64))
            for k, a in jax.tree_util.tree_flatten_with_path(t)[0]]


def grad_errors(got_tree, want_tree):
    """(tree relative L2, the leaves past their own limit)."""
    got = [(k, v.double().numpy()) for k, v in tree.leaves_with_paths(got_tree)]
    want = ref_leaves(want_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    total = np.sqrt(sum(float(np.sum(w ** 2)) for _, w in want))
    err = np.sqrt(sum(float(np.sum((g - w) ** 2)) for (_, g), (_, w) in zip(got, want)))
    bad = [k for (k, g), (_, w) in zip(got, want)
           if np.linalg.norm(g - w) > GRAD_TOL * np.linalg.norm(w) + 1e-6 * total]
    return err / total, bad


def forward_out(arch, params, cfg, batch, port=True):
    if not port:
        return _ref_forward(arch, cfg)(params, batch)
    m = port_module(arch)
    if arch == "graphsage-reddit":
        return m.forward_full(params, cfg, batch)
    if arch == "egnn":
        return m.forward(params, cfg, batch)[0]
    if arch == "equiformer-v2":
        return m.forward(params, cfg, batch)[:, 0, :]
    return m.forward(params, cfg, batch)


@functools.lru_cache(maxsize=None)
def _ref_forward(arch, cfg):
    m = ref_module(arch)
    if arch == "graphsage-reddit":
        fn = functools.partial(m.forward_full, cfg=cfg)
    elif arch == "egnn":
        fn = lambda params, batch: m.forward(params, cfg, batch)[0]  # noqa: E731
    elif arch == "equiformer-v2":
        fn = lambda params, batch: m.forward(params, cfg, batch)[:, 0, :]  # noqa: E731
    else:
        fn = functools.partial(m.forward, cfg=cfg)
    return jax.jit(lambda params, batch: fn(params, batch=batch))


def host(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# -- segment ops --------------------------------------------------------------


def _segments(seed=0, e=200, n=12, width=None, ties=False):
    rng = np.random.default_rng(seed)
    shape = (e,) if width is None else (e, width)
    x = rng.standard_normal(shape).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2  # many equal maxima per segment
    seg = rng.integers(0, n, e).astype(np.int32)
    seg[seg == n - 1] = 0  # segment n-1 stays empty
    return x, seg, n


@pytest.mark.parametrize("width", [None, 5])
def test_segment_sum_and_mean_match_reference(width):
    x, seg, n = _segments(width=width)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg), num_segments=n)
    got = common.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), n)
    assert_close(got.numpy(), want)
    want = ref_common.segment_mean(jnp.asarray(x), jnp.asarray(seg), n)
    got = common.segment_mean(torch.from_numpy(x), torch.from_numpy(seg), n)
    ctrl = common.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), n)
    assert_close(got.numpy(), want, control=ctrl.numpy())


def test_segment_sum_accumulates_bf16_in_f32():
    """bf16 rows are summed in f32 and rounded once: 4,096 ones in one
    segment give 4,096 (a bf16 running sum stalls at 256)."""
    ones = torch.ones(4096, dtype=torch.bfloat16)
    got = common.segment_sum(ones, torch.zeros(4096, dtype=torch.int32), 2)
    assert got.dtype == torch.bfloat16 and got.tolist() == [4096.0, 0.0]
    stalled = torch.zeros(1, dtype=torch.bfloat16)
    for _ in range(300):
        stalled += 1
    assert stalled.item() == 256.0  # what a bf16 accumulator gives


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_segment_sum_equals_the_unchunked_ops(dtype, monkeypatch):
    """The chunked gather-scale-sum (three chunks here) gives the sums and
    the data gradient of ``segment_sum(gather(x, src) * w, dst)``, which
    round each message the same way: equal bit for bit on the CPU, where
    ``index_add_`` adds in a fixed order."""
    monkeypatch.setattr(common, "SEGMENT_CHUNK", 70)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((30, 6)).astype(np.float32)).to(dtype)
    src = torch.from_numpy(rng.integers(0, 30, 200).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 25, 200).astype(np.int32))
    w = torch.from_numpy((rng.random(200) < 0.8).astype(np.float32)).to(dtype)
    probe = torch.from_numpy(rng.standard_normal((25, 6)).astype(np.float32)).to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = common.gather_segment_sum(a, src, dst, w, 25)
    want = common.segment_sum(common.gather(b, src) * w[:, None], dst, 25)
    (got * probe).sum().backward()
    (want * probe).sum().backward()
    assert got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(a.grad, b.grad)
    ctrl = common.gather_segment_sum(x, src, dst, torch.ones_like(w), 25)
    assert not torch.equal(ctrl, want.detach())
    with pytest.raises(ValueError, match="constants"):
        common.gather_segment_sum(x, src, dst, w.clone().requires_grad_(), 25)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("width", [None, 4])
def test_segment_softmax_and_grad_match_reference(width, ties):
    x, seg, n = _segments(seed=1, width=width, ties=ties)
    probe = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    if width is None:
        ref_fn = functools.partial(ref_common.segment_softmax, segment_ids=jnp.asarray(seg),
                                   num_segments=n)
    else:  # the reference's per-head vmap (equiformer_v2.py)
        def ref_fn(s):
            return jax.vmap(lambda c: ref_common.segment_softmax(c, jnp.asarray(seg), n),
                            in_axes=1, out_axes=1)(s)
    want, vjp = jax.vjp(ref_fn, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(probe))
    xt = torch.from_numpy(x).requires_grad_()
    got = common.segment_softmax(xt, torch.from_numpy(seg), n)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(probe))
    assert_close(got.detach().numpy(), want)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    # The control: a softmax that ignores the segments.
    ctrl = torch.softmax(torch.from_numpy(x), dim=0)
    assert (np.abs(ctrl.numpy() - np.asarray(want)) > TOL).any()


def test_segment_softmax_normalizes():
    """Mirror of tests/test_gnn_models.py::test_segment_softmax_normalizes."""
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 10, 100).astype(np.int32))
    p = common.segment_softmax(scores, seg, 10)
    sums = common.segment_sum(p, seg, 10)
    np.testing.assert_allclose(sums.numpy(), np.ones(10), rtol=1e-5)


def test_mlp_and_l2_loss_match_reference():
    rng = np.random.default_rng(3)
    rp = ref_common.mlp_init(jax.random.PRNGKey(0), [6, 5, 3])
    tp = common.tree_from_reference(jax.tree.map(np.asarray, rp),
                                    common.mlp_init(torch.Generator(), [6, 5, 3],
                                                    device="meta"), "cpu")
    x = rng.standard_normal((7, 6)).astype(np.float32)
    for final in (False, True):
        want = ref_common.mlp(rp, jnp.asarray(x), final_act=final)
        got = common.mlp(tp, torch.from_numpy(x), final_act=final)
        assert_close(got.numpy(), want)
    y = rng.standard_normal(7).astype(np.float32)
    (wl, wm), (gl, gm) = ref_common.l2_loss(jnp.asarray(x[:, 0]), jnp.asarray(y)), \
        common.l2_loss(torch.from_numpy(x[:, 0]), torch.from_numpy(y))
    assert_close(float(gl), float(wl))
    assert_close(float(gm["rmse"]), float(wm["rmse"]))
    assert common.count_params(tp) == ref_common.count_params(rp) == 6 * 5 + 5 + 5 * 3 + 3


# -- the models ---------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_reference_bitwise(arch, kind):
    _, _, _, _, rb, tb = case(arch, kind)
    assert sorted(rb) == sorted(tb)
    for k in rb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]), err_msg=k)


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, kind):
    rc, pc, rp, tp, rb, tb = case(arch, kind)
    want = forward_out(arch, rp, rc, rb, port=False)
    got = forward_out(arch, tp, pc, tb)
    ctrl = forward_out(arch, tp, pc, unmasked(tb))
    assert_close(host(got), want, control=host(ctrl))
    if arch == "egnn":  # the coordinates too
        _, x_want = ref_module(arch).forward(rp, rc, rb)
        _, x_got = port_module(arch).forward(tp, pc, tb)
        assert x_got.dtype == torch.float32
        assert_close(x_got.numpy(), x_want)


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, kind):
    rc, pc, rp, tp, rb, tb = case(arch, kind)
    ref_loss = ref_step.make_loss_fn(ref_get_arch(arch), kind, cfg=rc)
    (want, wm), wg = jax.jit(jax.value_and_grad(lambda p: ref_loss(p, batch=rb),
                                                has_aux=True))(rp)
    loss_fn = step.make_loss_fn(get_arch(arch), kind, cfg=pc)
    loss, metrics, grads = step.loss_and_grads(loss_fn, tp, tb)
    c_loss, _, c_grads = step.loss_and_grads(loss_fn, tp, unmasked(tb))
    assert sorted(metrics) == sorted(wm)
    assert_close(float(loss), float(want), control=float(c_loss))
    for k in wm:
        assert_close(float(metrics[k]), float(wm[k]))
    err, bad = grad_errors(grads, wg)
    assert err <= GRAD_TOL and not bad, (err, bad)
    assert grad_errors(c_grads, wg)[0] > GRAD_TOL  # the control fails


def test_sage_sampled_loss_and_grads_match_reference():
    rc, pc, rp, tp, _, _ = case("graphsage-reddit", "full_train")
    rng = np.random.default_rng(0)
    r, f1, f2, n = 8, 5, 3, 60
    arrays = {
        "feat_table": rng.standard_normal((n, 12), dtype=np.float32),
        "hop0": rng.integers(0, n, r, dtype=np.int32),
        "hop1": rng.integers(0, n, (r, f1), dtype=np.int32),
        "hop2": rng.integers(0, n, (r, f1, f2), dtype=np.int32),
        "hop1_mask": (rng.random((r, f1)) < 0.8).astype(np.float32),
        "hop2_mask": (rng.random((r, f1, f2)) < 0.8).astype(np.float32),
        "labels": rng.integers(0, 5, r, dtype=np.int32),
    }
    rb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    spec = ref_get_arch("graphsage-reddit")
    (want, _), wg = jax.jit(jax.value_and_grad(
        lambda p: ref_step.make_loss_fn(spec, "sampled_train", cfg=rc)(p, batch=rb),
        has_aux=True))(rp)
    loss_fn = step.make_loss_fn(get_arch("graphsage-reddit"), "sampled_train", cfg=pc)
    loss, _, grads = step.loss_and_grads(loss_fn, tp, tb)
    ctrl = {**tb, "hop2_mask": torch.ones_like(tb["hop2_mask"])}
    c_loss = step.loss_and_grads(loss_fn, tp, ctrl)[0]
    assert_close(float(loss), float(want), control=float(c_loss))
    err, bad = grad_errors(grads, wg)
    assert err <= GRAD_TOL and not bad, (err, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_loss_near_reference(arch):
    kind = "molecule_train"
    rc, pc, rp, tp, rb, tb = case(arch, kind, "bfloat16")
    want = host(forward_out(arch, rp, rc, rb, port=False))
    got = host(forward_out(arch, tp, pc, tb))
    ctrl = host(forward_out(arch, tp, pc, unmasked(tb)))
    assert rel_l2(got, want) <= BF16_TOL < rel_l2(ctrl, want)
    ref_loss = ref_step.make_loss_fn(ref_get_arch(arch), kind, cfg=rc)
    want_l = float(jax.jit(lambda p: ref_loss(p, batch=rb)[0])(rp))
    with torch.no_grad():
        got_l = float(step.make_loss_fn(get_arch(arch), kind, cfg=pc)(tp, batch=tb)[0])
    assert abs(got_l - want_l) <= BF16_TOL * (1 + abs(want_l))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_checks_shapes(arch):
    rc, pc, rp, _, _, _ = case(arch, "full_train")
    host_tree = jax.tree.map(np.asarray, rp)
    bad = dataclasses.replace(pc, d_hidden=pc.d_hidden * 2)
    with pytest.raises(ValueError, match="shape"):
        port_module(arch).params_from_reference(host_tree, bad, "cpu")
    mine = step.init_model_params(get_arch(arch), torch.Generator().manual_seed(0), cfg=pc,
                                  device="cpu")
    assert [(k, tuple(v.shape)) for k, v in tree.leaves_with_paths(mine)] == \
        [(k, a.shape) for k, a in ref_leaves(rp)]


def test_views_of_unstacked_params():
    """The GNN trees have no ``layers`` key: every leaf is one view whose
    ``.grad`` is its preset buffer, the tree of whole leaves comes back."""
    _, pc, _, tp, _, tb = case("egnn", "molecule_train")
    grads = tree.tree_map(torch.zeros_like, tp)
    views = step._views(tp, grads)
    for (k, v), (_, g), (_, p) in zip(tree.leaves_with_paths(views),
                                      tree.leaves_with_paths(grads),
                                      tree.leaves_with_paths(tp)):
        assert isinstance(v, torch.Tensor) and v.requires_grad and v.grad is g, k
        assert v.data_ptr() == p.data_ptr() and v.shape == p.shape, k
    _, _, out = step.loss_and_grads(step.make_loss_fn(get_arch("egnn"), "molecule_train", pc),
                                    tp, tb)
    assert [(k, v.shape) for k, v in tree.leaves_with_paths(out)] == \
        [(k, v.shape) for k, v in tree.leaves_with_paths(tp)]
    assert sum(bool(g.abs().sum() > 0) for g in tree.leaves(out)) > len(tree.leaves(out)) // 2


# -- mirrors of tests/test_arch_smoke.py (one train step moves, stays finite) --

OPT = AdamWConfig(lr=1e-3, weight_decay=0.01)


def _train_step_moves(spec, kind, cfg, batch):
    params = step.init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg,
                                    device="cpu")
    before = [p.clone() for p in tree.leaves(params)]
    new, _, metrics = step.make_train_step(step.make_loss_fn(spec, kind, cfg=cfg), OPT)(
        params, init_state(params, OPT), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(torch.isfinite(p).all() for p in tree.leaves(new))
    assert any(not torch.equal(a, b) for a, b in zip(tree.leaves(new), before))


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_train_step(arch, kind):
    spec = get_arch(arch)
    shape = SHAPES[kind]
    cfg = step.specialize_gnn_config(spec.reduced_config, shape)
    _train_step_moves(spec, kind, cfg, make_batch(spec, kind, reduced_shape=shape,
                                                  device="cpu"))


def test_sage_sampled_train_step():
    spec = get_arch("graphsage-reddit")
    shape = dict(n_nodes=500, d_feat=16, batch_nodes=8, fanout=(5, 3), n_classes=4)
    cfg = step.specialize_gnn_config(spec.reduced_config, shape)
    rng = np.random.default_rng(0)
    r, f1, f2 = 8, 5, 3
    batch = {
        "feat_table": torch.from_numpy(rng.standard_normal((500, 16), dtype=np.float32)),
        "hop0": torch.from_numpy(rng.integers(0, 500, r, dtype=np.int32)),
        "hop1": torch.from_numpy(rng.integers(0, 500, (r, f1), dtype=np.int32)),
        "hop2": torch.from_numpy(rng.integers(0, 500, (r, f1, f2), dtype=np.int32)),
        "hop1_mask": torch.ones((r, f1)),
        "hop2_mask": torch.ones((r, f1, f2)),
        "labels": torch.from_numpy(rng.integers(0, 4, r, dtype=np.int32)),
    }
    _train_step_moves(spec, "sampled_train", cfg, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_gnn_arch_on_cpu(arch, tmp_path, capsys):
    import json

    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--ckpt-every", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert out["status"] == "done" and out["step"] == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and np.isfinite(line["final_loss"])


# -- mirrors of tests/test_gnn_models.py's properties ---------------------------


def _rotation_matrix(rng):
    a = rng.standard_normal((3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return torch.from_numpy(q.astype(np.float32))


def _f32_cfg(arch, shape):
    spec = get_arch(arch)
    return spec, dataclasses.replace(step.specialize_gnn_config(spec.reduced_config, shape),
                                     compute_dtype=torch.float32)


def _mol_batch(seed=0, batch=3, nodes=10, edges=30, d_feat=8):
    rng = np.random.default_rng(seed)
    return gnn_molecule_batch(rng, batch, nodes, edges, d_feat, True, device="cpu"), rng


@pytest.mark.parametrize("arch", ["mace", "egnn"])
def test_energy_rotation_invariance(arch):
    spec, cfg = _f32_cfg(arch, {"d_feat": 8, "n_classes": 0})
    m = port_module(arch)
    params = step.init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg,
                                    device="cpu")
    batch, rng = _mol_batch()
    with torch.no_grad():
        loss1, _ = m.loss_energy(params, cfg, batch)
        R = _rotation_matrix(rng)
        t = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
        loss2, _ = m.loss_energy(params, cfg, {**batch, "positions": batch["positions"] @ R.T + t})
    assert float((loss1 - loss2).abs()) < 1e-4


def test_egnn_coordinates_are_equivariant():
    spec, cfg = _f32_cfg("egnn", {"d_feat": 8, "n_classes": 0})
    m = port_module("egnn")
    params = step.init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg,
                                    device="cpu")
    batch, rng = _mol_batch(seed=3)
    with torch.no_grad():
        _, x1 = m.forward(params, cfg, batch)
        R = _rotation_matrix(rng)
        _, x2 = m.forward(params, cfg, {**batch, "positions": batch["positions"] @ R.T})
    np.testing.assert_allclose((x1 @ R.T).numpy(), x2.numpy(), rtol=1e-4, atol=1e-4)


def test_spherical_harmonics_orthonormal():
    from repro.models.gnn.mace import spherical_harmonics_l2 as ref_sh
    from repro_torch.models.gnn.mace import spherical_harmonics_l2

    rng = np.random.default_rng(0)
    v = rng.standard_normal((200_000, 3))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    Y = spherical_harmonics_l2(torch.from_numpy(v)).double().numpy()
    gram = 4 * np.pi * (Y.T @ Y) / v.shape[0]
    np.testing.assert_allclose(gram, np.eye(9), atol=0.05)
    np.testing.assert_allclose(Y[:1000], np.asarray(ref_sh(jnp.asarray(v[:1000]))), rtol=1e-6,
                               atol=1e-7)


def test_mace_invariants_rotation_stable():
    from repro_torch.models.gnn.mace import _invariants, spherical_harmonics_l2

    rng = np.random.default_rng(1)
    v = rng.standard_normal((50, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    R = _rotation_matrix(rng)
    h = torch.from_numpy(rng.standard_normal((50, 4)).astype(np.float32))
    vt = torch.from_numpy(v)
    A1 = (spherical_harmonics_l2(vt)[:, :, None] * h[:, None, :]).sum(0)[None]
    A2 = (spherical_harmonics_l2(vt @ R.T)[:, :, None] * h[:, None, :]).sum(0)[None]
    np.testing.assert_allclose(_invariants(A1).numpy(), _invariants(A2).numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_node_permutation_equivariance(arch):
    spec, cfg = _f32_cfg(arch, {"d_feat": 8, "n_classes": 3})
    params = step.init_model_params(spec, torch.Generator().manual_seed(0), cfg=cfg,
                                    device="cpu")
    rng = np.random.default_rng(5)
    n, e = 20, 60
    batch = {
        "features": torch.from_numpy(rng.standard_normal((n, 8), dtype=np.float32)),
        "src": torch.from_numpy(rng.integers(0, n, e, dtype=np.int32)),
        "dst": torch.from_numpy(rng.integers(0, n, e, dtype=np.int32)),
        "edge_mask": torch.ones((e,), dtype=torch.bool),
        "positions": torch.from_numpy(rng.standard_normal((n, 3), dtype=np.float32)),
    }
    perm = rng.permutation(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    inv_t = torch.from_numpy(inv)
    batch_p = {
        "features": batch["features"][perm],
        "src": inv_t[batch["src"].long()],
        "dst": inv_t[batch["dst"].long()],
        "edge_mask": batch["edge_mask"],
        "positions": batch["positions"][perm],
    }
    with torch.no_grad():
        out1 = forward_out(arch, params, cfg, batch)
        out2 = forward_out(arch, params, cfg, batch_p)
    np.testing.assert_allclose(out1.numpy()[perm], out2.numpy(), rtol=2e-3, atol=2e-3)


def test_egnn_self_loop_gradient_finite_where_reference_is_nan():
    """At 4 layers (the published depth) the coordinates of layer 2 on
    depend on the parameters, and the reference's ``jnp.sqrt(d2)`` at a
    masked self-loop (d2 = 0) turns the earlier leaves' gradients into NaN.
    The port's loss is the reference's; its gradients are finite and equal
    the reference's on every leaf the reference keeps finite."""
    shape = SHAPES["molecule_train"]
    rs, ps = ref_get_arch("egnn"), get_arch("egnn")
    rc = dataclasses.replace(ref_step.specialize_gnn_config(rs.reduced_config, shape),
                             n_layers=4, compute_dtype=jnp.float32)
    pc = dataclasses.replace(step.specialize_gnn_config(ps.reduced_config, shape),
                             n_layers=4, compute_dtype=torch.float32)
    rp = ref_step.init_model_params(rs, jax.random.PRNGKey(0), cfg=rc)
    tp = port_module("egnn").params_from_reference(jax.tree.map(np.asarray, rp), pc, "cpu")
    rb = ref_make_batch(rs, "molecule_train", reduced_shape=shape)
    tb = make_batch(ps, "molecule_train", reduced_shape=shape, device="cpu")
    assert not tb["edge_mask"].all()  # the batch has masked self-loops
    ref_loss = ref_step.make_loss_fn(rs, "molecule_train", cfg=rc)
    want, wg = jax.jit(jax.value_and_grad(lambda p: ref_loss(p, batch=rb)[0]))(rp)
    loss, _, grads = step.loss_and_grads(step.make_loss_fn(ps, "molecule_train", pc), tp, tb)
    assert_close(float(loss), float(want))
    got = dict((k, v.double().numpy()) for k, v in tree.leaves_with_paths(grads))
    nan = [k for k, w in ref_leaves(wg) if not np.isfinite(w).all()]
    assert nan and all(np.isfinite(g).all() for g in got.values())
    finite = [(k, w) for k, w in ref_leaves(wg) if k not in nan]
    total = np.sqrt(sum(float(np.sum(w ** 2)) for _, w in finite))
    for k, w in finite:  # the limits of grad_errors, over the finite leaves
        assert np.linalg.norm(got[k] - w) <= GRAD_TOL * np.linalg.norm(w) + 1e-6 * total, k
