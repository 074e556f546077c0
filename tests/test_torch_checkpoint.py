"""The port's checkpoints, trainer and resumable pipelines
(``repro_torch.checkpoint``, ``repro_torch.train.trainer``,
``repro_torch.data``): mirrors of tests/test_substrates.py's checkpoint,
trainer, restart, watchdog and stream tests, plus what the port adds (bf16
leaves as uint16 bits, ``Quantized`` and ``AdamWState`` leaves, the async
snapshot, preemption by signal).  The streams' tokens are held bitwise
against the JAX package's.
"""

import dataclasses
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro.data.pipeline import lm_token_stream as ref_lm_token_stream
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    all_steps,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from repro_torch.data.pipeline import SyntheticStream, lm_token_stream
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train.trainer import StepTimeout, Trainer, TrainerConfig

# ------------------------------ checkpoint ----------------------------------


def _state(x=1.0):
    return {"w": torch.full((4, 3), x), "opt": {"m": torch.zeros(5), "step": torch.tensor(7)}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 10, _state(2.0), metadata={"foo": "bar"})
    restored, meta = restore_checkpoint(d, 10, _state())
    assert meta == {"foo": "bar"}
    assert torch.equal(restored["w"], torch.full((4, 3), 2.0))
    assert int(restored["opt"]["step"]) == 7 and restored["opt"]["step"].dtype == torch.int64
    with open(os.path.join(d, "step_10", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 10 and len(manifest["leaves"]) == 3


def test_checkpoint_keep_k_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _state(float(s)), keep=2)
    assert all_steps(d) == [4, 5]
    restored, meta, step = restore_latest(d, _state())
    assert step == 5
    assert torch.equal(restored["w"], torch.full((4, 3), 5.0))
    assert restore_latest(str(tmp_path / "none"), _state()) == (None, None, -1)


def test_checkpoint_async_then_join(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, keep=3)
    m.save_async(1, _state(1.5), metadata={"step": 1})
    m.join()
    assert m.latest_step() == 1


def test_async_save_snapshots_before_returning(tmp_path):
    """save_async copies the state to host memory before it returns: an
    in-place update right after it does not reach the checkpoint."""
    d = str(tmp_path / "ck")
    state = _state(1.0)
    m = CheckpointManager(d)
    m.save_async(3, state)
    state["w"].add_(100.0)
    m.join()
    restored, _ = restore_checkpoint(d, 3, _state())
    assert torch.equal(restored["w"], torch.full((4, 3), 1.0))


def test_checkpoint_atomicity_no_partial_dir(tmp_path):
    """tmp dirs never count as checkpoints."""
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "tmp.99.123"))
    assert all_steps(d) == []


def test_checkpoint_restores_onto_a_device(tmp_path):
    """Mirror of test_checkpoint_reshard_on_restore: the restore places
    every leaf on the device asked for, whatever the saving device was."""
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"w": torch.arange(8.0)})
    restored, _ = restore_checkpoint(d, 1, {"w": torch.zeros(8)}, device="cpu")
    assert restored["w"].device == torch.device("cpu")
    assert torch.equal(restored["w"], torch.arange(8.0))
    with pytest.raises(ValueError, match="expected"):
        restore_checkpoint(d, 1, {"w": torch.zeros(9)})
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(d, 1, {"v": torch.zeros(8)})


@pytest.mark.parametrize("moments", ["bf16", "int8"])
def test_optimizer_state_roundtrips_bitwise(tmp_path, moments):
    """bf16 leaves go through numpy as their uint16 bits; Quantized and
    AdamWState leaves keep their structure."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(33, 17, generator=g), "h": torch.randn(5, generator=g).bfloat16()}
    opt = init_state({"w": params["w"]}, AdamWConfig(moment_dtype=moments))
    state = (params, opt, None)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, state)
    with open(os.path.join(d, "step_2", "manifest.json")) as f:
        dtypes = {leaf["key"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    assert dtypes["[0]['h']"] == "bfloat16"
    like = (params, init_state({"w": params["w"]}, AdamWConfig(moment_dtype=moments)), None)
    restored, _ = restore_checkpoint(d, 2, like)
    assert restored[2] is None and type(restored[1]) is type(opt)
    assert restored[0]["h"].dtype == torch.bfloat16 and torch.equal(restored[0]["h"], params["h"])
    from repro_torch import tree

    for a, b in zip(tree.leaves(restored), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------- trainer ------------------------------------


def _toy_trainer(tmp_path, total=10, ckpt_every=3, **kw):
    def make(rng, step):
        return torch.from_numpy(rng.standard_normal(4).astype(np.float32))

    def step_fn(state, batch):
        return state + batch.sum(), {"loss": batch.sum() ** 2}

    cfg = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path / "ck"), ckpt_every=ckpt_every,
                        log_every=1, **kw)
    return Trainer(cfg, step_fn, torch.zeros(()), SyntheticStream(make, seed=1))


def test_trainer_runs_and_checkpoints(tmp_path):
    metrics = str(tmp_path / "m" / "metrics.jsonl")
    tr = _toy_trainer(tmp_path, metrics_path=metrics)
    out = tr.run()
    assert out["status"] == "done" and out["step"] == 10
    assert tr.ckpt.latest_step() == 10
    with open(metrics) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == list(range(10)) and "step_time_s" in lines[0]


def test_trainer_restart_is_bitwise_identical(tmp_path):
    """Mirror: 10 steps straight vs 6 steps, a restart and 4 more: the same
    final state (bitwise here) and the same batches."""
    ref = _toy_trainer(tmp_path / "a", total=10)
    ref.run()
    tr1 = _toy_trainer(tmp_path / "b", total=10, ckpt_every=3)
    tr1.cfg = dataclasses.replace(tr1.cfg, total_steps=6)
    tr1.run()  # saves at step 6 on completion
    tr2 = _toy_trainer(tmp_path / "b", total=10, ckpt_every=3)
    assert tr2.try_restore()
    assert tr2.step == 6  # steps 0..5 done; the next step to execute is 6
    assert tr2.run()["step"] == 10
    assert torch.equal(tr2.state, ref.state)


def test_trainer_watchdog(tmp_path):
    """Mirror: a step over its budget is checkpointed, then raises."""
    def slow_step(state, batch):
        time.sleep(0.2)
        return state, {"loss": torch.zeros(())}

    cfg = TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path / "ck"), ckpt_every=0,
                        step_timeout_s=0.05)
    tr = Trainer(cfg, slow_step, torch.zeros(()),
                 SyntheticStream(lambda rng, step: torch.zeros(1)))
    with pytest.raises(StepTimeout):
        tr.run()
    assert tr.ckpt.latest_step() == 1  # the NEXT step to run


def test_trainer_preemption_saves_and_returns(tmp_path):
    """SIGTERM during a step: the loop saves synchronously and returns
    'preempted' before the next step; a restart continues from there."""
    previous = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    tr = _toy_trainer(tmp_path, total=10, ckpt_every=0)
    real = tr.step_fn

    def step_fn(state, batch):
        if tr.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(state, batch)

    tr.step_fn = step_fn
    try:
        out = tr.run()
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    assert out["status"] == "preempted" and out["step"] == 4
    tr2 = _toy_trainer(tmp_path, total=10, ckpt_every=0)
    assert tr2.try_restore() and tr2.step == 4 and torch.equal(tr2.state, tr.state)


# ------------------------------- pipeline -----------------------------------


def test_stream_restart_reproduces_batches():
    """Mirror: a stream restored from another's cursor continues its batches."""
    s1 = lm_token_stream(vocab=100, batch=2, seq=8, seed=3, device="cpu")
    batches = [next(s1) for _ in range(5)]
    s2 = lm_token_stream(vocab=100, batch=2, seq=8, seed=3, device="cpu")
    for _ in range(3):
        next(s2)
    s3 = lm_token_stream(vocab=100, batch=2, seq=8, seed=999, device="cpu")
    s3.restore(s2.checkpoint_state())
    for i in (3, 4):
        assert torch.equal(next(s3)["tokens"], batches[i]["tokens"])


@pytest.mark.parametrize("vocab,batch,seq,seed", [(100, 2, 8, 3), (128256, 1, 64, 0)])
def test_token_stream_is_bitwise_the_reference(vocab, batch, seq, seed):
    ours = lm_token_stream(vocab, batch, seq, seed=seed, device="cpu")
    ref = ref_lm_token_stream(vocab, batch, seq, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(ref)
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_token_stream_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_token_stream(100, 1, 8)
