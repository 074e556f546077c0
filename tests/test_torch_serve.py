"""Port parity of the serving engine: ``repro_torch.serve.engine.ServeEngine``
against ``repro.serve.engine.ServeEngine`` on the REDUCED llama3.2-3b, with
the JAX package's parameters carried across.

The engine decodes its slots as one batch, each row at its own length; the
reference vmaps a B=1 decode over the slots.  The batched decode must give
what a standalone per-slot decode gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine


def _setup(**kw):
    rc = dataclasses.replace(ref_get_arch("llama3.2-3b").reduced_config, remat=False, **kw)
    pc = dataclasses.replace(get_arch("llama3.2-3b").reduced_config, remat=False, **kw)
    ref_p = ref_tf.init_params(jax.random.PRNGKey(0), rc)
    p = tf.params_from_reference(jax.tree.map(np.asarray, ref_p), pc, device="cpu")
    return rc, pc, ref_p, p


def _prompts(vocab, lens=(5, 9, 7)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


def test_serve_engine_matches_full_forward_and_reference():
    """Mirror of tests/test_substrates.py::test_serve_engine_matches_full_forward:
    greedy continuous-batched decode == the argmax chain of full forwards,
    and == the JAX engine's tokens."""
    rc, pc, ref_p, p = _setup()
    prompts = _prompts(pc.vocab)
    eng = ServeEngine(p, pc, n_slots=2, max_len=64, device="cpu")
    ref_eng = RefEngine(ref_p, rc, n_slots=2, max_len=64)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new=4))
        ref_eng.submit(RefRequest(rid=i, prompt=pr, max_new=4))
    done = {r.rid: r for r in eng.run_to_completion()}
    ref_done = {r.rid: r for r in ref_eng.run_to_completion()}
    assert len(done) == len(ref_done) == 3
    for rid, req in done.items():
        toks = list(req.prompt)
        for _ in range(4):
            logits, _ = tf.forward(p, pc, torch.tensor(toks)[None])
            toks.append(int(torch.argmax(logits[0, -1])))
        assert req.tokens == toks[len(req.prompt):], (rid, req.tokens, toks[len(req.prompt):])
        assert req.tokens == ref_done[rid].tokens


def test_rolling_window_engine_matches_reference():
    """window=16 with prompts past the window: the rolling slot cache."""
    rc, pc, ref_p, p = _setup(window=16, compute_dtype=jnp.float32)
    pc = dataclasses.replace(pc, compute_dtype=torch.float32)
    prompts = _prompts(pc.vocab, (40, 9, 23))
    eng = ServeEngine(p, pc, n_slots=2, device="cpu")
    ref_eng = RefEngine(ref_p, rc, n_slots=2)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new=6))
        ref_eng.submit(RefRequest(rid=i, prompt=pr, max_new=6))
    got = {r.rid: r.tokens for r in eng.run_to_completion()}
    want = {r.rid: r.tokens for r in ref_eng.run_to_completion()}
    assert got == want


def test_pallas_config_raises_at_first_decode_in_both():
    rc, pc, ref_p, p = _setup(attn_impl="pallas")
    prompt = _prompts(pc.vocab)[0]
    ref_eng = RefEngine(ref_p, rc, n_slots=1, max_len=32)
    ref_eng.submit(RefRequest(rid=0, prompt=prompt, max_new=4))
    with pytest.raises(NotImplementedError):
        ref_eng.step()
    eng = ServeEngine(p, pc, n_slots=1, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=4))
    with pytest.raises(NotImplementedError):
        eng.step()
    # The prefill went through the flash path and sampled its first token.
    assert len(eng.slot_req[0].tokens) == 1


@pytest.mark.parametrize("window", [None, 16])
def test_batched_slot_decode_equals_per_slot_decode(window):
    """Slots at different lengths decoded as one batch == each slot decoded
    alone (B=1) at its own length: logits and cache rows."""
    pc = dataclasses.replace(get_arch("llama3.2-3b").reduced_config, remat=False, window=window)
    p = tf.init_params(pc, torch.Generator().manual_seed(5), device="cpu")
    eng = ServeEngine(p, pc, n_slots=3, max_len=48, device="cpu")
    for i, pr in enumerate(_prompts(pc.vocab, (5, 21, 12))):
        eng.submit(Request(rid=i, prompt=pr, max_new=8))
    eng.step()
    eng.step()  # the slots now hold 6, 22 and 13 tokens
    cache = {k: v.clone() for k, v in eng.cache.items()}
    cur = torch.as_tensor(eng.cur_len)
    toks = torch.tensor([[r.tokens[-1]] for r in eng.slot_req])
    logits, batched, _ = tf.decode_step(p, pc, cache, toks, cur)
    for i in range(3):
        one = {k: v[:, i:i + 1].clone() for k, v in eng.cache.items()}
        logits_i, one, _ = tf.decode_step(p, pc, one, toks[i:i + 1], int(cur[i]))
        torch.testing.assert_close(logits[i:i + 1], logits_i, rtol=1e-6, atol=1e-6)
        for k in ("k", "v"):
            assert torch.equal(batched[k][:, i:i + 1], one[k])


def test_queue_sheds_when_full():
    pc = get_arch("llama3.2-3b").reduced_config
    p = tf.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(p, pc, n_slots=1, max_len=32, max_queue=1, device="cpu")
    prompts = _prompts(pc.vocab)
    assert eng.submit(Request(rid=0, prompt=prompts[0], max_new=2))
    shed = Request(rid=1, prompt=prompts[1], max_new=2)
    assert not eng.submit(shed) and shed.rejected and eng.rejected == 1
    assert [r.rid for r in eng.run_to_completion()] == [0]


def test_serve_engine_bounded_queue_sheds():
    """The reference's unit-level shedding test
    (tests/test_resilience.py::test_serve_engine_bounded_queue_sheds), run on
    both engines side by side: the same outcomes, counts and flags."""
    import collections

    outcomes = []
    for engine_cls, request_cls in ((ServeEngine, Request), (RefEngine, RefRequest)):
        eng = engine_cls.__new__(engine_cls)
        eng.queue = collections.deque()
        eng.max_queue = 2
        eng.rejected = 0
        reqs = [request_cls(rid=i, prompt=np.zeros(2, np.int32)) for i in range(4)]
        outcomes.append(([eng.submit(r) for r in reqs], eng.rejected, len(eng.queue),
                         [r.rejected for r in reqs]))
    assert outcomes[0] == outcomes[1] == ([True, True, False, False], 2, 2,
                                          [False, False, True, True])
    with pytest.raises(ValueError, match="max_queue"):
        ServeEngine(None, get_arch("llama3.2-3b").reduced_config, max_queue=0, device="cpu")
