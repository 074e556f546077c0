"""Prints how far the PyTorch port's LM is from the JAX package's, per arch.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_lm_errors.py

For the REDUCED llama3.2-3b, starcoder2-7b and qwen2-72b configs, with the
JAX package's parameters carried across by ``params_from_reference``, the
inputs of ``tests/test_torch_transformer.py::test_forward_prefill_decode_match_reference``
(seed 0, two 24-token prompts, ``extra_slots=4``) go through ``forward``,
``prefill`` and one ``decode_step`` in both packages, at each
``compute_dtype`` and ``attn_impl``.  Each line is one arch, dtype and
impl, with, per output (the prefill's KV cache: the worse of K and V), the
least tolerance ``t`` that ``assert_allclose(got, want, rtol=t, atol=t)``
would pass (max |got - want| / (1 + |want|)) and the largest absolute
error.  The test's tolerances are chosen above these readings.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tf

ARCHS = ("llama3.2-3b", "starcoder2-7b", "qwen2-72b")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def reading(got, want) -> dict:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    err = np.abs(g - w)
    return {"least_tol": float((err / (1 + np.abs(w))).max()), "max_abs_err": float(err.max())}


def measure(arch: str, dtype: str, impl: str) -> dict:
    jd, td = DTYPES[dtype]
    rc = dataclasses.replace(ref_get_arch(arch).reduced_config, remat=False, compute_dtype=jd,
                             attn_impl=impl)
    pc = dataclasses.replace(get_arch(arch).reduced_config, remat=False, compute_dtype=td,
                             attn_impl=impl)
    ref_p = ref_tf.init_params(jax.random.PRNGKey(0), rc)
    p = tf.params_from_reference(jax.tree.map(np.asarray, ref_p), pc, device="cpu")
    tokens = np.random.default_rng(0).integers(0, rc.vocab, (2, 24), dtype=np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    out = {"forward": reading(tf.forward(p, pc, tt)[0], ref_tf.forward(ref_p, rc, jt)[0])}
    want_l, want_c, want_len = ref_tf.prefill(ref_p, rc, jt, extra_slots=4)
    got_l, got_c, got_len = tf.prefill(p, pc, tt, extra_slots=4)
    out["prefill"] = reading(got_l, want_l)
    out["prefill_cache"] = max((reading(got_c[k], want_c[k]) for k in ("k", "v")),
                               key=lambda r: r["least_tol"])
    if impl == "xla":  # the reference's decode has no pallas path
        nxt = np.asarray(jnp.argmax(want_l, -1)).astype(np.int32)[:, None]
        want_d = ref_tf.decode_step(ref_p, rc, want_c, jnp.asarray(nxt), want_len)[0]
        got_d = tf.decode_step(p, pc, got_c, torch.from_numpy(nxt), got_len)[0]
        out["decode_step"] = reading(got_d, want_d)
    return out


def main() -> None:
    for arch in ARCHS:
        for dtype in DTYPES:
            for impl in ("xla", "pallas"):
                print(json.dumps({"arch": arch, "compute_dtype": dtype, "attn_impl": impl,
                                  **measure(arch, dtype, impl)}), flush=True)


if __name__ == "__main__":
    main()
