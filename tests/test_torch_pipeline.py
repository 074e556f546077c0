"""The port's GPipe pipeline (``repro_torch.sharding.pipeline``) against the
sequential stack and the reference's ``pipelined_apply``.

2 and 4 gloo ranks (``tests/torch_pipeline_ranks.py``, a file store in a
temp dir, 60 s group timeouts) run ``pipelined_apply`` over a 1-D mesh
("pod",) on seeded f32 weights and microbatches, then the gradient of the
mean square of the output.  Every rank's output must equal the
sequential stack (rtol = atol 2e-5) and the sum of the ranks' gradients
(each rank holds its stage's slice) its gradient (rtol 5e-4, atol 1e-5),
the limits of ``tests/test_pipeline.py``; both must equal the reference's
``pipelined_apply`` run in a child with 4 forced host devices, to the same
limits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.sharding.pipeline import bubble_fraction as ref_bubble_fraction
from repro_torch.sharding.pipeline import bubble_fraction

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_MICRO, MB, D = 8, 2, 16


def _inputs(n_stages: int):
    rng = np.random.default_rng(n_stages)
    w = (rng.standard_normal((n_stages, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return w, x


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    return env


_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.sharding.pipeline import pipelined_apply

out = {}
for s in (2, 4):
    d = np.load(sys.argv[1] + f"/in{s}.npz")
    w, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])
    mesh = Mesh(np.asarray(jax.devices()[:s]).reshape(s), ("pod",))
    fn = lambda wi, h: jnp.tanh(h @ wi)
    y = pipelined_apply(mesh, "pod", fn, w, x)
    g = jax.grad(lambda w: jnp.mean(pipelined_apply(mesh, "pod", fn, w, x) ** 2))(w)
    out[s] = {"out": np.asarray(y).tolist(), "grad": np.asarray(g).tolist()}
print("RESULT=" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_ref")
    for s in (2, 4):
        w, x = _inputs(s)
        np.savez(tmp / f"in{s}.npz", w=w, x=x)
    res = subprocess.run([sys.executable, "-c", _REF, str(tmp)], capture_output=True, text=True,
                         timeout=300, env=_env(), cwd=REPO)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT=")]
    assert line, res.stderr[-3000:]
    out = json.loads(line[-1][len("RESULT="):])
    return {int(k): {n: np.asarray(v, np.float32) for n, v in r.items()} for k, r in out.items()}


def _sequential(w, x):
    wt = torch.from_numpy(w).requires_grad_()
    h = torch.from_numpy(x)
    for s in range(w.shape[0]):
        h = torch.tanh(h @ wt[s])
    (h ** 2).mean().backward()
    return h.detach().numpy(), wt.grad.numpy()


def _ranks(n_stages: int, tmp):
    w, x = _inputs(n_stages)
    np.savez(tmp / "inputs.npz", w=w, x=x)
    script = os.path.join(REPO, "tests", "torch_pipeline_ranks.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(n_stages), str(tmp)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n_stages)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append(err.decode()[-2000:])
    assert all(p.returncode == 0 for p in procs), errs
    return [np.load(tmp / f"rank{r}.npz") for r in range(n_stages)], w, x


def test_bubble_fraction():
    for s, m in [(4, 12), (1, 8), (2, 4), (16, 64)]:
        assert bubble_fraction(s, m) == ref_bubble_fraction(s, m)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_on_gloo_ranks_matches_sequential_and_reference(n_stages, tmp_path, reference):
    outs, w, x = _ranks(n_stages, tmp_path)
    want_out, want_grad = _sequential(w, x)
    grad = sum(o["grad"] for o in outs)
    for o in outs:  # every rank holds the last stage's outputs
        np.testing.assert_allclose(o["out"], want_out, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(o["out"], reference[n_stages]["out"], rtol=2e-5, atol=2e-5)
    for r, o in enumerate(outs):  # a rank's gradient is its stage's slice
        others = [s for s in range(n_stages) if s != r]
        assert not np.any(o["grad"][others])
    np.testing.assert_allclose(grad, want_grad, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(grad, reference[n_stages]["grad"], rtol=5e-4, atol=1e-5)
