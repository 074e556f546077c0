"""The rules the redesigned K2 and K3 follow, checked on the CPU through
their plain versions (the kernels themselves run only on the card, in
tests/test_torch_cuda.py).

K2 folds each run of equal endpoints inside a 32-edge step into one
``(x, Σw)`` add (``count_sketch/ref.py::combine_runs``).  The counters of
the folded stream equal those of the raw stream (and the reference's):
bitwise on integer weights, within ``MASS_TOL`` of each counter's absolute
mass on float weights (the limit ``chip_smoke.py`` holds K2 to).  K3
scatters into the sketch viewed as ``[L*d*C, 4]`` at
``l0_sampler/ops.py::flat_cells``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.countsketch import make_sketch_params as ref_sketch_params
from repro.kernels.count_sketch.ops import count_sketch_update as ref_cs_update
from repro.kernels.l0_sampler import ops as ref_l0
from repro_torch.core.countsketch import _hash_bucket, make_sketch_params
from repro_torch.kernels import hashing
from repro_torch.kernels.count_sketch.ref import STEP, combine_runs, count_sketch_update_ref
from repro_torch.kernels.l0_sampler import ops as l0_ops
from repro_torch.kernels.l0_sampler.ref import l0_delta_ref

# chip_smoke.py's limit for K2 on float weights, relative to 1 + a
# counter's absolute mass.
MASS_TOL = 3e-6


def _stream(case, n=1000, seed=0):
    """Endpoints of one stream shape and its integer weights (0..3)."""
    rng = np.random.default_rng(seed)
    if case == "sorted":  # lower endpoints of a sorted edge list
        x = np.sort(rng.integers(0, 60, n))
    elif case == "hub":
        x = np.full(n, 7)
    elif case == "alternating":
        x = np.arange(n) % 2 + 11
    elif case == "distinct":
        x = rng.permutation(n)
    elif case == "runs_cross_steps":  # runs of 50 from row 20 on
        x = np.repeat(np.arange(n // 50 + 2), 50)[30:30 + n]
    elif case == "ragged":  # E a multiple of no step
        n = 32 * 9 + 13
        x = np.repeat(rng.integers(0, 40, n // 7 + 1), 7)[:n]
    elif case == "zero_weights":
        x = np.sort(rng.integers(0, 30, n))
    else:
        raise ValueError(case)
    w = rng.integers(0, 4, len(x)).astype(np.float32)
    if case == "zero_weights":
        w[rng.random(len(x)) < 0.5] = 0.0
        w[:3 * STEP] = 0.0  # whole steps of dead edges
    return torch.from_numpy(x.astype(np.int32)), torch.from_numpy(w)


CASES = ["sorted", "hub", "alternating", "distinct", "runs_cross_steps", "ragged",
         "zero_weights"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("t,b", [(5, 8192), (3, 128)])
def test_combined_stream_counters_equal_raw(case, t, b):
    x, w = _stream(case)
    p = make_sketch_params(t, b, seed=3)
    xs, ws = combine_runs(x, w)
    got = count_sketch_update_ref(xs, ws, p)
    assert torch.equal(got, count_sketch_update_ref(x, w, p))
    want = ref_cs_update(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                         ref_sketch_params(t, b, seed=3), use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (ws != 0).all() and len(xs) <= len(x)
    if case == "zero_weights":  # dead edges leave empty counters at +0.0
        assert not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("case", CASES)
def test_combined_stream_float_weights_within_mass(case):
    x, _ = _stream(case)
    w = torch.from_numpy(np.random.default_rng(5).random(len(x)).astype(np.float32))
    if case == "zero_weights":
        w[:3 * STEP] = 0.0
    p = make_sketch_params(5, 256, seed=1)
    xs, ws = combine_runs(x, w)
    got = count_sketch_update_ref(xs, ws, p).double()
    want = count_sketch_update_ref(x, w.double(), p)
    mass = 1 + torch.zeros(p.n_tables, p.n_buckets, dtype=torch.float64).scatter_add_(
        1, _hash_bucket(p, x).long(), w.double().abs().expand(p.n_tables, -1))
    assert ((got - want).abs() / mass).max().item() <= MASS_TOL


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_combine_runs_adds_per_table(n):
    """One hub: one add a 32-edge step, ⌈E/32⌉ per table.  All endpoints
    distinct: E.  All weights zero: none."""
    ones = torch.ones(n)
    hub, _ = combine_runs(torch.full((n,), 9, dtype=torch.int32), ones)
    assert len(hub) == -(-n // STEP)
    distinct, sums = combine_runs(torch.arange(n, dtype=torch.int32), ones)
    assert len(distinct) == n and torch.equal(sums, ones)
    none, _ = combine_runs(torch.zeros(n, dtype=torch.int32), torch.zeros(n))
    assert len(none) == 0


def test_combine_runs_folds_only_inside_a_step():
    x = torch.tensor([4] * 40 + [5, 4, 4], dtype=torch.int32)
    xs, ws = combine_runs(x, torch.ones(len(x)))
    assert xs.tolist() == [4, 4, 5, 4] and ws.tolist() == [32.0, 8.0, 1.0, 2.0]


@pytest.mark.parametrize("L,C,d", [(32, 1 << 14, 3), (8, 256, 3), (1, 1000, 2), (4, 64, 5)])
def test_l0_flat_cells_index_the_delta(L, C, d):
    """The delta is an ``index_add_`` of the four fields at ``flat_cells``,
    on the sketch viewed as ``[L*d*C, 4]``, and equals the plain version
    and the reference's bit for bit."""
    rng = np.random.default_rng(L + C + d)
    u = rng.integers(0, 5000, 3000).astype(np.int32)
    v = rng.integers(0, 5000, 3000).astype(np.int32)
    v[::11] = u[::11]
    s = rng.choice(np.array([1, -1, 0], np.int32), 3000)
    p = l0_ops.make_l0_params(n_levels=L, n_cells=C, n_tables=d, seed=2)
    cu, cv, cs = l0_ops.canonicalize_edges(*(torch.from_numpy(a) for a in (u, v, s)))
    flat = l0_ops.flat_cells(p, cu, cv)
    assert flat.dtype == torch.int64 and tuple(flat.shape) == (d, 3000)
    assert torch.equal(flat // C % d, torch.arange(d)[:, None].expand(d, 3000))
    assert torch.equal(flat // (C * d), l0_ops.edge_level(p, cu, cv).long().expand(d, -1))
    sl = cs.long()
    fp = hashing.to_i32(l0_ops.edge_fingerprint(p, cu, cv)).long()
    vals = torch.stack([sl, sl * cu.long(), sl * cv.long(), sl * fp], -1).repeat(d, 1)
    delta = torch.zeros(L * d * C, 4, dtype=torch.int64).index_add_(0, flat.reshape(-1), vals)
    got = hashing.to_i32(delta).reshape(L, d, C, 4)
    assert torch.equal(got, l0_delta_ref(cu, cv, cs, p))
    rp = ref_l0.make_l0_params(n_levels=L, n_cells=C, n_tables=d, seed=2)
    want = ref_l0.l0_delta(jnp.asarray(u), jnp.asarray(v), jnp.asarray(s), rp, use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
