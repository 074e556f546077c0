"""Port parity of the tile-partitioned neighbor sum
(``repro_torch.models.gnn.dist``) against ``repro.models.gnn.dist``:

* ``build_edge_tiling``: every array equal to the reference's, bit for bit,
  and every edge in one in-tile and one out-tile slot;
* ``make_tiled_neighbor_sum`` on 4 gloo ranks spawned once
  (tests/torch_dist_gnn_ranks.py; 60 s group timeouts, a 240 s join), over
  a 4-rank mesh and a 2 x 2 mesh whose edge axes run ("model", "data"):
  each rank's tile of Z and the gradients with respect to X and the edge
  weights against the untiled oracle, the port's ``neighbor_sum_reference``
  and the reference's (JAX, one device), at rtol 1e-5 / atol 1e-5 (values)
  and rtol 1e-4 / atol 1e-5 (gradients), the reference test's limits; a
  forward of one all-gather and a backward of one all-gather and one
  all-reduce.  The control (the tile of another rank) must fail them;
* the same on a one-rank gloo mesh in the test process.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import dist as ref_dist
from repro_torch.models.gnn import dist

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
JOIN_S = 240
N, E, C = 97, 400, 8


def _inputs(seed=0, n_dev=WORLD):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    n_pad = -(-N // n_dev) * n_dev
    x = rng.standard_normal((n_pad, C)).astype(np.float32)
    x[N:] = 0.0
    w = rng.random(E).astype(np.float32)
    probe = rng.standard_normal((n_pad, C)).astype(np.float32)
    return dict(src=src, dst=dst, n=np.asarray(N), x=x, w=w, probe=probe)


def _oracle(inp):
    """(Z, dX, dw) of sum(Z * probe), from the port's untiled oracle."""
    x = torch.from_numpy(inp["x"]).requires_grad_()
    w = torch.from_numpy(inp["w"]).requires_grad_()
    z = dist.neighbor_sum_reference(x, w, torch.from_numpy(inp["src"]),
                                    torch.from_numpy(inp["dst"]), inp["x"].shape[0])
    (z * torch.from_numpy(inp["probe"])).sum().backward()
    return z.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("n_dev", [1, 3, 4])
def test_tiling_equals_reference_bitwise(n_dev):
    inp = _inputs(seed=2)
    want = ref_dist.build_edge_tiling(inp["src"], inp["dst"], N, n_dev)
    got = dist.build_edge_tiling(inp["src"], inp["dst"], N, n_dev)
    for f in ("in_src", "in_dst_local", "in_eid", "out_dst", "out_src_local", "out_eid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.tile_n, got.n_nodes_padded) == (want.tile_n, want.n_nodes_padded)
    np.testing.assert_array_equal(np.sort(got.in_eid[got.in_eid >= 0]), np.arange(E))
    np.testing.assert_array_equal(np.sort(got.out_eid[got.out_eid >= 0]), np.arange(E))


def test_oracle_matches_reference_oracle():
    inp = _inputs()
    want = ref_dist.neighbor_sum_reference(jnp.asarray(inp["x"]), jnp.asarray(inp["w"]),
                                           jnp.asarray(inp["src"]), jnp.asarray(inp["dst"]),
                                           inp["x"].shape[0])
    got = _oracle(inp)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_one_rank_mesh_in_process():
    from repro_torch.core.mapreduce import make_mesh

    inp = _inputs(seed=1, n_dev=1)
    mesh = make_mesh((1,), ("d",), device="cpu")
    f = dist.make_tiled_neighbor_sum(dist.build_edge_tiling(inp["src"], inp["dst"], N, 1),
                                     mesh, ("d",))
    x = torch.from_numpy(inp["x"]).requires_grad_()
    w = torch.from_numpy(inp["w"]).requires_grad_()
    z = f(x, w)
    (z * torch.from_numpy(inp["probe"])).sum().backward()
    wz, wdx, wdw = _oracle(inp)
    np.testing.assert_allclose(z.detach().numpy(), wz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), wdx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), wdw, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="tiles"):
        dist.make_tiled_neighbor_sum(dist.build_edge_tiling(inp["src"], inp["dst"], N, 2),
                                     mesh, ("d",))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_gnn_ranks"))
    inp = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    script = os.path.join(os.path.dirname(__file__), "torch_dist_gnn_ranks.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), tmp], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return inp, out


@pytest.mark.parametrize("case", ["d4", "model_data"])
def test_four_ranks_match_the_oracle(four_ranks, case):
    inp, answers = four_ranks
    wz, wdx, wdw = _oracle(inp)
    tile = wz.shape[0] // WORLD
    blocks = sorted(a[case]["block"] for a in answers)
    assert blocks == list(range(WORLD))
    if case == "model_data":  # some rank's block is not its rank
        assert [a[case]["block"] for a in answers] != list(range(WORLD))
    for a in answers:
        got = a[case]
        rows = slice(got["block"] * tile, (got["block"] + 1) * tile)
        np.testing.assert_allclose(got["z"], wz[rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dx"], wdx[rows], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["dw"], wdw, rtol=1e-4, atol=1e-5)
        assert (got["all_gather"], got["all_reduce"]) == (2, 1)
        other = slice(((got["block"] + 1) % WORLD) * tile, ((got["block"] + 1) % WORLD + 1) * tile)
        assert (np.abs(got["z"] - wz[other]) > 1e-5 * (1 + np.abs(wz[other]))).any()
