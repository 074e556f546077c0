"""The port's CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU (the kernel is CUDA C++ and has no CPU
mode) and skip with that reason without one.  They import neither JAX nor
the JAX package, so they run on a machine with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Problem, solve
from repro_torch.graph import generators
from repro_torch.graph.partition import TiledEdges, bucket_edges_by_tile
from repro_torch.kernels.peel_degree.ops import tiled_degrees
from repro_torch.kernels.peel_degree.ref import tiled_degrees_ref

pytestmark = pytest.mark.cuda

SHAPES = [(100, 400, 32), (1000, 5000, 128), (257, 1000, 64), (64, 50, 64), (20_000, 300_000, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _tiling(src, dst, n, tile_size, device):
    return bucket_edges_by_tile(
        torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device), n, tile_size=tile_size
    )


@pytest.mark.parametrize("n_nodes,n_edges,tile_size", SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_kernel_matches_plain(cuda, n_nodes, n_edges, tile_size, integer):
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    w = (rng.integers(0, 4, n_edges) if integer else rng.random(n_edges)).astype(np.float32)
    tiling = _tiling(src, dst, n_nodes, tile_size, cuda)
    wt = torch.from_numpy(w).to(cuda)
    before = tiled_degrees.launches
    got = tiled_degrees(tiling, wt, n_nodes=n_nodes)
    torch.cuda.synchronize()
    assert tiled_degrees.launches == before + 1
    if integer:
        assert torch.equal(got, tiled_degrees_ref(tiling, wt)[:n_nodes])
    else:  # f32 reassociation (atomics add in no fixed order): vs the plain version in f64
        want = tiled_degrees_ref(tiling, wt.double())[:n_nodes].float()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_tl,pad_ei", [(0, -1), (-1, -1), (-1, 0)])
def test_kernel_ignores_dense_padding(cuda, pad_tl, pad_ei):
    rng = np.random.default_rng(3)
    n, tile_size = 257, 64
    src = rng.integers(0, n, 1000).astype(np.int32)
    dst = rng.integers(0, n, 1000).astype(np.int32)
    w = torch.from_numpy(rng.integers(0, 4, 1000).astype(np.float32)).to(cuda)
    base = _tiling(src, dst, n, tile_size, cuda)
    tl, sg, ei = base.to_dense(256)
    pad = ei < 0
    tl[pad], ei[pad] = pad_tl, pad_ei
    n_tiles, width = tl.shape
    dense = TiledEdges.from_ragged(
        torch.arange(n_tiles + 1, dtype=torch.int64, device=cuda) * width,
        tl.reshape(-1), sg.reshape(-1), ei.reshape(-1),
        tile_size=tile_size, n_nodes=n, n_edges=base.n_edges,
    )
    assert torch.equal(tiled_degrees(dense, w, n_nodes=n), tiled_degrees(base, w, n_nodes=n))


@pytest.mark.parametrize("compaction", ["off", "geometric", "twophase"])
def test_solve_on_card_equals_cpu(cuda, compaction):
    answers = []
    for device, backend in (("cuda", "pallas"), ("cuda", "exact"), ("cpu", "pallas")):
        edges, _ = generators.planted_dense_subgraph(3000, 6, 80, 0.5, seed=1, device=device)
        res = solve(edges, Problem.undirected(eps=0.3, backend=backend, compaction=compaction,
                                              track_history=True, tile_size=256))
        answers.append(res)
    for res in answers[1:]:
        for f in ("best_alive", "best_density", "best_size", "alive", "history_n",
                  "history_m", "history_rho"):
            assert torch.equal(getattr(res, f).cpu(), getattr(answers[0], f).cpu()), f
        assert res.passes == answers[0].passes
