"""Port parity: ``repro_torch.core.engine`` against ``repro.core.engine``.

Unweighted graphs keep every degree and total integer-valued, so the two
engines must agree bitwise: best set, density, size, passes, final bitmap
and per-pass history.  The pallas cells run the port's tiled-degree plain
version (CPU tensors) and the reference's K1 as its tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.graph.generators import erdos_renyi, planted_dense_subgraph
from repro.kernels.peel_degree import ops as ref_ops
from repro_torch.core import engine
from repro_torch.graph.edgelist import from_reference
from repro_torch.kernels.peel_degree import ops

GRAPHS = [
    ("er", lambda: erdos_renyi(180, avg_deg=8, seed=0)),
    ("planted", lambda: planted_dense_subgraph(250, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]),
]


def _port(e):
    return from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        np.asarray(e.mask), e.n_nodes, e.directed, "cpu",
    )


def _same(port_t, ref_a):
    a = np.asarray(ref_a)
    b = port_t.numpy() if isinstance(port_t, torch.Tensor) else np.asarray(port_t)
    assert b.shape == a.shape
    assert b.tobytes() == a.astype(b.dtype).tobytes(), (b, a)


def _same_outcome(port, ref, history=True):
    _same(port.best_alive, ref.best_alive)
    _same(port.best_density, ref.best_density)
    _same(port.best_size, ref.best_size)
    assert port.passes == int(ref.passes)
    _same(port.alive, ref.alive)
    if history:
        _same(port.history_n, ref.history_n)
        _same(port.history_m, ref.history_m)
        _same(port.history_rho, ref.history_rho)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
@pytest.mark.parametrize("graph", [g for g, _ in GRAPHS])
@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_matrix_undirected_threshold(graph, backend, eps):
    edges = dict(GRAPHS)[graph]()
    pe = _port(edges)
    mp = 64
    if backend == "exact":
        ref_be, port_be = ref_engine.ExactBackend(), engine.ExactBackend()
    else:
        ref_be = ref_ops.degree_backend_from_tiling(
            ref_ops.tiling_for_edges(edges, tile_size=128, block=128), use_pallas=False
        )
        port_be = ops.degree_backend_from_tiling(ops.tiling_for_edges(pe, tile_size=128))
    ref = jax.jit(
        lambda e: ref_engine.run_peel(
            e, ref_engine.UndirectedThreshold(eps), ref_be, mp, track_history=True
        )
    )(edges)
    got = engine.run_peel(pe, engine.UndirectedThreshold(eps), port_be, mp, track_history=True)
    _same_outcome(got, ref)


def test_pallas_backend_matches_exact():
    """The tiled-degree backend is exact arithmetic: identical sets to the
    exact backend, and to the reference's Pallas cell."""
    edges = erdos_renyi(300, avg_deg=6, seed=4)
    pe = _port(edges)
    mp = 64
    policy = engine.UndirectedThreshold(0.5)
    a = engine.run_peel(pe, policy, ops.degree_backend_from_tiling(
        ops.tiling_for_edges(pe, tile_size=128)), mp)
    b = engine.run_peel(pe, policy, engine.ExactBackend(), mp)
    _same(a.best_alive, b.best_alive.numpy())
    assert float(a.best_density) == float(b.best_density)
    ref_be = ref_ops.degree_backend_from_tiling(
        ref_ops.tiling_for_edges(edges, tile_size=128, block=128), use_pallas=True
    )
    ref = jax.jit(
        lambda e: ref_engine.run_peel(e, ref_engine.UndirectedThreshold(0.5), ref_be, mp)
    )(edges)
    _same_outcome(a, ref, history=False)


def test_undirected_pass_step_equals_engine_pass():
    """One undirected_pass_step == one engine pass, and == the reference's."""
    edges = erdos_renyi(150, avg_deg=8, seed=6)
    pe = _port(edges)
    res1 = engine.run_peel(pe, engine.UndirectedThreshold(0.5), engine.ExactBackend(), 1)
    alive = torch.ones(pe.n_nodes, dtype=torch.bool)
    w_alive = torch.where(pe.mask & alive[pe.src] & alive[pe.dst], pe.weight, 0.0)
    deg, total = engine.ExactBackend().undirected(pe, w_alive)
    new_alive, rho = engine.undirected_pass_step(alive, deg, float(total), 0.5)
    _same(new_alive, res1.alive.numpy())
    assert float(rho) == float(res1.best_density)
    ref_deg, ref_total = ref_engine.ExactBackend().undirected(edges, edges.weight)
    ref_alive, ref_rho = ref_engine.undirected_pass_step(
        jnp.ones((edges.n_nodes,), bool), ref_deg, float(ref_total), 0.5
    )
    _same(new_alive, ref_alive)
    _same(rho, ref_rho)


@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_segmented_run_equals_single_run(eps):
    """compact_below + init_alive/init_t re-entry == one uncompacted run
    (earliest-wins merge), and the single run == the reference's."""
    edges = erdos_renyi(220, avg_deg=8, seed=2)
    pe = _port(edges)
    mp = 64
    policy = engine.UndirectedThreshold(eps)
    full = engine.run_peel(pe, policy, engine.ExactBackend(), mp, track_history=True)
    m = int(pe.num_real_edges())
    seg1 = engine.run_peel(
        pe, policy, engine.ExactBackend(), mp, track_history=True,
        compact_below=m // 2, init_best_empty=True,
    )
    assert seg1.passes < full.passes  # the trigger fired
    seg2 = engine.run_peel(
        pe, policy, engine.ExactBackend(), mp, track_history=True,
        init_alive=seg1.alive, init_t=seg1.passes, init_best_empty=True,
    )
    use2 = float(seg2.best_density) > float(seg1.best_density)
    best = seg2.best_alive if use2 else seg1.best_alive
    _same(best, full.best_alive.numpy())
    assert max(float(seg1.best_density), float(seg2.best_density)) == float(full.best_density)
    assert seg2.passes == full.passes
    _same(seg2.alive, full.alive.numpy())
    hn1 = seg1.history_n
    _same(torch.where(hn1 >= 0, hn1, seg2.history_n), full.history_n.numpy())

    ref = jax.jit(
        lambda e: ref_engine.run_peel(
            e, ref_engine.UndirectedThreshold(eps), ref_engine.ExactBackend(), mp,
            track_history=True,
        )
    )(edges)
    _same_outcome(full, ref)
    ref_seg1 = jax.jit(
        lambda e: ref_engine.run_peel(
            e, ref_engine.UndirectedThreshold(eps), ref_engine.ExactBackend(), mp,
            track_history=True, compact_below=m // 2, init_best_empty=True,
        )
    )(edges)
    _same_outcome(seg1, ref_seg1)


def test_with_edge_state_returns_the_carried_filter():
    edges = erdos_renyi(220, avg_deg=8, seed=2)
    pe = _port(edges)
    m = int(pe.num_real_edges())
    out, ok, ae = engine.run_peel(
        pe, engine.UndirectedThreshold(0.5), engine.ExactBackend(), 64,
        compact_below=m // 2, with_edge_state=True,
    )
    want = pe.mask & out.alive[pe.src] & out.alive[pe.dst]
    _same(ok, want.numpy())
    assert int(ae) == int(want.sum()) < m // 2
    with pytest.raises(ValueError):
        engine.run_peel(pe, engine.UndirectedThreshold(0.5), engine.ExactBackend(), 4,
                        with_edge_state=True)


def test_compact_edges_prefix_sum_relabeling():
    """Surviving slots move to the front in order, everything else drops,
    including survivors past a too-small capacity; same as the reference."""
    ok_np = np.array([False, True, False, True, True, False, True])
    ok = torch.from_numpy(ok_np)
    src = torch.arange(7, dtype=torch.int32) * 10
    w = torch.arange(7, dtype=torch.float32)
    csrc, cw = engine.compact_edges(ok, (src, w), 4)
    np.testing.assert_array_equal(csrc.numpy(), [10, 30, 40, 60])
    np.testing.assert_array_equal(cw.numpy(), [1.0, 3.0, 4.0, 6.0])
    (csrc2,) = engine.compact_edges(ok, (src,), 2)
    np.testing.assert_array_equal(csrc2.numpy(), [10, 30])
    (csrc8,) = engine.compact_edges(ok, (src,), 8)
    np.testing.assert_array_equal(csrc8.numpy(), [10, 30, 40, 60, 0, 0, 0, 0])
    for cap in (2, 4, 8):
        (ref,) = ref_engine.compact_edges(
            jnp.asarray(ok_np), (jnp.arange(7, dtype=jnp.int32) * 10,), cap
        )
        (got,) = engine.compact_edges(ok, (src,), cap)
        _same(got, ref)
        assert got.dtype == torch.int32
    (empty,) = engine.compact_edges(torch.zeros(0, dtype=torch.bool), (src[:0],), 3)
    np.testing.assert_array_equal(empty.numpy(), [0, 0, 0])


def test_density_primitives_match_reference():
    from repro.core import density as ref_density
    from repro_torch.core import density

    edges = planted_dense_subgraph(250, avg_deg=4, k=25, p_dense=0.8, seed=3)[0]
    pe = _port(edges)
    alive_np = np.random.default_rng(0).random(edges.n_nodes) < 0.7
    w_ref = ref_density.alive_edge_weight(edges, jnp.asarray(alive_np))
    w = density.alive_edge_weight(pe, torch.from_numpy(alive_np))
    _same(w, w_ref)
    _same(density.exact_degrees(pe, w), ref_density.exact_degrees(edges, w_ref))
    for n, eps in [(2, 0.5), (976_000, 0.5), (1000, 0.0), (10, 1e-9), (5_000_000, 0.1)]:
        assert density.max_passes_bound(n, eps) == ref_density.max_passes_bound(n, eps)
