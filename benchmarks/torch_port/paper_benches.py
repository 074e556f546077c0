"""One benchmark per table and figure of the paper (Bahmani et al.,
VLDB'12), on the port (counterpart of ``benchmarks/paper_benches.py``).

  table2    §6.2 Table 2  approximation factor rho*/rho~ vs exact, per eps
  fig61     §6.3 Fig 6.1  eps -> (passes, density relative to the smallest eps)
  fig62_63  §6.3 Fig 6.2/6.3  per-pass density / |V| / |E| trajectories
  table3    §6.4 Table 3  directed: rho for an (eps, delta) grid
  fig64_66  §6.4 Fig 6.4/6.6  directed c sweep at delta=2
  table4    §6.5 Table 4  sketch-to-exact density ratio vs (eps, b)
  fig67     §6.6 Fig 6.7  per-pass wall of the mesh substrate (MapReduce analogue)
  lemma5    Lemma 5 instances: passes grow with k
  kernels   K1 (tiled degrees) three ways: the kernel, its plain version, index_add_

Every function takes its graph sizes as arguments (defaults: the
reference's) and ``device`` (default: the card); ``fig61`` and ``table4``
also take a graph the caller holds.  ``fig67`` runs on a mesh from
``make_mesh((world,), ('data',))``: one rank on one card, where the
reference forces 8 host devices; its rows say how many ranks ran.
``kernels`` times K1 with CUDA events on the card (the host clock on the
CPU, where the wrapper runs the plain version) beside the least time the
card could take for the bytes it must move.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from benchmarks.torch_port import common
from repro_torch.core import (
    c_grid,
    charikar_greedy,
    densest_directed_search,
    densest_subgraph,
    densest_subgraph_distributed,
    densest_subgraph_exact,
    densest_subgraph_sketched,
    make_mesh,
)
from repro_torch.graph import generators as gen
from repro_torch.graph.edgelist import resolve_device
from repro_torch.graph.partition import bucket_edges_by_tile
from repro_torch.kernels.peel_degree.ops import tiled_degrees
from repro_torch.kernels.peel_degree.ref import degrees_from_tiled, tiled_degrees_ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _rows_to_csv(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return ""
    keys = list(rows[0].keys())
    out = [",".join(keys)]
    for r in rows:
        out.append(",".join(str(r.get(k, "")) for k in keys))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Table 2: quality of approximation vs the exact optimum
# ---------------------------------------------------------------------------


def table2(eps_list=(0.001, 0.1, 1.0), n: int = 1500, device=None) -> List[Dict[str, Any]]:
    dev = resolve_device(device)
    graphs = {
        "as-like": gen.erdos_renyi(n=n, avg_deg=4.0, seed=1, device=dev),
        "collab-pl": gen.chung_lu_power_law(n=n, exponent=2.1, avg_deg=8.0, seed=2, device=dev),
        "dense-core": gen.planted_dense_subgraph(
            n=n * 4 // 5, avg_deg=4.0, k=60, p_dense=0.5, seed=3, device=dev)[0],
        "ba": gen.barabasi_albert(n=n, m_attach=5, seed=4, device=dev),
    }
    rows = []
    for name, edges in graphs.items():
        _, rho_star = densest_subgraph_exact(edges)
        _, rho_greedy = charikar_greedy(edges)
        row = {
            "graph": name,
            "n": edges.n_nodes,
            "m": int(edges.num_real_edges()),
            "rho_star": round(rho_star, 4),
            "charikar_ratio": round(rho_star / max(rho_greedy, 1e-9), 4),
        }
        for eps in eps_list:
            res = densest_subgraph(edges, eps=eps, track_history=False)
            ratio = rho_star / max(float(res.best_density), 1e-9)
            row[f"ratio_eps{eps}"] = round(ratio, 4)
            row[f"passes_eps{eps}"] = int(res.passes)
            assert ratio <= 2 * (1 + eps) + 1e-6, (name, eps, ratio)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Fig 6.1: eps vs approximation and passes
# ---------------------------------------------------------------------------


def fig61(eps_list=(0.001, 0.01, 0.1, 0.5, 1.0, 2.0, 4.0), n: int = 200_000, edges=None,
          device=None) -> List[Dict[str, Any]]:
    dev = resolve_device(device) if edges is None else edges.device
    if edges is None:
        edges = gen.chung_lu_power_law(n=n, exponent=2.0, avg_deg=12.0, seed=7, device=dev)
    base = None
    rows = []
    for eps in eps_list:
        common.sync(dev)
        t0 = time.perf_counter()
        res = densest_subgraph(edges, eps=eps, track_history=False)
        rho = float(res.best_density)
        wall = time.perf_counter() - t0
        if base is None:
            base = rho
        rows.append({
            "eps": eps,
            "density": round(rho, 3),
            "rel_density": round(rho / base, 4),
            "passes": int(res.passes),
            "wall_s": round(wall, 4),
        })
    return rows


# ---------------------------------------------------------------------------
# Fig 6.2 / 6.3: per-pass trajectories
# ---------------------------------------------------------------------------


def fig62_63(eps=0.5, n: int = 100_000, device=None) -> List[Dict[str, Any]]:
    dev = resolve_device(device)
    edges = gen.chung_lu_power_law(n=n, exponent=2.0, avg_deg=10.0, seed=8, device=dev)
    res = densest_subgraph(edges, eps=eps, track_history=True)
    hn = res.history_n.cpu().numpy()
    hm = res.history_m.cpu().numpy()
    hr = res.history_rho.cpu().numpy()
    return [{"pass": t, "nodes": int(hn[t]), "edges": int(hm[t]),
             "density": round(float(hr[t]), 3)} for t in range(int(res.passes))]


# ---------------------------------------------------------------------------
# Table 3 and Fig 6.4/6.6: directed
# ---------------------------------------------------------------------------


def _directed_graph(n: int, dev):
    return gen.directed_planted(n=n, avg_deg=8.0, ks=150, kt=60, p_dense=0.4, seed=9,
                                device=dev)[0]


def table3(n: int = 30_000, device=None) -> List[Dict[str, Any]]:
    edges = _directed_graph(n, resolve_device(device))
    rows = []
    for eps in (0.0, 1.0, 2.0):
        for delta in (2.0, 10.0, 100.0):
            best, best_c, _, passes = densest_directed_search(edges, eps=max(eps, 1e-9),
                                                              delta=delta)
            rows.append({
                "eps": eps,
                "delta": delta,
                "rho": round(float(best.best_density), 3),
                "best_c": round(best_c, 4),
                "total_passes": int(np.asarray(passes).sum()),
            })
    return rows


def fig64_66(eps=1.0, delta=2.0, n: int = 30_000, device=None) -> List[Dict[str, Any]]:
    edges = _directed_graph(n, resolve_device(device))
    _, _, rhos, passes = densest_directed_search(edges, eps=eps, delta=delta)
    return [{"c": round(float(c), 4), "rho": round(float(rho), 3), "passes": int(p)}
            for c, rho, p in zip(c_grid(edges.n_nodes, delta), rhos, passes)]


# ---------------------------------------------------------------------------
# Table 4: Count-Sketch quality/memory trade-off
# ---------------------------------------------------------------------------


def table4(t: int = 5, n: int = 97_600, edges=None, device=None) -> List[Dict[str, Any]]:
    if edges is None:
        edges = gen.chung_lu_power_law(n=n, exponent=2.0, avg_deg=16.0, seed=10,
                                       device=resolve_device(device))
    n = edges.n_nodes
    rows = []
    for eps in (0.0, 0.5, 1.0, 1.5, 2.0):
        # eps=0 row: threshold 2*rho (the paper's top row); passes capped.
        exact = densest_subgraph(edges, eps=max(eps, 1e-9), max_passes=256,
                                 track_history=False)
        row = {"eps": eps, "rho_exact_counts": round(float(exact.best_density), 3)}
        for b in (3000, 4000, 5000):
            sk = densest_subgraph_sketched(edges, eps=max(eps, 1e-9), t=t, b=b, seed=11,
                                           max_passes=256)
            row[f"ratio_b{b}"] = round(
                float(sk.best_density) / max(float(exact.best_density), 1e-9), 4)
            row[f"mem_frac_b{b}"] = round(t * b / n, 3)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Fig 6.7: per-pass wall of the mesh substrate (the MapReduce analogue)
# ---------------------------------------------------------------------------


def fig67(sizes=((50_000, 8.0), (200_000, 10.0), (500_000, 12.0)), mesh=None,
          device=None) -> List[Dict[str, Any]]:
    """The edge-sharded peel on ``mesh`` (or one over the running world,
    one rank outside ``torchrun``, destroyed before this returns)."""
    dev = resolve_device(device)
    started = mesh is None and not dist.is_initialized()
    if mesh is None:
        world = int(os.environ.get("WORLD_SIZE", 1)) if started else dist.get_world_size()
        mesh = make_mesh((world,), ("data",), device=dev)
    rows = []
    try:
        for n, avg in sizes:
            edges = gen.chung_lu_power_law(n=n, exponent=2.0, avg_deg=avg, seed=12, device=dev)
            m = int(edges.num_real_edges())
            common.sync(dev)
            t0 = time.perf_counter()
            res = densest_subgraph_distributed(edges, mesh, ("data",), eps=0.5)
            passes = int(res.passes)
            wall = time.perf_counter() - t0
            rows.append({
                "nodes": n,
                "edges": m,
                "ranks": int(mesh.size()),
                "passes": passes,
                "rho": round(float(res.best_density), 4),
                "wall_s": round(wall, 4),
                "s_per_pass": round(wall / max(passes, 1), 5),
                "edges_per_s": int(m * passes / wall),
            })
    finally:
        if started:
            dist.destroy_process_group()
    return rows


# ---------------------------------------------------------------------------
# K1 three ways
# ---------------------------------------------------------------------------


def kernel_bound_ms(tiling, n_edges: int) -> float:
    """Least time on the card: every input byte read once (target_local,
    edge_index, the chunk list, tile_ptr, w_alive), the output written once,
    over HBM bandwidth.  The adds are far below the compute peak."""
    bytes_moved = (
        tiling.n_slots * 8
        + tiling.chunk_tile.numel() * 12
        + tiling.tile_ptr.numel() * 8
        + n_edges * 4
        + tiling.n_tiles * tiling.tile_size * 4
    )
    return bytes_moved / HBM_BYTES_PER_S * 1e3


def _time_ms(fn, dev, repeats: int) -> float:
    """Median milliseconds of ``fn()``: CUDA events on the card, the host
    clock on the CPU; three warm-up calls first."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def kernels(n: int = 100_000, e: int = 800_000, tile_size: int = 1024, repeats: int = 30,
            device=None) -> List[Dict[str, Any]]:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(0, n, e).astype(np.int32), device=dev)
    dst = torch.as_tensor(rng.integers(0, n, e).astype(np.int32), device=dev)
    common.sync(dev)
    t0 = time.perf_counter()
    tiling = bucket_edges_by_tile(src, dst, n, tile_size=tile_size)
    common.sync(dev)
    t_shuffle = time.perf_counter() - t0
    w = torch.ones(e, dtype=torch.float32, device=dev)

    def kernel():
        return tiled_degrees(tiling, w, n_nodes=n)

    def plain():
        return degrees_from_tiled(tiled_degrees_ref(tiling, w), n)

    def library():
        return torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
            0, src, w).index_add_(0, dst, w)

    equal = bool(torch.equal(kernel(), plain()) and torch.equal(kernel(), library()))
    launches0 = tiled_degrees.launches
    kernel_ms = _time_ms(kernel, dev, repeats)
    return [{
        "kernel": "peel_degree (K1)",
        "nodes": n,
        "edge_slots": int(tiling.n_slots),
        "timer": "cuda events" if dev.type == "cuda" else "host clock",
        "one_time_shuffle_s": round(t_shuffle, 4),
        "kernel_us_per_pass": round(kernel_ms * 1e3, 2),
        "kernel_launches": tiled_degrees.launches - launches0,
        "plain_us_per_pass": round(_time_ms(plain, dev, repeats) * 1e3, 2),
        "index_add_us_per_pass": round(_time_ms(library, dev, repeats) * 1e3, 2),
        "bound_us": round(kernel_bound_ms(tiling, e) * 1e3, 2),
        "equal_to_plain_and_index_add": equal,
    }]


def lemma5(k_values=(4, 5, 6, 7), device=None) -> List[Dict[str, Any]]:
    """Lemma 5 lower-bound instances: measured passes must grow with k."""
    dev = resolve_device(device)
    rows = []
    for k in k_values:
        edges = gen.lemma5_instance(k, device=dev)
        res = densest_subgraph(edges, eps=0.05, track_history=False)
        rows.append({
            "k": k,
            "n": edges.n_nodes,
            "m": int(edges.num_real_edges()),
            "passes": int(res.passes),
            "k_over_logk": round(float(k / np.log2(max(k, 2))), 2),
        })
    ps = [r["passes"] for r in rows]
    assert all(b >= a for a, b in zip(ps, ps[1:])), ps
    return rows


ALL = {
    "table2": table2,
    "fig61": fig61,
    "fig62_63": fig62_63,
    "table3": table3,
    "fig64_66": fig64_66,
    "table4": table4,
    "fig67": fig67,
    "lemma5": lemma5,
    "kernels": kernels,
}
