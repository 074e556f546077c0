"""One rank of the port's multi-rank mesh checks (tests/test_torch_mapreduce.py).

    python tests/torch_mesh_ranks.py RANK WORLD DIR

Joins a gloo world of WORLD processes through a file store in DIR (every
process group with a 60 s timeout), builds a 4-rank mesh over ``("data",)``
and a 2×2 mesh over ``("data", "model")``, solves every case of
:data:`CASES` on the graphs in ``DIR/graphs.npz`` plus the golden
fixture's mesh cases, and pickles the answers, with the collectives each
case launched, to ``DIR/rank<RANK>.pkl``.  It imports the port, numpy and
the golden script, never JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, os.path.join(REPO, "scripts"))

TIMEOUT = datetime.timedelta(seconds=60)
LADDER_MIN_EDGES = 64  # multi-rung ladders on these few-thousand-edge graphs
OUTCOME = ("best_alive", "best_t", "best_density", "best_size", "alive", "t_alive",
           "history_n", "history_m", "history_rho")

# case -> (graph, mesh, edge_axes, what runs, its keyword arguments)
CASES = {
    "uneven.geometric": ("uneven", "m4", ("data",), "undirected",
                         dict(eps=0.2, compaction="geometric")),
    "uneven.off": ("uneven", "m4", ("data",), "undirected", dict(eps=0.2, compaction="off")),
    "uneven.twophase": ("uneven", "m4", ("data",), "undirected",
                        dict(eps=0.2, compaction="twophase", twophase_passes=2)),
    "one_shard.geometric": ("one_shard", "m4", ("data",), "undirected",
                            dict(eps=0.1, compaction="geometric")),
    "permuted.geometric": ("permuted", "m4", ("data",), "undirected",
                           dict(eps=0.1, compaction="geometric")),
    "uneven.geometric.2x2": ("uneven", "m22", ("data", "model"), "undirected",
                             dict(eps=0.2, compaction="geometric")),
    "uneven.geometric.2x2_model_data": ("uneven", "m22", ("model", "data"), "undirected",
                                        dict(eps=0.2, compaction="geometric")),
    "uneven.off.2x2_data": ("uneven", "m22", ("data",), "undirected",
                            dict(eps=0.2, compaction="off")),
    "uneven.at_least_k.geometric": ("uneven", "m4", ("data",), "at_least_k",
                                    dict(k=30, eps=0.5, compaction="geometric")),
    "uneven.sketch": ("uneven", "m4", ("data",), "undirected",
                      dict(eps=0.5, backend="sketch", sketch_buckets=256)),
    "directed.c4.off": ("directed", "m4", ("data",), "directed",
                        dict(c=4.0, eps=0.5, compaction="off")),
    "directed.grid.geometric": ("directed", "m4", ("data",), "directed",
                                dict(c=None, eps=0.5, compaction="geometric")),
    "builder.peel": ("uneven", "m4", ("data",), "make_distributed_peel", dict(eps=0.2)),
    "builder.ladder": ("uneven", "m4", ("data",), "make_distributed_peel_ladder",
                       dict(eps=0.2)),
    "builder.twophase": ("twophase", "m4", ("data",), "make_distributed_peel_twophase",
                         dict(eps=0.5, phase1_passes=3)),
    "builder.topk": ("topk", "m4", ("data",), "make_distributed_topk_peel",
                     dict(k=30, eps=0.5)),
    "builder.directed": ("directed", "m4", ("data",), "make_distributed_directed_peel",
                         dict(eps=0.5)),
    "builder.sketched": ("uneven", "m4", ("data",), "make_distributed_sketched_peel",
                         dict(eps=0.5, b=256)),
}
BUILDER_DIRECTED_C = 1.0


def _host(out) -> dict:
    got = {f: getattr(out, f).cpu().numpy() for f in OUTCOME if hasattr(out, f)}
    got["passes"] = out.passes
    extras = getattr(out, "extras", None) or {}
    got["extras"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in extras.items()}
    return got


def run_case(name, graphs, meshes) -> dict:
    from repro_torch.core import Problem, mapreduce, solve

    gname, mesh_name, axes, what, kw = CASES[name]
    edges = graphs[gname]
    mesh = meshes[mesh_name]
    if what in ("undirected", "at_least_k", "directed"):
        prob = getattr(Problem, what)(substrate="mesh", edge_axes=axes, track_history=True,
                                      **kw)
        return _host(solve(edges, prob, mesh=mesh))
    sh = mapreduce.shard_edges(edges, mesh, axes)
    n = edges.n_nodes
    if what == "make_distributed_peel_ladder":
        run = mapreduce.make_distributed_peel_ladder(mesh, axes, n_nodes=n,
                                                     m_edges=edges.n_edges_padded, **kw)
        sh = mapreduce.shard_edges(edges.with_padding(run.n_edge_slots), mesh, axes)
        got = _host(run(sh.src, sh.dst, sh.weight, sh.mask))
        got["schedule"] = list(run.schedule)
        return got
    fn = getattr(mapreduce, what)(mesh, axes, n_nodes=n, **kw)
    args = (sh.src, sh.dst, sh.weight, sh.mask)
    if what == "make_distributed_directed_peel":
        s, t, rho, passes = fn(*args, BUILDER_DIRECTED_C)
        return {"best_alive": s.numpy(), "best_t": t.numpy(), "best_density": rho.numpy(),
                "passes": passes}
    if what == "make_distributed_sketched_peel":
        s, rho, passes = fn(*args)
        return {"best_alive": s.numpy(), "best_density": rho.numpy(), "passes": passes}
    return _host(fn(*args))


def main() -> int:
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch_port_golden as golden

    import repro_torch.core.api as api
    from repro_torch import collectives, hostsync
    from repro_torch.core import mapreduce
    from repro_torch.graph.edgelist import from_reference

    mapreduce.GROUP_TIMEOUT = TIMEOUT
    api._LADDER_MIN_EDGES = LADDER_MIN_EDGES
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        meshes = {"m4": mapreduce.make_mesh((4,), ("data",), device="cpu"),
                  "m22": mapreduce.make_mesh((2, 2), ("data", "model"), device="cpu")}
        data = np.load(os.path.join(tmp, "graphs.npz"))
        graphs = {}
        for g in {c[0] for c in CASES.values()}:
            graphs[g] = from_reference(
                data[f"{g}.src"], data[f"{g}.dst"], data[f"{g}.weight"], data[f"{g}.mask"],
                int(data[f"{g}.n_nodes"]), bool(data[f"{g}.directed"]), "cpu")
        results = {"rank": rank, "cases": {}, "golden": {}}
        for name in CASES:
            collectives.reset()
            hostsync.read.count = 0
            got = run_case(name, graphs, meshes)
            got["collectives"] = {
                "all_reduce": collectives.all_reduce.count,
                "all_reduce_bytes": collectives.all_reduce.bytes,
                "all_gather": collectives.all_gather.count,
                "all_gather_bytes": collectives.all_gather.bytes,
                "host_syncs": hostsync.read.count,
            }
            results["cases"][name] = got
        api._LADDER_MIN_EDGES = api.constants.LADDER_MIN_EDGES
        for case in golden.MESH_CASES:
            results["golden"][case] = golden.port_mesh_entry(case, meshes["m4"], "cpu")
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
