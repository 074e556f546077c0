"""One rank of the port's 4-rank tiled neighbor sum check
(tests/test_torch_dist_gnn.py).

    python tests/torch_dist_gnn_ranks.py RANK WORLD DIR

Joins a gloo world of WORLD processes through a file store in DIR (60 s
timeouts), builds a WORLD-rank mesh over ``("d",)`` and a 2 x 2 mesh over
``("data", "model")`` with the edges tiled over ``("model", "data")`` (a
block order that is not the ranks'), and for each case of
``DIR/inputs.npz`` runs ``make_tiled_neighbor_sum`` on this rank's tile:
its output, and the gradients of ``sum(Z * probe)`` with respect to the
tile and the edge weights.  Pickles them, with the collectives made, to
``DIR/rank<RANK>.pkl``.  Imports the port and numpy, never JAX.
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

TIMEOUT = datetime.timedelta(seconds=60)
# case -> (mesh, edge axes)
MESHES = {"d4": ("m4", ("d",)), "model_data": ("m22", ("model", "data"))}


def main() -> int:
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch import collectives
    from repro_torch.core import mapreduce
    from repro_torch.core.mapreduce import edge_shards
    from repro_torch.models.gnn.dist import build_edge_tiling, make_tiled_neighbor_sum

    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    meshes = {"m4": mapreduce.make_mesh((world,), ("d",), device="cpu"),
              "m22": mapreduce.make_mesh((2, 2), ("data", "model"), device="cpu")}
    data = np.load(os.path.join(tmp, "inputs.npz"))
    out = {}
    for case, (mesh_name, axes) in MESHES.items():
        src, dst, n = data["src"], data["dst"], int(data["n"])
        tiling = build_edge_tiling(src, dst, n, world)
        f = make_tiled_neighbor_sum(tiling, meshes[mesh_name], axes)
        block = edge_shards(meshes[mesh_name], axes).index
        rows = slice(block * tiling.tile_n, (block + 1) * tiling.tile_n)
        x = torch.from_numpy(data["x"][rows].copy()).requires_grad_()
        w = torch.from_numpy(data["w"].copy()).requires_grad_()
        collectives.reset()
        z = f(x, w)
        (z * torch.from_numpy(data["probe"][rows].copy())).sum().backward()
        out[case] = {"block": block, "z": z.detach().numpy(), "dx": x.grad.numpy(),
                     "dw": w.grad.numpy(), "all_gather": collectives.all_gather.count,
                     "all_reduce": collectives.all_reduce.count}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    dist.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
