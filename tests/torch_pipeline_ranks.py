"""One rank of the port's pipeline check (tests/test_torch_pipeline.py).

    python tests/torch_pipeline_ranks.py RANK WORLD DIR

Joins a gloo world of WORLD processes through a file store in DIR (60 s
timeouts), runs ``pipelined_apply`` over a 1-D mesh ("pod",) of WORLD
stages on the weights and microbatches in ``DIR/inputs.npz`` (f32), then
the gradient of the mean square of its output, and writes the output and
this rank's gradient (its stage's slice, zeros elsewhere) to
``DIR/rank<RANK>.npz``.  It imports the port, numpy and torch, never JAX.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.sharding.pipeline import pipelined_apply  # noqa: E402


def stage_fn(w, h):
    return torch.tanh(h @ w)


def main() -> int:
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    data = np.load(os.path.join(tmp, "inputs.npz"))
    w = torch.from_numpy(data["w"]).requires_grad_()
    x = torch.from_numpy(data["x"])
    out = pipelined_apply(mesh, "pod", stage_fn, w, x)
    (out ** 2).mean().backward()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), out=out.detach().numpy(),
             grad=w.grad.numpy())
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
