"""Production mesh construction (counterpart of ``repro.launch.mesh``).

The reference forces 512 placeholder host devices (``XLA_FLAGS``, set
before JAX starts) so that one CPU can lower the (2, 16, 16) production
mesh.  The port's counterpart is a *fake* process group
(``torch.testing._internal.distributed.fake_pg``): a world of 256 or 512
ranks in which this process is rank 0 and no collective moves data.
:func:`make_production_mesh` starts that world and returns its
:class:`~torch.distributed.device_mesh.DeviceMesh`; the dry-run traces
each step on it under ``FakeTensorMode``, so nothing is allocated.

A process holds one ``torch.distributed`` world.  The port's
``core/mapreduce.py::make_mesh`` starts a real gloo or NCCL world, and a
fake world cannot sit beside it; nor can the single-pod and multi-pod
worlds (256 and 512 ranks) share a process.  So the dry-run runs each
mesh flavor in a process of its own, as the reference's ``XLA_FLAGS``
line forces a process per device count.  Importing this module touches
no process group.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_world(world_size: int) -> None:
    """Starts a fake world of ``world_size`` ranks (this process rank 0),
    or checks that the running world is such a world."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"this process already runs a {dist.get_backend()!r} world of "
                f"{dist.get_world_size()} ranks; a {world_size}-rank dry-run mesh needs a "
                "process of its own (see the module docstring)")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of a fake world (started here if none runs).  Its
    device type is ``cpu``: the dry-run's fake tensors are CPU tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    n = int(np.prod(shape))
    start_fake_world(n)
    return init_device_mesh("cpu", tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod:
    (pod=2, data=16, model=16) = 512."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure-DP axes of a production mesh ('pod'+'data' when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)
