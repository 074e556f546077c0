"""Fault-tolerant checkpoints (counterpart of ``repro.checkpoint.manager``),
on numpy's ``.npz`` and a JSON manifest.

  * ATOMIC: written into ``<dir>/tmp.<step>.<pid>/``, then published as
    ``step_<n>/`` by ``ioutil.atomic_publish`` (fsync, ``os.replace``), so
    a preempted writer never corrupts the latest checkpoint;
  * DEVICE-INDEPENDENT: every leaf is saved as a full host array, and a
    restore puts each on the device asked for (or its ``like`` leaf's);
  * ASYNC: ``save_async`` copies the state to host memory now and writes it
    in a daemon thread; ``join()`` waits and re-raises a writer's error;
  * KEEP-K: older checkpoints are removed after a successful save;
  * SELF-DESCRIBING: ``manifest.json`` holds the step, the user metadata
    (the next step, the data cursor) and every leaf's key, shape and dtype.
    A bfloat16 leaf (numpy has no bfloat16) is stored as its uint16 bits,
    the manifest naming ``bfloat16``.  The reference's manifest is msgpack,
    which the card's machine does not have.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import ioutil
from repro_torch import tree as tree_util

_STEP_RE = re.compile(r"^step_(\d+)$")
_MANIFEST = "manifest.json"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (host array, dtype name); bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _snapshot(state):
    """The state with every tensor copied to host memory (a copy even of a
    CPU tensor: the trainer goes on updating the original in place)."""
    return tree_util.tree_map(
        lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, state)


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    metadata: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Synchronous atomic save; returns the final checkpoint path."""
    arrays = {}
    manifest = {"step": int(step), "metadata": metadata or {}, "leaves": []}
    for key, leaf in tree_util.leaves_with_paths(state):
        arr, dtype = _host(leaf)
        arrays[key] = arr
        manifest["leaves"].append({"key": key, "shape": list(arr.shape), "dtype": dtype})

    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    # repro: allow(atomic-io) write lands in tmp.<step>/ — the directory rename below is the publish
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    ioutil.atomic_publish(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    """The published steps in ``directory``, ascending (a ``tmp.*``
    directory never counts)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def _device_leaf(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def restore_checkpoint(
    directory: str,
    step: int,
    like: Any,
    device=None,
) -> Tuple[Any, Dict[str, Any]]:
    """Restores into the structure of ``like``; each leaf goes to ``device``
    or, if None, to the device of its ``like`` leaf."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    dtypes = {leaf["key"]: leaf["dtype"] for leaf in manifest["leaves"]}
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in tree_util.leaves_with_paths(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint {arr.shape} != expected {want}")
            dev = device if device is not None else getattr(leaf, "device", "cpu")
            leaves.append(_device_leaf(arr, dtypes[key], dev))
    return tree_util.unflatten_like(like, leaves), manifest["metadata"]


def restore_latest(directory: str, like: Any, device=None):
    """(state, metadata, step) of the latest checkpoint, or (None, None, -1)."""
    steps = all_steps(directory)
    if not steps:
        return None, None, -1
    state, meta = restore_checkpoint(directory, steps[-1], like, device)
    return state, meta, steps[-1]


@dataclasses.dataclass
class CheckpointManager:
    """Async keep-k checkpointer with a join()-able writer thread."""

    directory: str
    keep: int = 3
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def save_async(self, step: int, state: Any, metadata=None):
        """Snapshot to host memory now, write in the background."""
        self.join()
        host_state = _snapshot(state)

        def _write():
            try:
                save_checkpoint(self.directory, step, host_state, metadata, keep=self.keep)
            except BaseException as e:  # surfaced on the next join()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save(self, step: int, state: Any, metadata=None):
        self.join()
        return save_checkpoint(self.directory, step, state, metadata, keep=self.keep)

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> int:
        steps = all_steps(self.directory)
        return steps[-1] if steps else -1
