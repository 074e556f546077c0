"""Edge-list graph container of the port (counterpart of ``repro.graph.edgelist``).

Flat ``src``/``dst``/``weight`` tensors with an explicit padding ``mask``,
all on one explicit device.  ``n_nodes`` and ``directed`` are plain Python
values.

Also the streaming substrate's out-of-core edge stores, host numpy in the
reference's on-disk formats (either package opens what the other wrote):
``save_edges_memmap``/``open_edges_memmap`` and the spill ladder's
``EdgeSpillWriter``/``open_edge_spill``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import faults
from repro_torch.ioutil import atomic_write_file

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """The port's device rule: an explicit ``device`` is used as given;
    ``None`` means the card, and raises when there is none.  Nothing falls
    back to the CPU unless the caller asks for ``device='cpu'``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (its kernels then use their plain PyTorch versions)"
        )
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """A (possibly weighted, possibly padded) edge list.

    Attributes:
      src: int32[E] source node ids (undirected graphs store each edge once).
      dst: int32[E] destination node ids.
      weight: float32[E] edge weights (1.0 for unweighted graphs).
      mask: bool[E] True for real edges, False for padding.
      n_nodes: number of nodes.
      directed: undirected edges are stored once and counted for both
        endpoints' degrees.
    """

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor
    n_nodes: int
    directed: bool = False

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_edges_padded(self) -> int:
        return self.src.shape[0]

    def num_real_edges(self) -> torch.Tensor:
        return self.mask.sum()

    def to(self, device: Device) -> "EdgeList":
        """The same graph on ``device`` (one copy per array; none where the
        arrays already lie there)."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, src=self.src.to(dev), dst=self.dst.to(dev),
            weight=self.weight.to(dev), mask=self.mask.to(dev),
        )

    def with_padding(self, multiple: int) -> "EdgeList":
        """Pads the edge arrays so E is a multiple of ``multiple``."""
        pad = (-self.src.shape[0]) % multiple
        if pad == 0:
            return self
        dev = self.device

        def cat(a, dtype):
            return torch.cat([a, torch.zeros(pad, dtype=dtype, device=dev)])

        return EdgeList(
            src=cat(self.src, torch.int32),
            dst=cat(self.dst, torch.int32),
            weight=cat(self.weight, torch.float32),
            mask=cat(self.mask, torch.bool),
            n_nodes=self.n_nodes,
            directed=self.directed,
        )


def from_numpy(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    *,
    weight: Optional[np.ndarray] = None,
    directed: bool = False,
    device: Device = None,
) -> EdgeList:
    """Host arrays -> an :class:`EdgeList` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if weight is None:
        weight = np.ones_like(src, np.float32)
    return from_reference(
        src, dst, weight, np.ones_like(src, bool), n_nodes, directed, dev
    )


def from_reference(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    mask: np.ndarray,
    n_nodes: int,
    directed: bool,
    device: Device,
) -> EdgeList:
    """The reference's edge arrays (as numpy) -> the port's graph on
    ``device``: the state carried across between the two packages."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return EdgeList(
        src=t(src, np.int32),
        dst=t(dst, np.int32),
        weight=t(weight, np.float32),
        mask=t(mask, bool),
        n_nodes=int(n_nodes),
        directed=bool(directed),
    )


def apply_updates(
    edges: EdgeList,
    inserts: Optional[np.ndarray] = None,
    deletes: Optional[np.ndarray] = None,
) -> Tuple[EdgeList, dict]:
    """Host-side exact reference for one turnstile update batch (the
    reference's ``apply_updates``, the same semantics and stats).

    Applies ``deletes`` then ``inserts`` to the undirected edge SET of
    ``edges`` and returns ``(new_edges, stats)`` on ``edges.device``:
    surviving edges keep their stream order, inserted edges are appended in
    batch order with weight 1.0, and the result is unpadded.

    * endpoint order is ignored for matching;
    * deleting an edge that is not live is a no-op, counted in
      ``stats['missing_deletes']``;
    * inserting a live edge is a no-op, counted in ``stats['dup_inserts']``;
    * duplicates within one batch collapse to the first, counted the same;
    * a batch that inserts and deletes the same edge raises.

    ``inserts``/``deletes`` are (k, 2) int arrays (or None).
    """
    ins = np.asarray(inserts if inserts is not None else np.zeros((0, 2)), np.int64)
    del_ = np.asarray(deletes if deletes is not None else np.zeros((0, 2)), np.int64)
    if ins.ndim != 2 or ins.shape[1] != 2 or del_.ndim != 2 or del_.shape[1] != 2:
        raise ValueError("inserts/deletes must be (k, 2) edge arrays")
    if edges.directed:
        raise ValueError("apply_updates models undirected turnstile streams")
    mask = edges.mask.cpu().numpy()
    src = edges.src.cpu().numpy().astype(np.int64)[mask]
    dst = edges.dst.cpu().numpy().astype(np.int64)[mask]
    w = edges.weight.cpu().numpy()[mask]
    n = int(edges.n_nodes)

    def keys(a, b):
        return np.minimum(a, b) * n + np.maximum(a, b)

    live = keys(src, dst)
    dk_all = keys(del_[:, 0], del_[:, 1])
    ik_all = keys(ins[:, 0], ins[:, 1])
    dk, _ = np.unique(dk_all, return_index=True)
    ik, i_first = np.unique(ik_all, return_index=True)
    both = np.intersect1d(dk, ik)
    if len(both):
        raise ValueError(
            "a batch must not insert and delete the same edge (deletes "
            f"apply first, making the order ambiguous): {len(both)} overlap"
        )
    stats = {
        "dup_inserts": int(len(ik_all) - len(ik)),
        "missing_deletes": int(len(dk_all) - len(dk)),
    }
    hit = np.isin(live, dk)
    stats["deleted"] = int(hit.sum())
    stats["missing_deletes"] += int(len(dk) - hit.sum())
    src, dst, w, live = src[~hit], dst[~hit], w[~hit], live[~hit]
    fresh = ~np.isin(ik, live)
    stats["dup_inserts"] += int(len(ik) - fresh.sum())
    stats["inserted"] = int(fresh.sum())
    keep = np.sort(i_first[fresh])  # batch order, not key order
    src = np.concatenate([src, ins[keep, 0]])
    dst = np.concatenate([dst, ins[keep, 1]])
    w = np.concatenate([w, np.ones(len(keep), np.float32)])
    out = from_reference(src, dst, w, np.ones(len(src), bool), n, False, edges.device)
    return out, stats


def dedup_edges(
    src: np.ndarray, dst: np.ndarray, *, directed: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Removes self loops and duplicate edges (numpy, host side)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if not directed:
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        src, dst = lo, hi
    # The reference keeps each key's first edge (``np.unique`` with
    # ``return_index``, a stable argsort); the key is the edge itself, so
    # the sorted distinct keys give the same arrays.  An in-place sort, not
    # ``np.unique``: newer numpy finds unique values through a hash table,
    # which is slower at tens of millions of edges.
    base = dst.max(initial=0) + 1
    key = src * base + dst
    key.sort()
    key = key[np.diff(key, prepend=-1) != 0]  # ids are >= 0: the first is kept
    return (key // base).astype(np.int32), (key % base).astype(np.int32)


# ---------------------------------------------------------------------------
# Out-of-core edge stores (the streaming substrate's disk-resident graphs)
# ---------------------------------------------------------------------------

_STORE_ARRAYS = ("src", "dst", "weight")


def save_edges_memmap(
    store_dir: str,
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray] = None,
) -> str:
    """Writes an on-disk edge store: ``src.npy``/``dst.npy``/``weight.npy``
    through ``np.lib.format.open_memmap`` (self-describing dtype and shape,
    no manifest).  Pair with
    :func:`repro_torch.core.streaming.chunked_from_memmap` for a chunk
    stream whose edges never enter host RAM whole."""
    os.makedirs(store_dir, exist_ok=True)
    if weight is None:
        weight = np.ones(len(src), np.float32)
    arrays = (np.asarray(src, np.int32), np.asarray(dst, np.int32), np.asarray(weight))
    for name, arr in zip(_STORE_ARRAYS, arrays):
        mm = np.lib.format.open_memmap(
            os.path.join(store_dir, f"{name}.npy"), mode="w+", dtype=arr.dtype,
            shape=arr.shape,
        )
        mm[:] = arr
        mm.flush()
        del mm
    return store_dir


def open_edges_memmap(store_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read-mode memmaps ``(src, dst, weight)`` of an edge store written by
    :func:`save_edges_memmap`: slicing reads only the touched pages."""
    return tuple(
        np.load(os.path.join(store_dir, f"{name}.npy"), mmap_mode="r")
        for name in _STORE_ARRAYS
    )


class EdgeSpillWriter:
    """Append-only on-disk edge store with an atomic manifest.

    The streaming ladder spills a rebuilt survivor stream through this:
    raw ``src.bin``/``dst.bin``/``w.bin`` files are appended chunk by chunk
    (O(chunk) host memory), then :meth:`finalize` publishes
    ``manifest.json`` atomically.  A crash mid-spill leaves no manifest,
    and resume ignores the partial spill."""

    def __init__(self, spill_dir: str, w_dtype):
        os.makedirs(spill_dir, exist_ok=True)
        self.dir = spill_dir
        self.w_dtype = np.dtype(w_dtype)
        self._files = {
            name: open(os.path.join(spill_dir, f"{name}.bin"), "wb")
            for name in ("src", "dst", "w")
        }
        self.n_slots = 0

    def append(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> None:
        if not (len(src) == len(dst) == len(w)):
            raise ValueError("spill chunk arrays must have equal length")
        np.asarray(src, np.int32).tofile(self._files["src"])
        np.asarray(dst, np.int32).tofile(self._files["dst"])
        np.asarray(w, self.w_dtype).tofile(self._files["w"])
        self.n_slots += len(src)

    def close(self) -> None:
        for f in self._files.values():
            if not f.closed:
                f.close()

    def abort(self) -> None:
        """Failure path: close the files and drop the partial spill
        directory (nothing was published, so nothing resumes from it)."""
        self.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    def finalize(self, **meta) -> dict:
        """Flushes and fsyncs the data files, then publishes the manifest
        atomically (``meta`` keys ride along, then ``n_slots`` and
        ``w_dtype`` as ``np.dtype.str``).  Only after this returns does
        :func:`open_edge_spill` see the spill."""
        # Chaos hook: a publish failure must leave no manifest (the caller
        # aborts the rung; resume ignores unfinalized spills).
        faults.fire("edgelist.spill_publish")
        for f in self._files.values():
            f.flush()
            os.fsync(f.fileno())
            f.close()
        manifest = dict(meta)
        manifest["n_slots"] = int(self.n_slots)
        manifest["w_dtype"] = self.w_dtype.str
        atomic_write_file(
            os.path.join(self.dir, "manifest.json"),
            lambda f: json.dump(manifest, f),
            mode="w",
            suffix=".json.tmp",
        )
        return manifest


def open_edge_spill(spill_dir: str):
    """Opens a finalized spill: ``(src, dst, w, manifest)`` with the arrays
    as read-mode memmaps, or None when there is no manifest (unfinalized or
    absent, e.g. a spill interrupted mid-write)."""
    man_path = os.path.join(spill_dir, "manifest.json")
    if not os.path.exists(man_path):
        return None
    with open(man_path) as f:
        manifest = json.load(f)
    n = int(manifest["n_slots"])

    def mm(name, dtype):
        if n == 0:
            return np.zeros(0, dtype)
        return np.memmap(os.path.join(spill_dir, f"{name}.bin"), dtype=dtype, mode="r",
                         shape=(n,))

    return (mm("src", np.int32), mm("dst", np.int32),
            mm("w", np.dtype(manifest["w_dtype"])), manifest)


def to_csr(edges: EdgeList, return_weights: bool = False):
    """Host-side CSR ``(indptr, indices[, weights])`` over the symmetrized
    adjacency (directed graphs: the out-adjacency), as numpy arrays, in the
    reference's order: a stable sort by source, each undirected edge listed
    under both endpoints.  ``return_weights`` adds each slot's weight.

    The sort runs where the graph lies (on the card for a device graph:
    a stable sort of 128M ids at livejournal_md's scale takes
    milliseconds there and seconds in numpy); the three arrays then come
    to the host in one copy each."""
    m = edges.mask
    src, dst, w = edges.src[m], edges.dst[m], edges.weight[m]
    if edges.directed:
        s, d, ww = src, dst, w
    else:
        s, d, ww = torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([w, w])
    s_sorted, order = torch.sort(s, stable=True)
    # indptr[i] = the number of slots whose source is below i.
    bounds = torch.arange(edges.n_nodes + 1, dtype=s.dtype, device=s.device)
    indptr = torch.searchsorted(s_sorted, bounds).cpu().numpy()
    indices = d[order].to(torch.int32).cpu().numpy()
    if return_weights:
        return indptr, indices, ww[order].cpu().numpy()
    return indptr, indices
