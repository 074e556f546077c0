"""Edge-list graph container of the port (counterpart of ``repro.graph.edgelist``).

Flat ``src``/``dst``/``weight`` tensors with an explicit padding ``mask``,
all on one explicit device.  ``n_nodes`` and ``directed`` are plain Python
values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

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
    key = src * (dst.max(initial=0) + 1) + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx].astype(np.int32), dst[idx].astype(np.int32)
