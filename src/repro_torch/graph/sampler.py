"""Layered (fanout) neighbor sampler, GraphSAGE's own minibatch scheme
(counterpart of ``repro.graph.sampler``).

A sampler over a CSR adjacency: without replacement (a random order of all
neighbors) when the degree is at most the fanout, uniform with replacement
above it; an isolated node samples itself, masked out.  Deterministic per
(seed, step), so the pipeline is resumable, and the hop arrays have the
static shapes of the ``minibatch_lg`` cell.

The sampling is host numpy with the reference's generator and call order
(``numpy.random.default_rng((seed << 20) ^ step)``), so every hop array
and mask equals the reference's bit for bit on the same CSR.  Only the
CSR's build differs: :meth:`CSRGraph.from_edges` sorts on a torch device
(the card by default), with the same stable order and so the same arrays.

Output layout matches ``models/gnn/graphsage.forward_sampled``:
  hop0 [R], hop1 [R, f1], hop2 [R, f1, f2] (+ masks), labels [R].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.graph.edgelist import Device, resolve_device


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # int64[N+1]
    indices: np.ndarray  # int32[nnz]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @staticmethod
    def from_edges(src, dst, n_nodes: int, device: Device = None) -> "CSRGraph":
        """The symmetrized adjacency of ``src -> dst`` (host arrays or
        tensors): both directions, each node's neighbors in the order of a
        stable sort of the sources, as the reference's ``np.argsort(...,
        kind='stable')`` leaves them.  The sort runs on ``device`` (default:
        the card); the CSR is copied to the host."""
        dev = resolve_device(device)

        def ids(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            return t.to(dev, torch.int32)

        src, dst = ids(src), ids(dst)
        s = torch.cat([src, dst])
        d = torch.cat([dst, src])
        del src, dst
        s_sorted, order = torch.sort(s, stable=True)
        indices = d[order]
        del d, order
        counts = torch.bincount(s_sorted, minlength=n_nodes)
        del s_sorted, s
        indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
        torch.cumsum(counts, 0, out=indptr[1:])
        return CSRGraph(indptr.cpu().numpy(), indices.cpu().numpy())


def _sample_neighbors(
    g: CSRGraph, nodes: np.ndarray, fanout: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """(neigh int32[len(nodes), fanout], mask float32[...]) per node."""
    n = len(nodes)
    out = np.zeros((n, fanout), np.int32)
    mask = np.zeros((n, fanout), np.float32)
    starts = g.indptr[nodes]
    degs = g.indptr[nodes + 1] - starts
    for i in range(n):
        deg = int(degs[i])
        if deg == 0:
            out[i, :] = nodes[i]  # self-loop, masked out
            continue
        s = int(starts[i])
        if deg <= fanout:
            idx = rng.permutation(deg)
            take = g.indices[s : s + deg][idx]
            out[i, : len(take)] = take
            mask[i, : len(take)] = 1.0
        else:
            sel = rng.integers(0, deg, fanout)
            out[i] = g.indices[s + sel]
            mask[i] = 1.0
    return out, mask


class LayeredSampler:
    """Resumable minibatch sampler: (seed, step) -> hop block (host numpy)."""

    def __init__(
        self,
        graph: CSRGraph,
        labels: np.ndarray,
        batch_nodes: int,
        fanout: Tuple[int, int],
        seed: int = 0,
    ):
        self.g = graph
        self.labels = labels
        self.batch_nodes = batch_nodes
        self.fanout = fanout
        self.seed = seed
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        self.step += 1
        f1, f2 = self.fanout
        roots = rng.integers(0, self.g.n_nodes, self.batch_nodes).astype(np.int32)
        hop1, m1 = _sample_neighbors(self.g, roots, f1, rng)
        hop2, m2 = _sample_neighbors(self.g, hop1.reshape(-1), f2, rng)
        return {
            "hop0": roots,
            "hop1": hop1,
            "hop2": hop2.reshape(self.batch_nodes, f1, f2),
            "hop1_mask": m1,
            "hop2_mask": (
                m2.reshape(self.batch_nodes, f1, f2) * m1[:, :, None]
            ).astype(np.float32),
            "labels": self.labels[roots].astype(np.int32),
        }

    def checkpoint_state(self):
        return {"seed": self.seed, "step": self.step}

    def restore(self, state):
        self.seed = int(state["seed"])
        self.step = int(state["step"])
