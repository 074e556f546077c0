"""Andersen-style local exploration, the ``substrate='local'`` extraction
(counterpart of ``repro.core.local``, ported line for line: the order of
admission, and so every candidate set, is the reference's).

Per-seed densest-subgraph queries should not pay for the whole graph, or
even for a whole BFS ball whose size is governed by tuning knobs
(``radius``, ``max_ego_nodes``) rather than by theory.  Andersen's local
algorithm (arXiv cs/0702078, PAPERS.md) grows a candidate set around the
seed through PRUNED frontier rounds: a frontier vertex is admitted only
if its degree into the current candidate set T clears a threshold tied
to T's density, so the expansion follows the dense core around the seed
instead of the raw neighborhood ball, and a hard ``budget`` caps |T|.
Per-query work is O(rounds × vol(T)) — bounded by the budget and the
candidate degrees, independent of n.

The pruning rule (the reference's extraction contract):

  * each round's frontier is every vertex adjacent to T but outside it;
  * a frontier vertex u is admitted iff ``deg_T(u) >= max(alpha *
    rho(T), 1)`` where ``rho(T)`` is T's internal edge density — with
    ``alpha=1`` a vertex is admitted exactly when adding it cannot
    dilute the density ((w+d)/(s+1) >= w/s iff d >= w/s);
  * when admissions would exceed the budget, the strongest ties into T
    win, lowest id on ties (deterministic truncation);
  * total scan work is capped at ``budget * volume_factor`` CSR slots,
    enforced at ADMISSION in the same deterministic order: a vertex
    whose row does not fit in the remaining work budget is not admitted
    (so a power-law hub one hop from the seed cannot blow the per-query
    cost — its row is never scanned, and pruning keeps expanding through
    the vertices that do fit);
  * exploration stops when the pruned frontier is empty
    (``frontier_exhausted``), the budget or volume cap is reached, or
    ``max_rounds`` rounds have run.

Each admitted vertex's CSR row is scanned exactly ONCE (degrees into T
are maintained incrementally), so the total edge work equals vol(T),
itself <= budget * volume_factor by the admission rule — the counters
on :class:`LocalExploration` report it.

The candidate set then feeds the SAME engine pass body as every other
substrate: :func:`induced_padded` relabels the induced subgraph into the
serving layer's pow2 (node, edge) buckets (bit-identical to
``serve/densest.py`` extraction, which delegates here), and the peel of
that buffer is an ordinary solve on the graph's device — see
``Solver._solve_local`` (core/api.py) and ``DensestQueryEngine``
(serve/densest.py).

What guarantee survives: the peel returns a genuine subgraph of the
input graph, so its density NEVER exceeds the exact optimum, and it is a
(2+2eps)-approximation of the densest subgraph INSIDE the candidate set
(for BFS extraction the same statement holds with "radius-r ego-net" in
place of "candidate set").  The whole-graph (2+2eps) guarantee does not
survive locality — no algorithm touching O(budget) vertices can promise
it — which is why tests/test_torch_serve_densest.py pins exactly the
envelope above, per extraction mode, against the exact oracle.

Host numpy, as in the reference: this module is host-side extraction.
:func:`induced_padded` returns its buffer as CPU tensors over the numpy
arrays (``torch.from_numpy``, no copy); the caller moves it to the card
once, per solve in the front door and per stacked group in the engine.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Optional, Tuple

import numpy as np

import torch

from repro_torch import constants
from repro_torch.graph.edgelist import EdgeList, to_csr
from repro_torch.graph.partition import pow2_bucket

__all__ = [
    "LocalExploration",
    "LocalExplorer",
    "adjacency_rows",
    "check_count",
    "check_seed",
    "induced_padded",
]

# Aliased from the one constants surface (repro_torch.constants): exploration
# budget/round defaults shared by the api front door and the serving engine.
_LOCAL_BUDGET = constants.LOCAL_BUDGET
_LOCAL_ROUNDS = constants.LOCAL_ROUNDS
_LOCAL_VOLUME_FACTOR = constants.LOCAL_VOLUME_FACTOR
_NODE_FLOOR = constants.SERVE_NODE_FLOOR
_EDGE_FLOOR = constants.SERVE_EDGE_FLOOR


def check_seed(seed, n_nodes: int) -> int:
    """Strict seed validation shared by the api front door and the serving
    engine's ``submit`` (the admission contract): a real integer node id in
    ``[0, n_nodes)``.  Bools and non-integral floats are TypeErrors — a
    float seed used to slip past the range check and silently truncate."""
    if isinstance(seed, (bool, np.bool_)):
        raise TypeError("seed must be an integer node id, got bool")
    try:
        s = operator.index(seed)
    except TypeError:
        raise TypeError(
            f"seed must be an integer node id, got {type(seed).__name__}"
        ) from None
    if not 0 <= s < n_nodes:
        raise ValueError(f"seed={s} not in [0, {n_nodes})")
    return s


def check_count(value, name: str, minimum: int = 1) -> int:
    """Strict positive-integer knob validation (radius, budget, rounds)."""
    if isinstance(value, (bool, np.bool_)):
        raise TypeError(f"{name} must be an integer, got bool")
    try:
        v = operator.index(value)
    except TypeError:
        raise TypeError(
            f"{name} must be an integer, got {type(value).__name__}"
        ) from None
    if v < minimum:
        raise ValueError(f"{name}={v} must be >= {minimum}")
    return v


def adjacency_rows(
    indptr: np.ndarray, nodes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated CSR rows of ``nodes``: ``(slot_idx, row_src)`` where
    ``slot_idx`` indexes indices/weights and ``row_src[i]`` is the node
    whose row slot ``i`` came from (vectorized multi-range gather)."""
    starts = indptr[nodes]
    counts = indptr[nodes + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    shift = np.repeat(
        starts - np.concatenate(([0], np.cumsum(counts)[:-1])), counts
    )
    slot_idx = shift + np.arange(total)
    return slot_idx, np.repeat(nodes.astype(np.int64), counts)


def induced_padded(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: Optional[np.ndarray],
    nodes: np.ndarray,
    member: np.ndarray,
    local_id: np.ndarray,
    *,
    node_floor: int = _NODE_FLOOR,
    edge_floor: int = _EDGE_FLOOR,
) -> EdgeList:
    """The induced subgraph of sorted ``nodes`` as a bucket-padded EdgeList:
    THE one extraction body both the serving engine (BFS and local modes)
    and the ``substrate='local'`` front door solve, so every path is
    bit-identical by construction.

    Compact ids follow the sorted order (local id i ↔ ``nodes[i]``; ids >=
    ``len(nodes)`` are isolated pad nodes, removed by the peel in pass 1).
    ``member``/``local_id`` are caller-owned n-length scratch arrays
    (returned reset/ stale respectively).  Buffers stay on the host (CPU
    tensors over numpy arrays): the device transfer happens at solve time,
    amortized across a stacked batch on the serving path."""
    nodes = np.asarray(nodes, np.int64)
    member[nodes] = True
    slot_idx, row_src = adjacency_rows(indptr, nodes)
    dsts = indices[slot_idx].astype(np.int64)
    # Induced edges, each undirected pair once: the symmetrized CSR holds
    # (u,v) and (v,u); src<dst keeps exactly one.
    keep = member[dsts] & (row_src < dsts)
    member[nodes] = False  # reset scratch before any return
    local_id[nodes] = np.arange(len(nodes), dtype=np.int32)
    src_l = local_id[row_src[keep]]
    dst_l = local_id[dsts[keep]]
    if weights is None:
        w = np.ones(len(src_l), np.float32)
    else:
        w = np.asarray(weights[slot_idx[keep]], np.float32)
    m = len(src_l)
    n_b = pow2_bucket(len(nodes), node_floor)
    m_b = pow2_bucket(max(m, 1), edge_floor)
    src_p = np.zeros(m_b, np.int32)
    dst_p = np.zeros(m_b, np.int32)
    w_p = np.zeros(m_b, np.float32)
    msk = np.zeros(m_b, bool)
    src_p[:m] = src_l
    dst_p[:m] = dst_l
    w_p[:m] = w
    msk[:m] = True
    return EdgeList(
        src=torch.from_numpy(src_p),
        dst=torch.from_numpy(dst_p),
        weight=torch.from_numpy(w_p),
        mask=torch.from_numpy(msk),
        n_nodes=int(n_b),
    )


@dataclasses.dataclass(frozen=True)
class LocalExploration:
    """One pruned-frontier exploration's outcome + work counters."""

    seed: int
    candidates: np.ndarray  # sorted original ids, seed included
    rounds: int  # expansion rounds executed
    nodes_touched: int  # distinct vertices examined (candidates + frontier)
    edges_scanned: int  # CSR slots read — the per-query work measure
    frontier_exhausted: bool  # pruning closed the set before the budget


class LocalExplorer:
    """Pruned-frontier exploration over one host CSR (see module docstring
    for the pruning rule).  Build once per graph and reuse across queries:
    the scratch arrays are O(n) but every ``explore`` touches only the
    candidates' neighborhoods.
    """

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        weights: Optional[np.ndarray] = None,
        *,
        n_nodes: Optional[int] = None,
    ):
        self._indptr = np.asarray(indptr, np.int64)
        self._indices = np.asarray(indices)
        self._weights = (
            None if weights is None else np.asarray(weights, np.float32)
        )
        self.n_nodes = int(
            len(self._indptr) - 1 if n_nodes is None else n_nodes
        )
        self._member = np.zeros(self.n_nodes, bool)  # T membership scratch
        self._local_id = np.zeros(self.n_nodes, np.int32)  # relabel scratch
        self._deg_t = np.zeros(self.n_nodes, np.int32)  # deg into T scratch

    @classmethod
    def from_edgelist(cls, graph: EdgeList) -> "LocalExplorer":
        """An explorer over ``graph``'s host CSR (:func:`to_csr` copies a
        device graph to the host once)."""
        if graph.directed:
            raise ValueError(
                "the local exploration is undirected (Andersen's setting); "
                "got a directed graph"
            )
        indptr, indices, w = to_csr(graph, return_weights=True)
        return cls(indptr, indices, w, n_nodes=graph.n_nodes)

    def explore(
        self,
        seed,
        *,
        budget: int = _LOCAL_BUDGET,
        max_rounds: int = _LOCAL_ROUNDS,
        alpha: float = 1.0,
        volume_factor: int = _LOCAL_VOLUME_FACTOR,
    ) -> LocalExploration:
        """Runs the pruned-frontier expansion from ``seed``; deterministic
        for fixed inputs (host numpy, sorted tie-breaks).  Work is capped
        at ``budget * volume_factor`` CSR slots (module docstring)."""
        s = check_seed(seed, self.n_nodes)
        budget = check_count(budget, "budget")
        max_rounds = check_count(max_rounds, "max_rounds")
        vol_cap = budget * check_count(volume_factor, "volume_factor")
        if alpha < 0:
            raise ValueError(f"alpha={alpha} must be >= 0")
        member, deg_t = self._member, self._deg_t
        cand = np.asarray([s], np.int64)
        member[s] = True
        touched_parts = []  # admitted rows' neighbor ids (duplicates kept)
        edges_scanned = 0

        def scan(batch: np.ndarray) -> None:
            # Each admitted vertex's row is scanned exactly once, here:
            # afterwards deg_t[v] == |N(v) ∩ T| for EVERY vertex v.
            nonlocal edges_scanned
            slot_idx, _ = adjacency_rows(self._indptr, batch)
            nb = self._indices[slot_idx].astype(np.int64)
            edges_scanned += int(nb.size)
            if nb.size:
                np.add.at(deg_t, nb, 1)
                touched_parts.append(nb)

        scan(cand)
        rounds = 0
        exhausted = False
        while (
            rounds < max_rounds
            and len(cand) < budget
            and edges_scanned < vol_cap
        ):
            seen = (
                np.unique(np.concatenate(touched_parts))
                if touched_parts
                else np.empty(0, np.int64)
            )
            frontier = seen[~member[seen]]
            if frontier.size == 0:
                exhausted = True
                break
            # T's internal density from the incremental degrees (unweighted
            # counts — the pruning heuristic matches Andersen's unweighted
            # setting; the final density comes from the real weighted peel).
            rho = float(deg_t[cand].sum()) / (2.0 * len(cand))
            d_f = deg_t[frontier]
            keep = d_f >= max(alpha * rho, 1.0)
            frontier, d_f = frontier[keep], d_f[keep]
            if frontier.size == 0:
                exhausted = True  # pruning closed the set
                break
            # Deterministic admission order: strongest ties into T first,
            # lowest id on ties; the budget and volume caps cut along it.
            order = np.lexsort((frontier, -d_f))
            frontier = frontier[order[: budget - len(cand)]]
            # Volume cap at admission: a vertex whose CSR row does not fit
            # in the remaining work budget is NOT admitted (its row is
            # never scanned), keeping total work <= vol_cap even when a
            # hub sits one hop away.  Individually-oversized rows are
            # skipped first so one hub does not shadow the small rows
            # admitted after it; the rest cut at the cumulative cap.
            remaining = vol_cap - edges_scanned
            sizes = self._indptr[frontier + 1] - self._indptr[frontier]
            if (sizes > remaining).any():
                frontier = frontier[sizes <= remaining]
                sizes = self._indptr[frontier + 1] - self._indptr[frontier]
            fit = np.cumsum(sizes) <= remaining
            if not fit.all():
                frontier = frontier[fit]
            if frontier.size == 0:
                break
            member[frontier] = True
            cand = np.concatenate([cand, frontier])
            scan(frontier)
            rounds += 1
        seen = (
            np.unique(np.concatenate(touched_parts))
            if touched_parts
            else np.empty(0, np.int64)
        )
        nodes_touched = int(np.union1d(seen, cand).size)
        candidates = np.sort(cand)
        # Reset scratch for the next query.
        member[cand] = False
        deg_t[seen] = 0
        return LocalExploration(
            seed=s,
            candidates=candidates,
            rounds=rounds,
            nodes_touched=nodes_touched,
            edges_scanned=edges_scanned,
            frontier_exhausted=exhausted,
        )

    def extract(
        self,
        seed,
        *,
        budget: int = _LOCAL_BUDGET,
        max_rounds: int = _LOCAL_ROUNDS,
        alpha: float = 1.0,
        volume_factor: int = _LOCAL_VOLUME_FACTOR,
        node_floor: int = _NODE_FLOOR,
        edge_floor: int = _EDGE_FLOOR,
    ) -> Tuple[EdgeList, LocalExploration]:
        """Explore + relabel: the candidate set's induced subgraph in the
        serving bucket format (see :func:`induced_padded`)."""
        ex = self.explore(
            seed,
            budget=budget,
            max_rounds=max_rounds,
            alpha=alpha,
            volume_factor=volume_factor,
        )
        padded = induced_padded(
            self._indptr,
            self._indices,
            self._weights,
            ex.candidates,
            self._member,
            self._local_id,
            node_floor=node_floor,
            edge_floor=edge_floor,
        )
        return padded, ex
