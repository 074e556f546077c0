"""PeelEngine of the port: the one peel-pass implementation (counterpart of
``repro.core.engine``).

A pass counts induced degrees, computes the density, records the best set
and removes the below-threshold nodes.  It is written once, in
:func:`run_peel`, parameterized by a **RemovalPolicy** (which nodes leave:
Algorithm 1's :class:`UndirectedThreshold`, Algorithm 2's
:class:`AtLeastKFraction`, Algorithm 3's :class:`DirectedST`) and a
**DegreeBackend** (how degrees are counted: :class:`ExactBackend` with
``index_add_``, :class:`FnBackend` around the tiled-degree kernel, the
Count-Sketch backend of core/countsketch.py, or, on an edge-sharded mesh,
:class:`MeshSegmentSumBackend`, whose partial counts are summed over the
ranks by one ``all_reduce`` a pass).

The reference runs the passes in a ``jax.lax.while_loop``.  Here the loop
runs on the host and reads one device boolean per pass, the continuation
test (through :func:`repro_torch.hostsync.read`); everything else stays on
the tensor's device.  The segment controls of the compaction runtime
(``compact_below``, ``init_*``) behave as in the reference, so a segmented
run is bit-identical to a single run for integer-valued weights.

A sweep (``Solver.solve_batch``) is the same loop with a leading lane axis
on the node state (``lanes=B``; stacked graphs carry it on their edge
arrays too): the policy's ``eps``/``c`` are then ``[B]`` tensors, the host
reads the ``[B]`` continuation vector once a pass for all lanes, and a lane
whose test failed keeps its state from then on, as a lane of a vmapped
``while_loop`` does.  ``solve()`` is the lane-less case.

The removal threshold ``2(1+eps)·rho`` exists only in
:func:`removal_threshold`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Protocol, Tuple, Union

import torch

from repro_torch import collectives, hostsync
from repro_torch.graph.edgelist import EdgeList


def removal_threshold(eps, rho: torch.Tensor) -> torch.Tensor:
    """The paper's removal threshold 2(1+eps)·rho(S) — the only place the
    expression exists in the port.  ``eps`` is a Python float (a solve: the
    factor is formed in f64, then meets ``rho`` in f32) or an f32 tensor (a
    sweep's lanes: formed in f32), as in the reference."""
    return 2.0 * (1.0 + eps) * rho


def segment_degree_count(
    src: torch.Tensor, dst: torch.Tensor, w_alive: torch.Tensor, n_nodes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduce-side degree count of §5.2: both endpoints' ``index_add_``
    plus the total alive edge weight.  The only exact undirected count."""
    deg = torch.zeros(n_nodes, dtype=torch.float32, device=w_alive.device)
    deg.index_add_(0, src, w_alive).index_add_(0, dst, w_alive)
    return deg, w_alive.sum()


def compact_edges(
    ok: torch.Tensor, arrays: Tuple[torch.Tensor, ...], capacity: int
) -> Tuple[torch.Tensor, ...]:
    """Masked prefix-sum relabeling of edge slots: slots where ``ok`` holds
    move, in order, to the front of fresh ``capacity``-slot zero buffers;
    survivors past ``capacity`` are dropped.  Spelled as cumsum, then a
    rank search, then a gather with fill, as in the reference."""
    m = ok.shape[0]
    if m == 0:
        return tuple(a.new_zeros(capacity) for a in arrays)
    cs = torch.cumsum(ok, 0, dtype=torch.int64)
    ranks = torch.arange(1, capacity + 1, dtype=torch.int64, device=ok.device)
    idx = torch.searchsorted(cs, ranks, side="left")  # m when rank > total
    valid = idx < m
    safe = idx.clamp(max=m - 1)
    return tuple(
        torch.where(valid, a[safe], torch.zeros((), dtype=a.dtype, device=a.device))
        for a in arrays
    )


class PassStats(NamedTuple):
    """Per-pass scalars handed to the policy's removal rule (``[B]`` with a
    lane axis)."""

    rho: torch.Tensor  # float32[] density of the current set
    total: torch.Tensor  # float32[] alive edge weight |E(S)| (or |E(S,T)|)
    n_s: torch.Tensor  # int64[] |S|
    n_t: torch.Tensor  # int64[] |T| (== |S| for undirected policies)


class PeelState(NamedTuple):
    """Loop carry.  ``t`` lives on the host; the rest on the device.  The
    history tensors are written in place (one slot per pass).  For
    undirected policies the T-side arrays are empty ``bool[0]``
    placeholders, as in the reference."""

    alive: torch.Tensor  # bool[N] current S
    t_alive: torch.Tensor  # bool[N] current T (directed) | bool[0]
    best_alive: torch.Tensor  # bool[N] best S seen
    best_t: torch.Tensor  # bool[N] best T seen (directed) | bool[0]
    best_rho: torch.Tensor  # float32[]
    best_size: torch.Tensor  # int32[] |S| of the best set
    t: int  # absolute pass counter
    alive_edges: Optional[torch.Tensor]  # int64[] post-removal alive edges
    edge_ok: Optional[torch.Tensor]  # bool[E] post-removal edge filter
    history_n: torch.Tensor  # int32[hist_len]
    history_m: torch.Tensor  # float32[hist_len]
    history_rho: torch.Tensor  # float32[hist_len]


class PeelOutcome(NamedTuple):
    """Result of any peel run (tensors on the graph's device), in the
    reference's field order."""

    best_alive: torch.Tensor  # bool[N] the output set S~ (S side for directed)
    best_t: torch.Tensor  # bool[N] T side (directed) | bool[0]
    best_density: torch.Tensor  # float32[] rho of the best set
    best_size: torch.Tensor  # int32[] |S~|
    passes: Union[int, List[int]]  # passes executed (one per lane in a sweep)
    alive: torch.Tensor  # bool[N] final S bitmap
    t_alive: torch.Tensor  # bool[N] final T bitmap | bool[0]
    history_n: torch.Tensor  # int32[hist_len] per-pass |S| (-1 padding)
    history_m: torch.Tensor  # float32[hist_len] per-pass |E(S)|
    history_rho: torch.Tensor  # float32[hist_len] per-pass rho

    @property
    def best_s(self) -> torch.Tensor:
        """Directed-result spelling of the S-side best bitmap."""
        return self.best_alive


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class RemovalPolicy(Protocol):
    """What a pass removes.  ``eps``/``c`` may be ``[B]`` tensors (a sweep);
    every rule broadcasts over a leading lane axis."""

    directed: bool

    def density(self, total: torch.Tensor, n_s: torch.Tensor, n_t: torch.Tensor) -> torch.Tensor: ...

    def eligible(self, n_s: torch.Tensor, n_t: torch.Tensor) -> torch.Tensor: ...

    def keep_going(self, n_s: torch.Tensor, n_t: torch.Tensor) -> torch.Tensor: ...

    def removal(
        self,
        s_alive: torch.Tensor,
        t_alive: torch.Tensor,
        deg_s: torch.Tensor,
        deg_t: torch.Tensor,
        stats: PassStats,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(remove-from-S bitmap, remove-from-T bitmap or None)."""


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar as a column against ``[..., N]`` node arrays."""
    return x.unsqueeze(-1)


def _min_alive(alive: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """The least degree among alive nodes, as a column."""
    return torch.where(alive, deg, torch.inf).amin(-1, keepdim=True)


def _undirected_density(total, n_s):
    return torch.where(n_s > 0, total / torch.clamp(n_s, min=1), 0.0)


@dataclasses.dataclass(frozen=True)
class UndirectedThreshold:
    """Algorithm 1: drop every node with deg <= 2(1+eps)·rho(S), or, when
    rounding would leave nothing to drop, the current minimum-degree nodes."""

    eps: Any  # float, or float32[B] in a sweep
    directed: bool = dataclasses.field(default=False, init=False)

    def density(self, total, n_s, n_t):
        return _undirected_density(total, n_s)

    def eligible(self, n_s, n_t):
        return n_s > 0

    def keep_going(self, n_s, n_t):
        return n_s > 0

    def removal(self, s_alive, t_alive, deg_s, deg_t, stats):
        thresh = _col(removal_threshold(self.eps, stats.rho))
        return s_alive & ((deg_s <= thresh) | (deg_s <= _min_alive(s_alive, deg_s))), None


@dataclasses.dataclass(frozen=True)
class AtLeastKFraction:
    """Algorithm 2: of the below-threshold candidates A~(S), remove only the
    eps/(1+eps)·|S| lowest-degree ones, ranked by (degree, node id); only
    sets with |S| >= k are eligible.  ``ceil_count``/``min_deg_fallback``
    select the reference's two realizations (floor + fallback; ceil
    without)."""

    k: int
    eps: Any  # float, or float32[B] in a sweep
    min_deg_fallback: bool = True
    ceil_count: bool = False
    directed: bool = dataclasses.field(default=False, init=False)

    def density(self, total, n_s, n_t):
        return _undirected_density(total, n_s)

    def eligible(self, n_s, n_t):
        return n_s >= self.k

    def keep_going(self, n_s, n_t):
        return n_s >= self.k

    def removal(self, s_alive, t_alive, deg_s, deg_t, stats):
        thresh = _col(removal_threshold(self.eps, stats.rho))
        if self.min_deg_fallback:
            cand = s_alive & ((deg_s <= thresh) | (deg_s <= _min_alive(s_alive, deg_s)))
        else:
            cand = s_alive & (deg_s <= thresh)
        nf = stats.n_s.to(torch.float32)
        if self.ceil_count:
            r = torch.ceil(nf * self.eps / (1.0 + self.eps)).to(torch.int32)
        else:
            r = ((self.eps / (1.0 + self.eps)) * nf).to(torch.int32)
        r = torch.clamp(r, min=1)
        # Rank candidates by (degree, node id): a stable sort puts every
        # candidate ahead of the non-candidates (key +inf).  XLA's sort
        # orders -0.0 with 0.0, so the key does too.
        key = torch.where(cand, deg_s, torch.inf)
        key = torch.where(key == 0, 0.0, key)
        order = torch.argsort(key, dim=-1, stable=True)
        ids = torch.arange(order.shape[-1], device=order.device).expand_as(order)
        rank = torch.empty_like(order).scatter_(-1, order, ids)
        return cand & (rank < _col(r)), None


@dataclasses.dataclass(frozen=True)
class DirectedST:
    """Algorithm 3 for a ratio guess c = |S|/|T| (an f32 tensor, ``[B]`` in
    a c sweep): peel S by out-degree when |S|/|T| >= c, else peel T by
    in-degree."""

    eps: Any  # float, or float32[B] in an eps sweep
    c: torch.Tensor  # float32[] | float32[B]
    directed: bool = dataclasses.field(default=True, init=False)

    def density(self, total, n_s, n_t):
        denom = torch.sqrt(
            torch.clamp(n_s.to(torch.float32), min=1.0)
            * torch.clamp(n_t.to(torch.float32), min=1.0)
        )
        return torch.where((n_s > 0) & (n_t > 0), total / denom, 0.0)

    def eligible(self, n_s, n_t):
        return (n_s > 0) & (n_t > 0)

    def keep_going(self, n_s, n_t):
        return (n_s > 0) & (n_t > 0)

    def removal(self, s_alive, t_alive, out_deg, in_deg, stats):
        ns_f = torch.clamp(stats.n_s.to(torch.float32), min=1.0)
        nt_f = torch.clamp(stats.n_t.to(torch.float32), min=1.0)
        peel_s = _col(ns_f / nt_f >= self.c)
        thr_s = _col((1.0 + self.eps) * stats.total / ns_f)
        rm_s = s_alive & ((out_deg <= thr_s) | (out_deg <= _min_alive(s_alive, out_deg)))
        thr_t = _col((1.0 + self.eps) * stats.total / nt_f)
        rm_t = t_alive & ((in_deg <= thr_t) | (in_deg <= _min_alive(t_alive, in_deg)))
        return rm_s & peel_s, rm_t & ~peel_s


# ---------------------------------------------------------------------------
# Lanes and backends
# ---------------------------------------------------------------------------


def lane_ids(ids: torch.Tensor, lanes: int, n_nodes: int) -> torch.Tensor:
    """Endpoint ids offset into a flattened ``[lanes, n_nodes]`` node array:
    ``lane * n_nodes + id``, flat, for ``ids`` shared by every lane
    (``[E]``) or one row a lane (``[lanes, E]``).  int32 while the node
    array has fewer than 2^31 entries."""
    dtype = torch.int32 if lanes * n_nodes < 2**31 else torch.int64
    off = torch.arange(lanes, dtype=dtype, device=ids.device)[:, None] * n_nodes
    return (ids.to(dtype) + off).reshape(-1)


class Lanes:
    """A sweep's lane axis as the backends see it: how many lanes, which of
    them still run this pass (host-known, from the pass's one sync), each
    lane's graph, and the lane-offset endpoint ids (built at first use,
    once a sweep)."""

    def __init__(self, edges: EdgeList, count: int):
        self.edges = edges
        self.count = count
        self.live: List[bool] = [True] * count
        self._ids: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def stacked(self) -> bool:
        return self.edges.src.dim() == 2

    def ids(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._ids is None:
            n = self.edges.n_nodes
            self._ids = (lane_ids(self.edges.src, self.count, n),
                         lane_ids(self.edges.dst, self.count, n))
        return self._ids

    def edges_of(self, b: int) -> EdgeList:
        """Lane ``b``'s graph: a row of stacked graphs, else the one graph."""
        e = self.edges
        if not self.stacked:
            return e
        return EdgeList(src=e.src[b], dst=e.dst[b], weight=e.weight[b], mask=e.mask[b],
                        n_nodes=e.n_nodes, directed=e.directed)

    def on_edges(self, x: torch.Tensor, end: int) -> torch.Tensor:
        """``[B, N]`` node state gathered onto the ``[B, E]`` edge slots of
        endpoint ``end`` (0: src, 1: dst)."""
        if self.stacked:
            return x.reshape(-1)[self.ids()[end]].view(self.edges.src.shape)
        return x[:, (self.edges.src, self.edges.dst)[end]]

    def per_lane(self, w_alive: torch.Tensor, fn) -> Tuple[torch.Tensor, ...]:
        """A one-lane degree rule ``fn(edges, w_alive) -> (deg, ...)`` run
        on each live lane; a finished lane's rows stay 0 (its state no
        longer changes)."""
        outs = None
        for b in range(self.count):
            if not self.live[b]:
                continue
            got = fn(self.edges_of(b), w_alive[b])
            if outs is None:
                outs = tuple(g.new_zeros((self.count,) + g.shape) for g in got)
            for o, g in zip(outs, got):
                o[b] = g
        return outs


class DegreeBackend(Protocol):
    """Induced-degree computation from the engine's per-edge alive weight
    (``[B, E]`` with ``lanes``)."""

    def undirected(
        self, edges: EdgeList, w_alive: torch.Tensor, lanes: Optional[Lanes] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]: ...

    def directed(
        self, edges: EdgeList, w_alive: torch.Tensor, lanes: Optional[Lanes] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]: ...


class ExactBackend:
    """``index_add_`` degrees — the paper's reduce-side count (§5.2).  A
    sweep's lanes are one ``index_add_`` over lane-offset ids."""

    def undirected(self, edges, w_alive, lanes=None):
        if lanes is None:
            return segment_degree_count(edges.src, edges.dst, w_alive, edges.n_nodes)
        src, dst = lanes.ids()
        deg, _ = segment_degree_count(src, dst, w_alive.reshape(-1),
                                      lanes.count * edges.n_nodes)
        return deg.view(lanes.count, -1), w_alive.sum(-1)

    def directed(self, edges, w_alive, lanes=None):
        src, dst, n = edges.src, edges.dst, edges.n_nodes
        if lanes is not None:
            (src, dst), n = lanes.ids(), lanes.count * n
        w = w_alive.reshape(-1)
        shape = w_alive.shape[:-1] + (edges.n_nodes,)
        out_deg = torch.zeros(n, dtype=torch.float32, device=w.device).index_add_(0, src, w)
        in_deg = torch.zeros(n, dtype=torch.float32, device=w.device).index_add_(0, dst, w)
        return out_deg.view(shape), in_deg.view(shape), w_alive.sum(-1)


class FnBackend:
    """Adapts a ``degree_fn(edges, w_alive) -> deg[N]`` (the tiled-degree
    kernel's wrapper) into a DegreeBackend; a sweep calls it once per live
    lane."""

    def __init__(self, degree_fn: Callable[[EdgeList, torch.Tensor], torch.Tensor]):
        self.degree_fn = degree_fn

    def undirected(self, edges, w_alive, lanes=None):
        if lanes is None:
            return self.degree_fn(edges, w_alive), w_alive.sum()
        (deg,) = lanes.per_lane(w_alive, lambda e, w: (self.degree_fn(e, w),))
        return deg, w_alive.sum(-1)

    def directed(self, edges, w_alive, lanes=None):
        raise NotImplementedError(
            "degree_fn hooks are undirected; use a backend with a directed() rule"
        )


@dataclasses.dataclass(frozen=True)
class MeshSegmentSumBackend:
    """Degrees of an edge shard, summed over the ranks (paper §5.2).

    Each rank counts its shard's partial degrees with ``index_add_`` and
    packs them with its alive weight as ``[deg | total]`` (directed:
    ``[out | in | total]``), and ONE ``all_reduce`` over ``group`` (the
    edge axes' process group) sums the pack, so a pass costs one
    collective and every rank holds the same degrees.  ``wire_dtype='bf16'``
    casts the pack, total included, to bf16 for the reduction and back.
    It takes no sweep lanes: ``solve_batch`` runs on the jit substrate."""

    group: Any  # torch.distributed ProcessGroup over the edge axes
    wire_dtype: str = "f32"

    def _reduce(self, packed: torch.Tensor) -> torch.Tensor:
        if self.wire_dtype == "bf16":
            return collectives.all_reduce(packed.to(torch.bfloat16), self.group).to(torch.float32)
        return collectives.all_reduce(packed, self.group)

    def undirected(self, edges, w_alive):
        deg, total = ExactBackend().undirected(edges, w_alive)
        packed = self._reduce(torch.cat([deg, total[None]]))
        return packed[:-1], packed[-1]

    def directed(self, edges, w_alive):
        n = edges.n_nodes
        out_deg, in_deg, total = ExactBackend().directed(edges, w_alive)
        packed = self._reduce(torch.cat([out_deg, in_deg, total[None]]))
        return packed[:n], packed[n:2 * n], packed[-1]

    def count_edges(self, ok: torch.Tensor) -> torch.Tensor:
        """The global alive-edge count (the ladder's trigger): this shard's
        count, summed over the ranks as one int32, so every rank ends a
        segment at the same pass."""
        return collectives.all_reduce(ok.sum(dtype=torch.int32), self.group)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _count_ok(backend, ok: torch.Tensor) -> torch.Tensor:
    """The count of an alive-edge mask.  A backend that reduces across
    ranks exposes ``count_edges``, so the segment boundary is a collective
    decision; everything else counts locally."""
    counter = getattr(backend, "count_edges", None)
    if counter is not None:
        return counter(ok)
    return ok.sum()


def _edge_filter(edges: EdgeList, s_alive: torch.Tensor, t_alive: torch.Tensor,
                 lanes: Optional[Lanes]) -> torch.Tensor:
    """(3) of §5.2: masked edges with src in S and dst in T."""
    if lanes is None:
        return edges.mask & s_alive[edges.src] & t_alive[edges.dst]
    return edges.mask & lanes.on_edges(s_alive, 0) & lanes.on_edges(t_alive, 1)


def run_peel(
    edges: EdgeList,
    policy: RemovalPolicy,
    backend: DegreeBackend,
    max_passes: int,
    *,
    track_history: bool = False,
    init_alive: Optional[torch.Tensor] = None,
    init_t_alive: Optional[torch.Tensor] = None,
    init_best_empty: bool = False,
    init_t: Optional[int] = None,
    compact_below: Optional[int] = None,
    init_alive_edges: Union[int, torch.Tensor, None] = None,
    init_ok_from_mask: bool = False,
    with_edge_state: bool = False,
    lanes: Optional[int] = None,
):
    """Runs the peel loop to completion on ``edges.device``.

    Segment controls (the compaction runtime), as in the reference:
    ``init_alive`` / ``init_t_alive`` seed S / T (default: all nodes);
    ``init_best_empty`` starts the best set empty instead of S_0;
    ``init_t`` continues the absolute pass counter, so ``t < max_passes``
    and history indices span segments; ``compact_below`` stops the loop
    once the post-removal alive edge count drops under it.  The
    post-removal edge filter is carried and reused as the next pass's
    filter.  ``init_ok_from_mask`` declares that every masked edge has both
    endpoints alive at entry (a freshly compacted buffer), and
    ``init_alive_edges`` supplies their count.  ``with_edge_state``
    (requires ``compact_below``) returns ``(outcome, edge_ok,
    alive_edges)``.

    ``lanes=B`` runs a sweep (see the module docstring): node state and
    outcome gain a leading ``[B]`` axis and ``passes`` is a list, one count
    a lane.  Stacked graphs (``[B, E]`` edge arrays) imply it.  A sweep has
    one buffer for all lanes, so it takes no ``compact_below``.

    Host syncs: one per pass (the continuation test, all lanes at once)
    plus the final test.
    """
    if with_edge_state and compact_below is None:
        raise ValueError("with_edge_state needs compact_below (the carried "
                         "filter is only materialized then)")
    if edges.src.dim() == 2:
        lanes = edges.src.shape[0]
    if lanes is not None and compact_below is not None:
        raise ValueError("a sweep shares one buffer between its lanes; it cannot compact")
    dev = edges.device
    directed = policy.directed
    lane = None if lanes is None else Lanes(edges, lanes)
    shape = (edges.n_nodes,) if lanes is None else (lanes, edges.n_nodes)
    hist_shape = shape[:-1] + ((max_passes if track_history else 1),)
    dummy = torch.zeros(shape[:-1] + (0,), dtype=torch.bool, device=dev)
    alive0 = torch.ones(shape, dtype=torch.bool, device=dev) if init_alive is None else init_alive
    ta0 = (alive0 if init_t_alive is None else init_t_alive) if directed else dummy
    ok0 = ae0 = None
    if compact_below is not None:
        ok0 = edges.mask if init_ok_from_mask else _edge_filter(
            edges, alive0, ta0 if directed else alive0, None)
        if init_alive_edges is not None:
            ae0 = torch.as_tensor(init_alive_edges, dtype=torch.int64, device=dev)
        else:
            ae0 = _count_ok(backend, ok0)
    s = PeelState(
        alive=alive0,
        t_alive=ta0,
        best_alive=torch.zeros_like(alive0) if init_best_empty else alive0,
        best_t=(torch.zeros_like(ta0) if init_best_empty else ta0) if directed else dummy,
        best_rho=torch.full(shape[:-1], -torch.inf, dtype=torch.float32, device=dev),
        best_size=torch.zeros(shape[:-1], dtype=torch.int32, device=dev),
        t=0 if init_t is None else int(init_t),
        alive_edges=ae0,
        edge_ok=ok0,
        history_n=torch.full(hist_shape, -1, dtype=torch.int32, device=dev),
        history_m=torch.zeros(hist_shape, dtype=torch.float32, device=dev),
        history_rho=torch.zeros(hist_shape, dtype=torch.float32, device=dev),
    )
    lane_passes = [s.t] * (lanes or 0)

    def counts(s: PeelState):
        n_s = s.alive.sum(-1)
        return n_s, (s.t_alive.sum(-1) if directed else n_s)

    def body(s: PeelState, n_s, n_t, active: Optional[torch.Tensor]) -> PeelState:
        ta = s.t_alive if directed else s.alive
        # (3) of §5.2: the edge filter against the alive bitmap(s) — carried
        # from the previous pass's removal in a compacted segment.
        ok = s.edge_ok if compact_below is not None else _edge_filter(edges, s.alive, ta, lane)
        w_alive = torch.where(ok, edges.weight, 0.0)
        # (2): the degree count — the only backend-dependent step.
        kw = {} if lane is None else {"lanes": lane}
        if directed:
            deg_s, deg_t, total = backend.directed(edges, w_alive, **kw)
        else:
            deg_s, total = backend.undirected(edges, w_alive, **kw)
            deg_t = deg_s
        # (1): density + best-set tracking (strict >: earliest pass wins).
        rho = policy.density(total, n_s, n_t)
        improved = policy.eligible(n_s, n_t) & (rho > s.best_rho)
        rm_s, rm_t = policy.removal(
            s.alive, ta, deg_s, deg_t, PassStats(rho=rho, total=total, n_s=n_s, n_t=n_t))
        if active is not None:  # lanes whose loop has ended keep their state
            improved = improved & active
            rm_s = rm_s & _col(active)
            rm_t = None if rm_t is None else rm_t & _col(active)
        best_alive = torch.where(_col(improved), s.alive, s.best_alive)
        best_t = torch.where(_col(improved), ta, s.best_t) if directed else s.best_t
        best_rho = torch.where(improved, rho, s.best_rho)
        best_size = torch.where(improved, n_s.to(torch.int32), s.best_size)

        alive = s.alive & ~rm_s
        t_alive = ta & ~rm_t if directed else s.t_alive
        ok_next, ae = s.edge_ok, s.alive_edges
        if compact_below is not None:
            ok_next = _edge_filter(edges, alive, t_alive if directed else alive, None)
            ae = _count_ok(backend, ok_next)
        if track_history:
            for hist, val in ((s.history_n, n_s), (s.history_m, total), (s.history_rho, rho)):
                if active is not None:
                    val = torch.where(active, val.to(hist.dtype), hist[..., s.t])
                hist[..., s.t] = val
        return s._replace(
            alive=alive, t_alive=t_alive, best_alive=best_alive, best_t=best_t,
            best_rho=best_rho, best_size=best_size, t=s.t + 1, alive_edges=ae,
            edge_ok=ok_next,
        )

    while s.t < max_passes:
        n_s, n_t = counts(s)
        going = policy.keep_going(n_s, n_t)
        if compact_below is not None:
            going = going & (s.alive_edges >= compact_below)
        flags = hostsync.read(going)
        if lane is None:
            if not flags:
                break
            s = body(s, n_s, n_t, None)
            continue
        if not any(flags):
            break
        lane.live = flags
        s = body(s, n_s, n_t, None if all(flags) else going)
        lane_passes = [p + f for p, f in zip(lane_passes, flags)]

    outcome = PeelOutcome(
        best_alive=s.best_alive,
        best_t=s.best_t,
        best_density=s.best_rho,
        best_size=s.best_size,
        passes=s.t if lane is None else lane_passes,
        alive=s.alive,
        t_alive=s.t_alive,
        history_n=s.history_n,
        history_m=s.history_m,
        history_rho=s.history_rho,
    )
    if with_edge_state:
        return outcome, s.edge_ok, s.alive_edges
    return outcome


def undirected_pass_step(
    alive: torch.Tensor, deg: torch.Tensor, total, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Algorithm-1 pass on explicit node state: ``(new_alive, rho)``.
    A host-chunked driver accumulates ``deg``/``total`` and applies this,
    so the removal rule stays the engine's."""
    policy = UndirectedThreshold(eps)
    n_alive = alive.sum()
    total = torch.as_tensor(total, dtype=torch.float32, device=alive.device)
    rho = policy.density(total, n_alive, n_alive)
    stats = PassStats(rho=rho, total=total, n_s=n_alive, n_t=n_alive)
    rm, _ = policy.removal(alive, alive, deg, deg, stats)
    return alive & ~rm, rho
