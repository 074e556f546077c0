"""PeelEngine of the port: the one peel-pass implementation (counterpart of
``repro.core.engine``).

A pass counts induced degrees, computes the density, records the best set
and removes the below-threshold nodes.  It is written once, in
:func:`run_peel`, parameterized by a **RemovalPolicy** (which nodes leave)
and a **DegreeBackend** (how degrees are counted: :class:`ExactBackend`
with ``index_add_``, or :class:`FnBackend` around the tiled-degree kernel).

The reference runs the passes in a ``jax.lax.while_loop``.  Here the loop
runs on the host and reads one device boolean per pass, the continuation
test (through :func:`repro_torch.hostsync.read`); everything else stays on
the tensor's device.  The segment controls of the compaction runtime
(``compact_below``, ``init_*``) behave as in the reference, so a segmented
run is bit-identical to a single run for integer-valued weights.

The removal threshold ``2(1+eps)·rho`` exists only in
:func:`removal_threshold`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Protocol, Tuple, Union

import torch

from repro_torch import hostsync
from repro_torch.graph.edgelist import EdgeList


def removal_threshold(eps: float, rho: torch.Tensor) -> torch.Tensor:
    """The paper's removal threshold 2(1+eps)·rho(S) — the only place the
    expression exists in the port."""
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
    """Per-pass scalars handed to the policy's removal rule."""

    rho: torch.Tensor  # float32[] density of the current set
    total: torch.Tensor  # float32[] alive edge weight |E(S)|
    n_s: torch.Tensor  # int64[] |S|


class PeelState(NamedTuple):
    """Loop carry.  ``t`` lives on the host; the rest on the device.  The
    history tensors are written in place (one slot per pass)."""

    alive: torch.Tensor  # bool[N] current S
    best_alive: torch.Tensor  # bool[N] best S seen
    best_rho: torch.Tensor  # float32[]
    best_size: torch.Tensor  # int32[] |S| of the best set
    t: int  # absolute pass counter
    alive_edges: Optional[torch.Tensor]  # int64[] post-removal alive edges
    edge_ok: Optional[torch.Tensor]  # bool[E] post-removal edge filter
    history_n: torch.Tensor  # int32[hist_len]
    history_m: torch.Tensor  # float32[hist_len]
    history_rho: torch.Tensor  # float32[hist_len]


class PeelOutcome(NamedTuple):
    """Result of any peel run (tensors on the graph's device)."""

    best_alive: torch.Tensor  # bool[N] the output set S~
    best_density: torch.Tensor  # float32[] rho of the best set
    best_size: torch.Tensor  # int32[] |S~|
    passes: int  # passes executed (absolute; counted by the host loop)
    alive: torch.Tensor  # bool[N] final S bitmap
    history_n: torch.Tensor  # int32[hist_len] per-pass |S| (-1 padding)
    history_m: torch.Tensor  # float32[hist_len] per-pass |E(S)|
    history_rho: torch.Tensor  # float32[hist_len] per-pass rho


class RemovalPolicy(Protocol):
    """What a pass removes."""

    def density(self, total: torch.Tensor, n_s: torch.Tensor) -> torch.Tensor: ...

    def eligible(self, n_s: torch.Tensor) -> torch.Tensor: ...

    def keep_going(self, n_s: torch.Tensor) -> torch.Tensor: ...

    def removal(
        self, alive: torch.Tensor, deg: torch.Tensor, stats: PassStats
    ) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class UndirectedThreshold:
    """Algorithm 1: drop every node with deg <= 2(1+eps)·rho(S), or, when
    rounding would leave nothing to drop, the current minimum-degree nodes."""

    eps: float

    def density(self, total, n_s):
        return torch.where(n_s > 0, total / torch.clamp(n_s, min=1), 0.0)

    def eligible(self, n_s):
        return n_s > 0

    def keep_going(self, n_s):
        return n_s > 0

    def removal(self, alive, deg, stats):
        thresh = removal_threshold(self.eps, stats.rho)
        min_deg = torch.where(alive, deg, torch.inf).min()
        return alive & ((deg <= thresh) | (deg <= min_deg))


class DegreeBackend(Protocol):
    """Induced-degree computation from the engine's per-edge alive weight."""

    def undirected(
        self, edges: EdgeList, w_alive: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]: ...


class ExactBackend:
    """``index_add_`` degrees — the paper's reduce-side count (§5.2)."""

    def undirected(self, edges, w_alive):
        return segment_degree_count(edges.src, edges.dst, w_alive, edges.n_nodes)


class FnBackend:
    """Adapts a ``degree_fn(edges, w_alive) -> deg[N]`` (the tiled-degree
    kernel's wrapper) into a DegreeBackend."""

    def __init__(self, degree_fn: Callable[[EdgeList, torch.Tensor], torch.Tensor]):
        self.degree_fn = degree_fn

    def undirected(self, edges, w_alive):
        return self.degree_fn(edges, w_alive), w_alive.sum()


def _edge_filter(edges: EdgeList, alive: torch.Tensor) -> torch.Tensor:
    return edges.mask & alive[edges.src] & alive[edges.dst]


def run_peel(
    edges: EdgeList,
    policy: RemovalPolicy,
    backend: DegreeBackend,
    max_passes: int,
    *,
    track_history: bool = False,
    init_alive: Optional[torch.Tensor] = None,
    init_best_empty: bool = False,
    init_t: Optional[int] = None,
    compact_below: Optional[int] = None,
    init_alive_edges: Union[int, torch.Tensor, None] = None,
    init_ok_from_mask: bool = False,
    with_edge_state: bool = False,
):
    """Runs the peel loop to completion on ``edges.device``.

    Segment controls (the compaction runtime), as in the reference:
    ``init_alive`` seeds S (default: all nodes); ``init_best_empty`` starts
    the best set empty instead of S_0; ``init_t`` continues the absolute
    pass counter, so ``t < max_passes`` and history indices span segments;
    ``compact_below`` stops the loop once the post-removal alive edge count
    drops under it.  The post-removal edge filter is carried and reused as
    the next pass's filter.  ``init_ok_from_mask`` declares that every
    masked edge has both endpoints alive at entry (a freshly compacted
    buffer), and ``init_alive_edges`` supplies their count.
    ``with_edge_state`` (requires ``compact_below``) returns ``(outcome,
    edge_ok, alive_edges)``.

    Host syncs: one per pass (the continuation test) plus the final test.
    """
    if with_edge_state and compact_below is None:
        raise ValueError("with_edge_state needs compact_below (the carried "
                         "filter is only materialized then)")
    dev = edges.device
    n = edges.n_nodes
    hist_len = max_passes if track_history else 1
    alive0 = torch.ones(n, dtype=torch.bool, device=dev) if init_alive is None else init_alive
    ok0 = ae0 = None
    if compact_below is not None:
        ok0 = edges.mask if init_ok_from_mask else _edge_filter(edges, alive0)
        if init_alive_edges is not None:
            ae0 = torch.as_tensor(init_alive_edges, dtype=torch.int64, device=dev)
        else:
            ae0 = ok0.sum()
    s = PeelState(
        alive=alive0,
        best_alive=torch.zeros_like(alive0) if init_best_empty else alive0,
        best_rho=torch.tensor(-torch.inf, dtype=torch.float32, device=dev),
        best_size=torch.tensor(0, dtype=torch.int32, device=dev),
        t=0 if init_t is None else int(init_t),
        alive_edges=ae0,
        edge_ok=ok0,
        history_n=torch.full((hist_len,), -1, dtype=torch.int32, device=dev),
        history_m=torch.zeros(hist_len, dtype=torch.float32, device=dev),
        history_rho=torch.zeros(hist_len, dtype=torch.float32, device=dev),
    )

    def cond(s: PeelState, n_s: torch.Tensor) -> bool:
        if s.t >= max_passes:
            return False
        going = policy.keep_going(n_s)
        if compact_below is not None:
            going = going & (s.alive_edges >= compact_below)
        return bool(hostsync.read(going))

    def body(s: PeelState, n_s: torch.Tensor) -> PeelState:
        # (3) of §5.2: the edge filter against the alive bitmap — carried
        # from the previous pass's removal in a compacted segment.
        ok = s.edge_ok if compact_below is not None else _edge_filter(edges, s.alive)
        w_alive = torch.where(ok, edges.weight, 0.0)
        # (2): the degree count — the only backend-dependent step.
        deg, total = backend.undirected(edges, w_alive)
        # (1): density + best-set tracking (strict >: earliest pass wins).
        rho = policy.density(total, n_s)
        improved = policy.eligible(n_s) & (rho > s.best_rho)
        best_alive = torch.where(improved, s.alive, s.best_alive)
        best_rho = torch.where(improved, rho, s.best_rho)
        best_size = torch.where(improved, n_s.to(torch.int32), s.best_size)

        rm = policy.removal(s.alive, deg, PassStats(rho=rho, total=total, n_s=n_s))
        alive = s.alive & ~rm
        ok_next, ae = s.edge_ok, s.alive_edges
        if compact_below is not None:
            ok_next = _edge_filter(edges, alive)
            ae = ok_next.sum()
        if track_history:
            s.history_n[s.t] = n_s
            s.history_m[s.t] = total
            s.history_rho[s.t] = rho
        return s._replace(
            alive=alive, best_alive=best_alive, best_rho=best_rho,
            best_size=best_size, t=s.t + 1, alive_edges=ae, edge_ok=ok_next,
        )

    while True:
        n_s = s.alive.sum()
        if not cond(s, n_s):
            break
        s = body(s, n_s)

    outcome = PeelOutcome(
        best_alive=s.best_alive,
        best_density=s.best_rho,
        best_size=s.best_size,
        passes=s.t,
        alive=s.alive,
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
    rho = policy.density(total, n_alive)
    rm = policy.removal(alive, deg, PassStats(rho=rho, total=total, n_s=n_alive))
    return alive & ~rm, rho
