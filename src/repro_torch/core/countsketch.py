"""Count-Sketch degree estimation, paper §5.1 (counterpart of
``repro.core.countsketch``).

t tables of b signed counters; every endpoint x of an alive edge adds
``g_i(x)·w`` to counter ``(i, h_i(x))``, and the degree estimate of x is
the median over i of ``c[i, h_i(x)]·g_i(x)``.  The counters are built by
``kernels/count_sketch`` (the hand-written kernel K2 on the card, its plain
version on a CPU tensor); the query stays plain torch ops, as the
reference leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.edgelist import EdgeList
from repro_torch.kernels import hashing

__all__ = [
    "SketchBackend",
    "SketchParams",
    "densest_subgraph_sketched",
    "make_sketch_params",
    "query_degrees",
    "sketch_degrees_from_edges",
    "sketch_endpoint_counters",
    "sketched_degree_fn",
]


@dataclasses.dataclass(frozen=True, eq=False)
class SketchParams:
    """Hash parameters for t tables over b buckets, as host uint32 arrays
    (the kernel takes their bit patterns; the plain version widens them)."""

    a_h: np.ndarray  # uint32[t] odd multipliers for the bucket hash
    c_h: np.ndarray  # uint32[t] offsets
    a_g: np.ndarray  # uint32[t] odd multipliers for the sign hash
    c_g: np.ndarray  # uint32[t] offsets
    n_buckets: int

    @property
    def n_tables(self) -> int:
        return int(self.a_h.shape[0])

    def table(self, i: int) -> Tuple[int, int, int, int]:
        """Table ``i``'s ``(a_h, c_h, a_g, c_g)`` as Python ints."""
        return int(self.a_h[i]), int(self.c_h[i]), int(self.a_g[i]), int(self.c_g[i])

    def column(self, name: str, device) -> torch.Tensor:
        """int64[t, 1] of one parameter, for broadcasting against ids."""
        return torch.as_tensor(getattr(self, name).astype(np.int64), device=device)[:, None]


def make_sketch_params(t: int, b: int, seed: int = 0) -> SketchParams:
    """The reference's draw from ``numpy.random.default_rng(seed)``, in its
    order, so both packages hash with equal parameters."""
    rng = np.random.default_rng(seed)

    def odd():
        return (rng.integers(0, 1 << 31, size=t, dtype=np.int64) * 2 + 1).astype(np.uint32)

    def any32():
        return rng.integers(0, 1 << 32, size=t, dtype=np.int64).astype(np.uint32)

    return SketchParams(odd(), any32(), odd(), any32(), int(b))


def _hash_bucket(p: SketchParams, x: torch.Tensor) -> torch.Tensor:
    """int32[t, *x.shape] bucket of every id in every table."""
    xu = hashing.as_u32(x)[None]
    return hashing.bucket32(hashing.mix32(p.column("a_h", x.device), p.column("c_h", x.device), xu),
                            p.n_buckets)


def _hash_sign(p: SketchParams, x: torch.Tensor) -> torch.Tensor:
    """float32[t, *x.shape] ±1 sign of every id in every table."""
    xu = hashing.as_u32(x)[None]
    return hashing.sign32(hashing.mix32(p.column("a_g", x.device), p.column("c_g", x.device), xu))


def sketch_endpoint_counters(
    p: SketchParams, ids: torch.Tensor, w_alive: torch.Tensor
) -> torch.Tensor:
    """float32[t, b] counters of ONE endpoint array of the edge stream."""
    from repro_torch.kernels.count_sketch.ops import count_sketch_update

    return count_sketch_update(ids, w_alive, p)


def sketch_degrees_from_edges(
    p: SketchParams, edges: EdgeList, w_alive: torch.Tensor
) -> torch.Tensor:
    """float32[t, b] counters of the masked edge stream: each alive edge
    adds to both endpoints' counters (the §5.1 update rule).  One K2 launch
    over both endpoint arrays on the card."""
    from repro_torch.kernels.count_sketch.ops import sketch_edges

    return sketch_edges(edges.src, edges.dst, w_alive, p)


def median_over_tables(est: torch.Tensor) -> torch.Tensor:
    """``jnp.median(est, axis=0)`` bit for bit: the two middle values of a
    STABLE sort along the tables (``-0.0`` and ``0.0`` compare equal and
    keep their order, as in XLA's sort), averaged as ``(lo + hi) * 0.5``.
    ``torch.median`` takes the lower middle value instead.  The sort is a
    rank count over the handful of tables: row i's stable rank is
    ``#{j < i : v_j <= v_i} + #{j > i : v_j < v_i}``, elementwise."""
    rows = est.unbind(0)
    t = len(rows)
    rank = []
    for i, vi in enumerate(rows):
        r = torch.zeros(vi.shape, dtype=torch.int8, device=est.device)
        for j, vj in enumerate(rows):
            if j != i:
                r += (vj <= vi) if j < i else (vj < vi)
        rank.append(r)  # each node's ranks are a permutation of 0..t-1

    def at(k: int) -> torch.Tensor:
        out = rows[0]
        for r, v in zip(rank, rows):
            out = torch.where(r == k, v, out)
        return out

    lo, hi = at((t - 1) // 2), at(t // 2)
    return (lo + hi) * 0.5


def _estimates(counters: torch.Tensor, flat: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    return counters.reshape(-1)[flat] * signs


def _query_index(p: SketchParams, nodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[t, N] flat counter index, float32[t, N] sign) of ``nodes``."""
    rows = torch.arange(p.n_tables, dtype=torch.int64, device=nodes.device)[:, None]
    flat = _hash_bucket(p, nodes).to(torch.int64) + rows * p.n_buckets
    return flat, _hash_sign(p, nodes)


def query_degrees(p: SketchParams, counters: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Median-of-t degree estimates for the given node ids."""
    return median_over_tables(_estimates(counters, *_query_index(p, nodes)))


class SketchBackend:
    """Engine ``DegreeBackend`` backed by the §5.1 Count-Sketch.

    Undirected degrees use the shared two-endpoint counter table; the
    directed rule keeps separate out and in tables.  The hashes of the node
    ids ``0..n-1`` do not change from pass to pass, so the backend keeps
    the last graph's query index (one ``[t, n]`` int64 and float32 pair)
    instead of hashing every node again each pass; the estimates are the
    same bits as :func:`query_degrees`.
    """

    def __init__(self, params: SketchParams):
        self.params = params
        self._index: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _node_index(self, n_nodes: int, device: torch.device):
        key = (n_nodes, device)
        if key not in self._index:
            nodes = torch.arange(n_nodes, dtype=torch.int32, device=device)
            self._index = {key: _query_index(self.params, nodes)}
        return self._index[key]

    def _median(self, counters: torch.Tensor, n_nodes: int) -> torch.Tensor:
        flat, signs = self._node_index(n_nodes, counters.device)
        return median_over_tables(_estimates(counters, flat, signs))

    def undirected(self, edges: EdgeList, w_alive: torch.Tensor, lanes=None):
        """One shared two-endpoint counter table (one K2 launch a lane)."""

        def one(e, w):
            return (self._median(sketch_degrees_from_edges(self.params, e, w), e.n_nodes),)

        if lanes is None:
            return one(edges, w_alive)[0], w_alive.sum()
        return lanes.per_lane(w_alive, one)[0], w_alive.sum(-1)

    def directed(self, edges: EdgeList, w_alive: torch.Tensor, lanes=None):
        """Separate out and in tables (src endpoints only / dst endpoints
        only), so each side's estimate stays unbiased: two K2 launches a
        lane, and both medians share the cached query index."""

        def one(e, w):
            c_out = sketch_endpoint_counters(self.params, e.src, w)
            c_in = sketch_endpoint_counters(self.params, e.dst, w)
            return self._median(c_out, e.n_nodes), self._median(c_in, e.n_nodes)

        if lanes is None:
            return (*one(edges, w_alive), w_alive.sum())
        return (*lanes.per_lane(w_alive, one), w_alive.sum(-1))


def sketched_degree_fn(p: SketchParams):
    """``degree_fn(edges, w_alive) -> deg[N]`` over the sketch (for
    :class:`~repro_torch.core.engine.FnBackend`)."""

    def fn(edges: EdgeList, w_alive: torch.Tensor) -> torch.Tensor:
        counters = sketch_degrees_from_edges(p, edges, w_alive)
        nodes = torch.arange(edges.n_nodes, dtype=torch.int32, device=w_alive.device)
        return query_degrees(p, counters, nodes)

    return fn


def densest_subgraph_sketched(
    edges: EdgeList,
    eps: float = 0.5,
    t: int = 5,
    b: int = 1 << 13,
    seed: int = 0,
    max_passes: Optional[int] = None,
):
    """Algorithm 1 with Count-Sketch degrees (the paper's Table 4
    configuration), through the front door: ``backend='sketch'``."""
    from repro_torch.core.api import Problem, solve

    problem = Problem.undirected(
        eps=eps,
        max_passes=max_passes,
        track_history=True,
        backend="sketch",
        sketch_tables=t,
        sketch_buckets=b,
        sketch_seed=seed,
    )
    return solve(edges, problem)
