"""The port's front door (counterpart of ``repro.core.api``).

:class:`Problem` is the reference's spec, field for field, with the same
defaults and the same validation in :meth:`Problem.resolve`.  :func:`solve`
/ :class:`Solver` lower it onto the engine (core/engine.py) and run it on
the graph's device.  Cells of this slice:

    objective  undirected -> UndirectedThreshold(eps)             (Alg 1, §4.1)
    backend    exact      -> ExactBackend (index_add_)
               pallas     -> the hand-written tiled-degree kernel (kernels/peel_degree)
               sketch     -> SketchBackend (§5.1), its counters built by the
                             hand-written Count-Sketch kernel (kernels/count_sketch)
    substrate  jit        -> run_peel's host loop on one device
    compaction off | geometric | twophase  (Solver._run_compacted ladder)
    stream_mode turnstile -> core/turnstile.py: the ℓ0 sketch (kernels/l0_sampler)
                             and a peel of its recovered sample

Every other cell resolves and validates exactly as in the reference, then
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
The port keeps no program cache (PyTorch runs eagerly), so
``Provenance.cache_hit`` is always False.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import constants, hostsync
from repro_torch.core.density import max_passes_bound
from repro_torch.core.engine import (
    ExactBackend,
    PeelOutcome,
    RemovalPolicy,
    UndirectedThreshold,
    compact_edges,
    run_peel,
)
from repro_torch.graph.edgelist import EdgeList
from repro_torch.graph.partition import pow2_bucket

__all__ = ["DenseSubgraphResult", "Problem", "Provenance", "Solver", "solve"]

_OBJECTIVES = ("undirected", "at_least_k", "directed")
_BACKENDS = ("exact", "sketch", "pallas", "auto")
_SUBSTRATES = ("jit", "mesh", "streaming", "local", "auto")
_COMPACTIONS = ("off", "twophase", "geometric", "auto")
_STREAM_MODES = ("insert", "turnstile")

# Above this node count, "auto" picks the Count-Sketch backend.
_AUTO_SKETCH_NODES = 1_000_000

# Ladder floors, aliased so tests can patch them (as the reference's tests
# patch repro.core.api._COMPACT_MIN_EDGES).
_COMPACT_MIN_EDGES = constants.COMPACT_MIN_EDGES
_COMPACT_MIN_NODES = constants.COMPACT_MIN_NODES
_COMPACT_MAX_SEGMENTS = constants.COMPACT_MAX_SEGMENTS
_LOCAL_BUDGET = constants.LOCAL_BUDGET
_LOCAL_ROUNDS = constants.LOCAL_ROUNDS


@dataclasses.dataclass(frozen=True)
class Problem:
    """What to solve: the reference's ``repro.core.api.Problem``, with every
    field under the same name and default, so one spec runs on both
    packages.  See the reference for the full field reference; what the
    port reads:

    * ``objective``/``eps``/``max_passes``/``track_history`` — as in the
      reference (only ``'undirected'`` is ported).
    * ``backend`` — ``'exact'`` counts degrees with ``index_add_``;
      ``'pallas'`` means the hand-written tiled-degree kernel
      (kernels/peel_degree, CUDA on the card, its plain PyTorch version on
      a CPU tensor).
    * ``tile_size`` — node-tile width of that kernel: its shared-memory
      histogram holds ``tile_size`` floats.
    * ``tile_block``/``pallas_interpret`` — accepted and validated for spec
      compatibility; they steer nothing.  The ragged tile layout has no
      block padding, and dispatch follows only the tensor's device.
    * ``compaction``/``twophase_passes`` — the ladder schedule, as in the
      reference.
    * ``sketch_tables``/``sketch_buckets``/``sketch_seed`` — the §5.1
      Count-Sketch geometry of ``backend='sketch'`` (what ``'auto'`` picks
      above 1M nodes); its counters are built by the hand-written kernel
      (kernels/count_sketch) on the card.
    * ``stream_mode``/``sample_edges`` — ``'turnstile'`` solves through the
      ℓ0-sketch runtime (core/turnstile.py), ``sketch_seed`` seeding its
      hashes; the sample peel runs ``backend`` exact or pallas.

    The remaining fields belong to cells not ported yet; they are validated
    as in the reference.
    """

    objective: str = "undirected"
    eps: float = 0.5
    k: Optional[int] = None
    c: Optional[float] = None
    c_delta: float = 2.0
    backend: str = "exact"
    substrate: str = "jit"
    max_passes: Optional[int] = None
    track_history: bool = False
    compaction: str = "auto"
    twophase_passes: int = 8
    min_deg_fallback: bool = True
    ceil_count: bool = False
    sketch_tables: int = 5
    sketch_buckets: int = 1 << 13
    sketch_seed: int = 0
    sketch_node_chunk: int = 1 << 20
    tile_size: int = 1024
    tile_block: int = 512
    pallas_interpret: Optional[bool] = None
    edge_axes: Tuple[str, ...] = ("data",)
    wire_dtype: str = "f32"
    stream_chunk: int = 1 << 20
    stream_workers: int = 4
    stream_prefetch: int = 8
    spill_dir: Optional[str] = None
    residency_cap_edges: Optional[int] = None
    stream_mode: str = "insert"
    sample_edges: int = 1 << 14
    local_budget: int = _LOCAL_BUDGET
    local_rounds: int = _LOCAL_ROUNDS
    local_alpha: float = 1.0
    cache_dir: Optional[str] = None

    def __post_init__(self):
        if self.objective not in _OBJECTIVES:
            raise ValueError(f"objective={self.objective!r} not in {_OBJECTIVES}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend={self.backend!r} not in {_BACKENDS}")
        if self.substrate not in _SUBSTRATES:
            raise ValueError(f"substrate={self.substrate!r} not in {_SUBSTRATES}")
        if self.compaction not in _COMPACTIONS:
            raise ValueError(f"compaction={self.compaction!r} not in {_COMPACTIONS}")
        if self.twophase_passes < 1:
            raise ValueError(f"twophase_passes={self.twophase_passes} must be >= 1")
        if self.objective == "at_least_k" and (self.k is None or self.k < 1):
            raise ValueError("objective='at_least_k' needs k >= 1")
        if self.c_delta <= 1.0:
            raise ValueError(f"c_delta={self.c_delta} must be > 1 (geometric grid ratio)")
        if self.wire_dtype not in ("f32", "bf16"):
            raise ValueError(f"wire_dtype={self.wire_dtype!r} not in (f32, bf16)")
        if self.stream_prefetch < 1:
            raise ValueError(f"stream_prefetch={self.stream_prefetch} must be >= 1")
        if self.residency_cap_edges is not None and self.residency_cap_edges < 1:
            raise ValueError(
                f"residency_cap_edges={self.residency_cap_edges} must be >= 1"
            )
        if self.stream_mode not in _STREAM_MODES:
            raise ValueError(f"stream_mode={self.stream_mode!r} not in {_STREAM_MODES}")
        if self.sample_edges < 1:
            raise ValueError(f"sample_edges={self.sample_edges} must be >= 1")
        if self.local_budget < 1:
            raise ValueError(f"local_budget={self.local_budget} must be >= 1")
        if self.local_rounds < 1:
            raise ValueError(f"local_rounds={self.local_rounds} must be >= 1")
        if self.local_alpha < 0:
            raise ValueError(f"local_alpha={self.local_alpha} must be >= 0")
        if not isinstance(self.edge_axes, tuple):
            object.__setattr__(self, "edge_axes", tuple(self.edge_axes))

    @classmethod
    def undirected(cls, eps: float = 0.5, **kw) -> "Problem":
        """Algorithm 1: (2+2eps)-approximate densest subgraph."""
        return cls(objective="undirected", eps=float(eps), **kw)

    @classmethod
    def at_least_k(cls, k: int, eps: float = 0.5, **kw) -> "Problem":
        """Algorithm 2: (3+3eps)-approximate densest subgraph, |S| >= k."""
        return cls(objective="at_least_k", k=int(k), eps=float(eps), **kw)

    @classmethod
    def directed(cls, c: Optional[float] = None, eps: float = 0.5, **kw) -> "Problem":
        """Algorithm 3: directed densest subgraph, fixed c or c-grid."""
        return cls(
            objective="directed", c=None if c is None else float(c), eps=float(eps), **kw
        )

    def resolve(self, n_nodes: int) -> "Problem":
        """Resolves the ``auto`` axes against the graph and validates the
        requested cell, exactly as the reference does without a mesh:
        ``substrate='auto'`` is ``'jit'`` (the port has no mesh yet)."""
        if self.stream_mode == "turnstile":
            if self.objective != "undirected":
                raise ValueError(
                    "stream_mode='turnstile' implements Algorithm 1 over the MTVV "
                    "edge sample; use objective='undirected'"
                )
            if self.backend == "sketch":
                raise ValueError(
                    "backend='sketch' under stream_mode='turnstile' would sketch a "
                    "sketch; use backend='exact' or 'pallas'"
                )
            if self.substrate in ("mesh", "streaming", "local"):
                raise ValueError(
                    "stream_mode='turnstile' is its own runtime on the jit "
                    "substrate; use substrate='jit' or 'auto'"
                )
            return dataclasses.replace(
                self,
                backend="exact" if self.backend == "auto" else self.backend,
                substrate="jit",
                compaction="off",
            )
        if self.substrate == "local":
            if self.objective != "undirected":
                raise ValueError(
                    "substrate='local' prunes its frontier against the undirected "
                    "density; use objective='undirected'"
                )
            if self.backend in ("sketch", "pallas"):
                raise ValueError(
                    "substrate='local' peels a budget-bounded candidate subgraph; "
                    "use backend='exact' (or 'auto')"
                )
            return dataclasses.replace(
                self,
                backend="exact" if self.backend == "auto" else self.backend,
                compaction="off",
            )
        backend = self.backend
        substrate = "jit" if self.substrate == "auto" else self.substrate
        if backend == "auto":
            if substrate == "streaming":
                backend = "exact"
            elif self.compaction in ("geometric", "twophase"):
                backend = "exact"
            else:
                backend = "sketch" if n_nodes > _AUTO_SKETCH_NODES else "exact"
        compaction = self.compaction
        if compaction == "auto":
            compaction = "geometric" if backend in ("exact", "pallas") else "off"
        p = dataclasses.replace(
            self, backend=backend, substrate=substrate, compaction=compaction
        )
        if p.compaction != "off" and p.backend == "sketch":
            raise ValueError(
                "compaction renumbers node ids, which changes Count-Sketch degree "
                "estimates; backend='sketch' needs compaction='off'"
            )
        if p.compaction == "twophase" and p.substrate == "streaming":
            raise ValueError(
                "the streaming driver compacts geometrically; use "
                "compaction='geometric' or 'off' with substrate='streaming'"
            )
        if p.spill_dir is not None and p.substrate == "streaming" and p.compaction != "geometric":
            raise ValueError(
                "spill_dir is the streaming ladder's disk spill; a streaming solve "
                "needs compaction='geometric' (or 'auto') to use it"
            )
        if p.objective == "directed" and p.backend == "pallas":
            raise ValueError(
                "the tiled-degree kernel counts both endpoints (undirected); "
                "directed objectives need backend='exact' or 'sketch'"
            )
        if p.substrate == "mesh" and p.backend == "pallas":
            raise ValueError("backend='pallas' has no mesh cell yet")
        if p.substrate == "streaming" and (
            p.objective != "undirected" or p.backend != "exact"
        ):
            raise ValueError(
                "the streaming substrate implements Algorithm 1 with exact chunked "
                "degrees; use objective='undirected', backend='exact'"
            )
        return p

    def resolved_max_passes(self, n_nodes: int) -> int:
        """Static trip count: explicit, or the Lemma 4 bound (doubled for
        directed runs, Lemma 13)."""
        if self.max_passes is not None:
            return int(self.max_passes)
        bound = max_passes_bound(n_nodes, self.eps)
        return 2 * bound if self.objective == "directed" else bound


def _require_ported(prob: Problem) -> None:
    """Raises for a resolved cell this slice of the port does not run."""
    missing = None
    if prob.substrate == "local":
        missing = "substrate='local' (ROADMAP Queue 1 item 7)"
    elif prob.substrate == "streaming":
        missing = "substrate='streaming' (ROADMAP Queue 1 item 5)"
    elif prob.substrate == "mesh":
        missing = "substrate='mesh' (ROADMAP Queue 1 item 6)"
    elif prob.objective != "undirected":
        missing = f"objective={prob.objective!r} (ROADMAP Queue 1 item 3)"
    if missing is not None:
        raise NotImplementedError(f"{missing} is not ported to PyTorch yet")


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Which cell of the policy × backend × substrate matrix ran."""

    objective: str
    policy: str
    backend: str
    substrate: str
    n_nodes: int
    max_passes: int
    batch: Optional[str] = None
    cache_hit: bool = False
    compaction: str = "off"


@dataclasses.dataclass(frozen=True)
class DenseSubgraphResult:
    """The result of :func:`solve`: the engine's outcome tensors (on the
    graph's device) plus the provenance of the cell that ran."""

    best_alive: torch.Tensor  # bool[N] the output set S~
    best_density: torch.Tensor  # float32[] rho of the best set
    best_size: torch.Tensor  # int32[] |S~|
    passes: int  # passes executed
    alive: torch.Tensor  # bool[N] final S bitmap
    history_n: torch.Tensor  # int32[hist] per-pass |S| (-1 padding)
    history_m: torch.Tensor  # float32[hist] per-pass alive edge weight
    history_rho: torch.Tensor  # float32[hist] per-pass rho
    extras: Optional[Dict[str, Any]] = None
    provenance: Optional[Provenance] = None

    @classmethod
    def from_outcome(
        cls,
        out: PeelOutcome,
        provenance: Optional[Provenance] = None,
        extras: Optional[Dict[str, Any]] = None,
    ) -> "DenseSubgraphResult":
        return cls(*out, extras=extras, provenance=provenance)

    def nodes(self) -> np.ndarray:
        """Node ids of the best set (host side)."""
        return np.nonzero(self.best_alive.cpu().numpy())[0]

    @property
    def density(self) -> float:
        return float(self.best_density)


def _policy_for(problem: Problem) -> RemovalPolicy:
    """Problem -> RemovalPolicy (Algorithm 1 is the only ported objective)."""
    return UndirectedThreshold(problem.eps)


def _backend_for(problem: Problem, edges: EdgeList):
    """Problem -> DegreeBackend for one edge buffer.  The pallas backend
    first buckets the buffer's slots into its ragged tiling (on the
    buffer's device), once per buffer; the sketch backend draws its hash
    parameters from ``sketch_seed``, as the reference does."""
    if problem.backend == "exact":
        return ExactBackend()
    if problem.backend == "sketch":
        from repro_torch.core.countsketch import SketchBackend, make_sketch_params

        return SketchBackend(
            make_sketch_params(problem.sketch_tables, problem.sketch_buckets, problem.sketch_seed)
        )
    if problem.backend == "pallas":
        from repro_torch.kernels.peel_degree.ops import (
            degree_backend_from_tiling,
            tiling_for_edges,
        )

        return degree_backend_from_tiling(tiling_for_edges(edges, tile_size=problem.tile_size))
    raise ValueError(f"unresolved backend {problem.backend!r}")


class Solver:
    """Runs Problems.  Stateless in the port: there is no program cache."""

    def solve(self, graph: EdgeList, problem: Problem) -> DenseSubgraphResult:
        """Runs one Problem on one graph, on ``graph.device``::

            res = Solver().solve(edges, Problem.undirected(eps=0.5))
            rho = float(res.best_density)
            nodes = res.nodes()
        """
        if not isinstance(graph, EdgeList):
            raise TypeError(f"solve() takes an EdgeList graph, got {type(graph).__name__}")
        prob = problem.resolve(graph.n_nodes)
        _require_ported(prob)
        if prob.stream_mode == "turnstile":
            return self._solve_turnstile(graph, prob)
        n = graph.n_nodes
        mp = prob.resolved_max_passes(n)
        if prob.compaction in ("geometric", "twophase"):
            out, ladder = self._run_compacted(graph, prob)
            return self._wrap(out, prob, n, mp, extras={"compaction": ladder})
        backend = _backend_for(prob, graph)
        out = run_peel(graph, _policy_for(prob), backend, mp,
                       track_history=prob.track_history)
        return self._wrap(out, prob, n, mp)

    def _run_compacted(
        self, graph: EdgeList, prob: Problem
    ) -> Tuple[PeelOutcome, Dict[str, Any]]:
        """The geometric-compaction ladder, on the graph's device: runs the
        engine loop in segments and gathers the survivors (edges and nodes)
        into the next power-of-two buffer whenever the alive edge count
        falls below half the current buffer.  The schedule is the
        reference's (``repro.core.api.Solver._run_compacted``): the same
        ``compact_below``, the same buckets, the strict ``>`` earliest-wins
        merge of the best set and history indexed by absolute pass, so the
        result is bit-identical to ``compaction='off'`` for integer-valued
        weights.  ``'twophase'`` compacts once, after ``twophase_passes``.

        The gather and relabel are prefix sums on the device
        (:func:`~repro_torch.core.engine.compact_edges`), and so is the next
        rung's tiling; the host reads a few scalars per rung.
        """
        dev = graph.device
        n0 = graph.n_nodes
        mp = prob.resolved_max_passes(n0)
        policy = _policy_for(prob)
        src, dst, w, msk = graph.src, graph.dst, graph.weight, graph.mask
        id_map = torch.arange(n0, device=dev)  # compact id -> original id
        n_cur = n0
        s_al = torch.ones(n0, dtype=torch.bool, device=dev)

        hist_len = mp if prob.track_history else 1
        hist_n = torch.full((hist_len,), -1, dtype=torch.int32, device=dev)
        hist_m = torch.zeros(hist_len, dtype=torch.float32, device=dev)
        hist_rho = torch.zeros(hist_len, dtype=torch.float32, device=dev)
        best_rho = float("-inf")
        best_density = torch.tensor(best_rho, dtype=torch.float32, device=dev)
        # S_0 seeds the best set, as in the uncompacted loop.
        best_alive = torch.ones(n0, dtype=torch.bool, device=dev)
        best_size = torch.tensor(0, dtype=torch.int32, device=dev)
        t_done = 0
        segments = []
        slots_scanned = 0
        cur_alive_edges = msk.sum()
        twophase = prob.compaction == "twophase"
        tp_k1 = min(int(prob.twophase_passes), mp)
        no_more_compact = False

        for seg_idx in range(_COMPACT_MAX_SEGMENTS):
            seg_mp = tp_k1 if (twophase and seg_idx == 0) else mp
            compact_below = None
            if prob.compaction == "geometric" and not no_more_compact:
                compact_below = max(len(src) // 2, 1)

            edges = EdgeList(src=src, dst=dst, weight=w, mask=msk,
                             n_nodes=n_cur, directed=graph.directed)
            backend = _backend_for(prob, edges)
            out = run_peel(
                edges, policy, backend, seg_mp, track_history=prob.track_history,
                init_alive=s_al, init_t=t_done, init_best_empty=True,
                compact_below=compact_below, init_alive_edges=cur_alive_edges,
                init_ok_from_mask=True,
            )

            # ---- fold the segment into the global answer ----
            t_prev, t_done = t_done, out.passes
            s_al = out.alive
            ok_e = msk & s_al[src] & s_al[dst]
            seg_rho, n_alive, e_alive = hostsync.read(torch.stack([
                out.best_density.double(), s_al.sum().double(), ok_e.sum().double(),
            ]))
            n_alive, e_alive = int(n_alive), int(e_alive)
            if seg_rho > best_rho:  # strict: the earliest pass wins ties
                best_rho = seg_rho
                best_density = out.best_density
                best_alive = torch.zeros(n0, dtype=torch.bool, device=dev)
                best_alive[id_map] = out.best_alive[: len(id_map)]
                best_size = out.best_size
            if prob.track_history:
                shn = out.history_n
                sel = shn >= 0
                k = len(shn)
                hist_n[:k] = torch.where(sel, shn, hist_n[:k])
                hist_m[:k] = torch.where(sel, out.history_m, hist_m[:k])
                hist_rho[:k] = torch.where(sel, out.history_rho, hist_rho[:k])
            m_buf = len(src)
            slots_scanned += (t_done - t_prev) * m_buf
            segments.append({
                "n_buf": int(n_cur),
                "m_buf": int(m_buf),
                "passes": int(t_done - t_prev),
                "compact_below": compact_below,
                "cache_hit": False,
            })

            # ---- terminated? ----
            if t_done >= mp or n_alive == 0:
                break

            # ---- compact survivors into the next bucket ----
            new_m = pow2_bucket(max(e_alive, 1), _COMPACT_MIN_EDGES)
            new_n = pow2_bucket(max(n_alive, 1), _COMPACT_MIN_NODES)
            if new_m >= len(src) and new_n >= n_cur:
                no_more_compact = True  # bucket floor: finish on this buffer
                continue
            relabel = torch.cumsum(s_al, 0, dtype=torch.int64) - 1  # keeps id order
            src, dst, w = compact_edges(
                ok_e, (relabel[src].to(torch.int32), relabel[dst].to(torch.int32), w),
                new_m,
            )
            msk = torch.arange(new_m, device=dev) < e_alive
            # id_map covers the real ids only; pad nodes are never alive.
            (id_map,) = compact_edges(s_al[: len(id_map)], (id_map,), n_alive)
            s_al = torch.arange(new_n, device=dev) < n_alive
            n_cur = new_n
            cur_alive_edges = e_alive
        else:
            raise RuntimeError(f"compaction ladder exceeded {_COMPACT_MAX_SEGMENTS} segments")

        alive_full = torch.zeros(n0, dtype=torch.bool, device=dev)
        alive_full[id_map] = s_al[: len(id_map)]
        outcome = PeelOutcome(
            best_alive=best_alive,
            best_density=best_density,
            best_size=best_size,
            passes=t_done,
            alive=alive_full,
            history_n=hist_n,
            history_m=hist_m,
            history_rho=hist_rho,
        )
        ladder = {
            "mode": prob.compaction,
            "segments": segments,
            "edge_slots_scanned": int(slots_scanned),
            "passes": int(t_done),
            "single_program": False,
            "host_round_trips": len(segments),
        }
        return outcome, ladder

    def _solve_turnstile(self, graph: EdgeList, prob: Problem) -> DenseSubgraphResult:
        """One-shot turnstile solve, as the reference lowers
        ``Problem(stream_mode='turnstile')``: a
        :class:`~repro_torch.core.turnstile.TurnstileDensest` on the
        graph's device takes every real edge as one insert batch and
        answers one query."""
        from repro_torch.core.turnstile import TurnstileDensest

        if graph.directed:
            raise ValueError("stream_mode='turnstile' needs an undirected graph")
        if not hostsync.read(torch.all(graph.weight[graph.mask] == 1.0)):
            raise ValueError(
                "stream_mode='turnstile' streams are unweighted edge SETS "
                "(the ℓ0 sample has no weight field); got non-unit weights"
            )
        td = TurnstileDensest(graph.n_nodes, prob, solver=self, device=graph.device)
        td.apply(insert_edges=(graph.src[graph.mask], graph.dst[graph.mask]))
        return td.query()

    def _wrap(
        self,
        out: PeelOutcome,
        problem: Problem,
        n_nodes: int,
        mp: int,
        extras: Optional[Dict[str, Any]] = None,
    ) -> DenseSubgraphResult:
        prov = Provenance(
            objective=problem.objective,
            policy="undirected_threshold",
            backend=problem.backend,
            substrate=problem.substrate,
            n_nodes=n_nodes,
            max_passes=mp,
            compaction=problem.compaction,
        )
        return DenseSubgraphResult.from_outcome(out, provenance=prov, extras=extras)


default_solver = Solver()


def solve(graph: EdgeList, problem: Problem) -> DenseSubgraphResult:
    """Module-level :meth:`Solver.solve`."""
    return default_solver.solve(graph, problem)
