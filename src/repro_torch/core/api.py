"""The port's front door (counterpart of ``repro.core.api``).

:class:`Problem` is the reference's spec, field for field, with the same
defaults and the same validation in :meth:`Problem.resolve`.  :func:`solve`
/ :class:`Solver` lower it onto the engine (core/engine.py) and run it on
the graph's device; :func:`solve_batch` runs eps, c and stacked-graph
sweeps as one peel loop with a lane axis.  Cells of this slice:

    objective  undirected -> UndirectedThreshold(eps)             (Alg 1, §4.1)
               at_least_k -> AtLeastKFraction(k, eps)             (Alg 2, §4.2)
               directed   -> DirectedST(eps, c); c=None runs the
                             geometric c grid                     (Alg 3, §4.3)
    backend    exact      -> ExactBackend (index_add_)
               pallas     -> the hand-written tiled-degree kernel (kernels/peel_degree)
               sketch     -> SketchBackend (§5.1), its counters built by the
                             hand-written Count-Sketch kernel (kernels/count_sketch)
    substrate  jit        -> run_peel's host loop on one device
               mesh       -> core/mapreduce.py (§5.2): edges sharded over the
                             ranks of ``solve(..., mesh=)``, node state on
                             every rank, one all_reduce a pass (the
                             MeshSegmentSumBackend, or K2's counters for
                             the sketch); geometric compaction is the
                             collective-only ladder
               local      -> core/local.py: Andersen's pruned-frontier
                             exploration around ``solve(..., seed=)`` on
                             the host, then a jit solve of the padded
                             candidate subgraph on the graph's device
    compaction off | geometric | twophase  (Solver._run_compacted ladder)
               streaming  -> core/streaming.py: the semi-streaming driver,
                             edges chunked from the host, O(n) node state
                             on the graph's device (``checkpoint_dir``/
                             ``resume`` of solve())
    stream_mode turnstile -> core/turnstile.py: the ℓ0 sketch (kernels/l0_sampler)
                             and a peel of its recovered sample

Every substrate of the reference runs.  The port keeps no program cache
(PyTorch runs eagerly), so ``Provenance.cache_hit`` is always False.
What a fresh process pays for instead is building the kernels:
``Solver(cache_dir=...)`` (or ``Problem.cache_dir``) points the kernels
its solves load first at a persistent cache of built libraries
(core/progcache.py), and the Solver counts its lookups in
``disk_hits``/``disk_misses``/``disk_store_errors``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import constants, hostsync, kernels
from repro_torch.core.density import max_passes_bound
from repro_torch.core.engine import (
    AtLeastKFraction,
    DirectedST,
    ExactBackend,
    PeelOutcome,
    RemovalPolicy,
    UndirectedThreshold,
    compact_edges,
    run_peel,
)
from repro_torch.graph.edgelist import EdgeList
from repro_torch.graph.partition import ladder_schedule, pow2_bucket

__all__ = [
    "DenseSubgraphResult", "Problem", "Provenance", "Solver", "c_grid", "default_solver",
    "run_cell", "solve", "solve_batch", "stack_graphs",
]

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
_LADDER_STRIDE = constants.LADDER_STRIDE
_LADDER_MIN_EDGES = constants.LADDER_MIN_EDGES
_LOCAL_BUDGET = constants.LOCAL_BUDGET
_LOCAL_ROUNDS = constants.LOCAL_ROUNDS


@dataclasses.dataclass(frozen=True)
class Problem:
    """What to solve: the reference's ``repro.core.api.Problem``, with every
    field under the same name and default, so one spec runs on both
    packages.  See the reference for the full field reference; what the
    port reads:

    * ``objective``/``eps``/``k``/``c``/``c_delta``/``min_deg_fallback``/
      ``ceil_count``/``max_passes``/``track_history`` — as in the reference
      (all three objectives; ``c=None`` is the geometric c grid of ratio
      ``c_delta``).
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
    * ``stream_chunk``/``stream_workers``/``stream_prefetch``/``spill_dir``/
      ``residency_cap_edges`` — the streaming substrate's chunk size,
      worker pool, pipeline window, disk spill and host residency bound
      (core/streaming.py).
    * ``edge_axes``/``wire_dtype``/``sketch_node_chunk`` — the mesh
      substrate's shard axes (dimension names of the mesh), the dtype of
      its per-pass degree reduction (``'bf16'`` halves it), and the node
      chunk of the mesh sketch's degree queries (core/mapreduce.py).
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

    def resolve(self, n_nodes: int, have_mesh: bool = False) -> "Problem":
        """Resolves the ``auto`` axes against the graph and validates the
        requested cell, as the reference does.  ``substrate='auto'`` picks
        the mesh only when the caller supplied one that spans more than one
        rank (``have_mesh``; the reference's rule is a mesh and more than
        one visible device), else ``'jit'``."""
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
        substrate = self.substrate
        if substrate == "auto":
            substrate = "mesh" if have_mesh else "jit"
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
            raise ValueError("backend='pallas' has no mesh (shard_map) cell yet")
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


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Which cell of the policy × backend × substrate matrix ran."""

    objective: str
    policy: str
    backend: str
    substrate: str
    n_nodes: int
    max_passes: int
    batch: Optional[str] = None  # None | "eps" | "c" | "graphs"
    cache_hit: bool = False
    compaction: str = "off"


@dataclasses.dataclass(frozen=True)
class DenseSubgraphResult:
    """The result of :func:`solve` / :func:`solve_batch`: the engine's
    outcome tensors (on the graph's device), in the reference's field
    order, plus the provenance of the cell that ran.  A sweep's arrays have
    a leading lane axis and ``passes`` is a list, one count a lane.
    ``extras`` holds host data (the ladder's report, the c grid's
    per-c profile)."""

    best_alive: torch.Tensor  # bool[N] the output set S~ (S side for directed)
    best_t: torch.Tensor  # bool[N] T side (directed) | bool[0]
    best_density: torch.Tensor  # float32[] rho of the best set
    best_size: torch.Tensor  # int32[] |S~|
    passes: Union[int, List[int]]  # passes executed
    alive: torch.Tensor  # bool[N] final S bitmap
    t_alive: torch.Tensor  # bool[N] final T bitmap | bool[0]
    history_n: torch.Tensor  # int32[hist] per-pass |S| (-1 padding)
    history_m: torch.Tensor  # float32[hist] per-pass alive edge weight
    history_rho: torch.Tensor  # float32[hist] per-pass rho
    extras: Optional[Dict[str, Any]] = None
    provenance: Optional[Provenance] = None

    @property
    def best_s(self) -> torch.Tensor:
        """Directed-result spelling of the S-side best bitmap."""
        return self.best_alive

    @property
    def mask(self) -> torch.Tensor:
        return self.best_alive

    @classmethod
    def from_outcome(
        cls,
        out: PeelOutcome,
        provenance: Optional[Provenance] = None,
        extras: Optional[Dict[str, Any]] = None,
    ) -> "DenseSubgraphResult":
        return cls(*out, extras=extras, provenance=provenance)

    def nodes(self) -> np.ndarray:
        """Node ids of the best set (S side for directed; host side)."""
        return np.nonzero(hostsync.fetch(self.best_alive))[0]

    def t_nodes(self) -> np.ndarray:
        """Node ids of the best T side (directed results; host side)."""
        return np.nonzero(hostsync.fetch(self.best_t))[0]

    @property
    def density(self) -> float:
        return float(self.best_density)


def _policy_for(problem: Problem, *, eps: Any = None, c: Any = None) -> RemovalPolicy:
    """Problem -> RemovalPolicy.  ``eps``/``c`` override the Problem's with
    ``[B]`` f32 tensors on the graph's device in a sweep.  A fixed ``c``
    becomes a 0-dim f32 CPU tensor: the reference's ``float32`` c, which
    device ops take as a scalar argument (no copy to the card)."""
    e = problem.eps if eps is None else eps
    if problem.objective == "undirected":
        return UndirectedThreshold(e)
    if problem.objective == "at_least_k":
        return AtLeastKFraction(
            k=problem.k,
            eps=e,
            min_deg_fallback=problem.min_deg_fallback,
            ceil_count=problem.ceil_count,
        )
    cc = problem.c if c is None else c
    if cc is None:
        raise ValueError(
            "directed lowering needs a concrete or per-lane c; Problem.c=None "
            "(grid search) is handled by solve()/solve_batch()"
        )
    if not isinstance(cc, torch.Tensor):
        cc = torch.tensor(cc, dtype=torch.float32)
    return DirectedST(eps=e, c=cc)


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


def run_cell(
    edges: EdgeList,
    problem: Problem,
    *,
    eps: Any = None,
    c: Any = None,
    backend: Any = None,
    max_passes: Optional[int] = None,
    init_alive: Optional[torch.Tensor] = None,
    init_t_alive: Optional[torch.Tensor] = None,
    init_t: Optional[int] = None,
    init_best_empty: bool = False,
    compact_below: Optional[int] = None,
    init_alive_edges: Union[int, torch.Tensor, None] = None,
    init_ok_from_mask: bool = False,
    lanes: Optional[int] = None,
) -> PeelOutcome:
    """One Problem cell -> ``run_peel``: the lowering every path of the
    front door bottoms out in (the reference's ``run_cell``).  ``eps``/``c``
    may be a sweep's ``[B]`` tensors (with ``lanes=B``); ``backend`` is a
    DegreeBackend built once by the caller (a rung's tiling, the sketch's
    cached query index, a ``degree_fn`` hook's ``FnBackend``).  The
    segment controls are forwarded to
    :func:`~repro_torch.core.engine.run_peel`; ``run_cell`` itself is one
    segment (``Problem.compaction`` is ignored here)."""
    prob = problem.resolve(edges.n_nodes)
    mp = max_passes if max_passes is not None else prob.resolved_max_passes(edges.n_nodes)
    if backend is None:
        backend = _backend_for(prob, edges)
    return run_peel(
        edges, _policy_for(prob, eps=eps, c=c), backend, mp,
        track_history=prob.track_history, init_alive=init_alive,
        init_t_alive=init_t_alive, init_t=init_t, init_best_empty=init_best_empty,
        compact_below=compact_below, init_alive_edges=init_alive_edges,
        init_ok_from_mask=init_ok_from_mask, lanes=lanes,
    )


def c_grid(n_nodes: int, delta: float = 2.0) -> np.ndarray:
    """Geometric grid of c = |S|/|T| guesses: delta^j covering [1/n, n]."""
    j_max = int(math.ceil(math.log(max(n_nodes, 2)) / math.log(delta)))
    return np.asarray([delta**j for j in range(-j_max, j_max + 1)], np.float32)


def stack_graphs(graphs: Sequence[EdgeList]) -> EdgeList:
    """Stacks same-shape EdgeLists along a leading lane axis for
    :meth:`Solver.solve_batch` (which also accepts the sequence directly).
    The result is a batched container: per-graph helpers that assume 1-D
    edge arrays (``n_edges_padded``, ``with_padding``) don't apply to it."""
    g0 = graphs[0]
    for g in graphs[1:]:
        if g.n_nodes != g0.n_nodes or g.n_edges_padded != g0.n_edges_padded:
            raise ValueError(
                "stacked sweeps need same-shape graphs: got "
                f"(n={g.n_nodes}, E={g.n_edges_padded}) vs "
                f"(n={g0.n_nodes}, E={g0.n_edges_padded})"
            )
        if g.directed != g0.directed:
            raise ValueError("stacked sweeps need uniform directedness")
    return EdgeList(
        src=torch.stack([g.src for g in graphs]),
        dst=torch.stack([g.dst for g in graphs]),
        weight=torch.stack([g.weight for g in graphs]),
        mask=torch.stack([g.mask for g in graphs]),
        n_nodes=g0.n_nodes,
        directed=g0.directed,
    )


def _host_keep_going(prob: Problem, n_s: int, n_t: int) -> bool:
    """Host mirror of the policies' ``keep_going`` tests: the ladder asks it
    whether a segment ended by termination or by its compaction trigger."""
    if prob.objective == "at_least_k":
        return n_s >= int(prob.k)
    if prob.objective == "directed":
        return n_s > 0 and n_t > 0
    return n_s > 0


def _policy_name(problem: Problem) -> str:
    return {
        "undirected": "undirected_threshold",
        "at_least_k": "at_least_k_fraction",
        "directed": "directed_st",
    }[problem.objective]


def _host_f32(values) -> np.ndarray:
    """A sweep axis as a flat float32 host array (lists, numpy or tensors)."""
    if isinstance(values, torch.Tensor):
        values = hostsync.fetch(values.detach())
    return np.asarray(values, np.float32).reshape(-1)


class Solver:
    """Runs Problems.  There is no program cache in the port (PyTorch runs
    eagerly); ``cache_dir`` is where the kernels that this Solver's solves
    load first are looked up and published (core/progcache.py), and
    ``disk_hits``/``disk_misses``/``disk_store_errors`` count those loads.
    ``Solver(cache_dir=...)`` wins over ``Problem.cache_dir``."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir
        self.disk_hits = 0
        self.disk_misses = 0
        self.disk_store_errors = 0

    def _disk_dir(self, problem: Problem) -> Optional[str]:
        """The effective cache directory: the Solver's own setting wins;
        otherwise the Problem's."""
        return self.cache_dir if self.cache_dir is not None else problem.cache_dir

    @contextlib.contextmanager
    def kernel_cache(self, problem: Problem):
        """Within the block, kernels load through this Solver's cache
        directory (if it or ``problem`` names one) and count here."""
        d = self._disk_dir(problem)
        if d is None:
            yield
            return
        with kernels.kernel_cache(d, self):
            yield

    def solve(
        self,
        graph: EdgeList,
        problem: Problem,
        *,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
        seed: Optional[int] = None,
    ) -> DenseSubgraphResult:
        """Runs one Problem on one graph, on ``graph.device``::

            res = Solver().solve(edges, Problem.undirected(eps=0.5))
            rho = float(res.best_density)
            nodes = res.nodes()
            res = Solver().solve(edges, Problem.directed())  # the c grid
            res.extras["best_c"], res.t_nodes()
            res = Solver().solve(edges, Problem(substrate="local"), seed=17)
            res = Solver().solve(edges, Problem(substrate="streaming"),
                                 checkpoint_dir="ck", resume=True)
            mesh = make_mesh((1,), ("data",))  # repro_torch.core.mapreduce
            res = Solver().solve(edges, Problem(substrate="mesh"), mesh=mesh)

        ``mesh`` (a ``DeviceMesh``, every rank passing the same full graph)
        is required by ``substrate='mesh'``; ``checkpoint_dir``/``resume``
        apply to, and only to, ``substrate='streaming'``; ``seed`` is
        required by, and only by, ``substrate='local'``: the node whose
        dense neighborhood is wanted.
        """
        if not isinstance(graph, EdgeList):
            raise TypeError(f"solve() takes an EdgeList graph, got {type(graph).__name__}")
        prob = problem.resolve(graph.n_nodes, have_mesh=mesh is not None and mesh.size() > 1)
        if prob.substrate != "streaming" and (checkpoint_dir is not None or resume):
            raise ValueError("checkpoint_dir/resume only apply to substrate='streaming'")
        with self.kernel_cache(prob):
            if prob.substrate == "local":
                if mesh is not None:
                    raise ValueError(
                        "substrate='local' is a host exploration + jit solve; "
                        "a mesh does not apply"
                    )
                return self._solve_local(graph, prob, seed)
            if seed is not None:
                raise ValueError(
                    "seed= is the substrate='local' per-seed query knob; "
                    f"substrate={prob.substrate!r} solves the whole graph"
                )
            if prob.substrate == "streaming":
                return self._solve_streaming(graph, prob, checkpoint_dir, resume)
            return self._solve(graph, prob, mesh)

    def _solve(self, graph: EdgeList, prob: Problem, mesh=None) -> DenseSubgraphResult:
        if prob.stream_mode == "turnstile":
            return self._solve_turnstile(graph, prob)
        if prob.compaction in ("geometric", "twophase"):
            return self._solve_compacted(graph, prob, mesh)
        if prob.substrate == "mesh":
            return self._solve_mesh(graph, prob, mesh)
        n = graph.n_nodes
        mp = prob.resolved_max_passes(n)
        backend = _backend_for(prob, graph)
        if prob.objective == "directed" and prob.c is None:
            return self._directed_grid(graph, prob, mp, lambda c: (
                run_cell(graph, prob, c=c, backend=backend, max_passes=mp), None))
        out = run_cell(graph, prob, backend=backend, max_passes=mp)
        return self._wrap(out, prob, n, mp)

    def _directed_grid(self, graph: EdgeList, prob: Problem, mp: int, run) -> DenseSubgraphResult:
        """The paper's practical directed recipe: the geometric c grid in a
        host loop, ``run(c) -> (outcome, ladder report or None)`` a c.  The
        best c is the first with the largest density (strict ``>``); its
        ladder report, if any, goes into ``extras['compaction']``."""
        grid = c_grid(graph.n_nodes, prob.c_delta)
        best = best_c = best_ladder = None
        best_rho = float("-inf")
        rhos, passes = [], []
        for cv in grid:
            out, ladder = run(float(cv))
            rho = hostsync.read(out.best_density)
            rhos.append(rho)
            passes.append(out.passes)
            if best is None or rho > best_rho:
                best, best_c, best_ladder, best_rho = out, float(cv), ladder, rho
        extras = {
            "best_c": best_c,
            "c_grid": np.asarray(grid),
            "c_density": np.asarray(rhos),
            "c_passes": np.asarray(passes),
        }
        if best_ladder is not None:
            extras["compaction"] = best_ladder
        return self._wrap(best, prob, graph.n_nodes, mp, extras=extras)

    def _solve_mesh(self, graph: EdgeList, prob: Problem, mesh) -> DenseSubgraphResult:
        """The uncompacted mesh substrate: this rank's shard of ``graph``
        through :meth:`mesh_program`'s peel, once or once a c of the grid
        (every rank reads the same reduced densities, so all pick the same
        best c)."""
        if mesh is None:
            raise ValueError("substrate='mesh' needs solve(..., mesh=Mesh)")
        from repro_torch.core.mapreduce import shard_edges

        sh = shard_edges(graph, mesh, prob.edge_axes)
        fn, mp = self._mesh_fn(prob, mesh, sh.n_nodes)
        args = (sh.src, sh.dst, sh.weight, sh.mask)
        if prob.objective == "directed" and prob.c is None:
            return self._directed_grid(sh, prob, mp, lambda c: (fn(*args, c), None))
        return self._wrap(fn(*args), prob, sh.n_nodes, mp)

    def _mesh_fn(self, prob: Problem, mesh, n_nodes: int):
        """``(fn, max_passes)`` for a resolved mesh Problem: ``fn(src, dst,
        weight, mask, c=None)`` runs the engine on this rank's shard with
        the mesh's backend (one ``all_reduce`` a pass)."""
        from repro_torch.core.mapreduce import check_mesh_device, mesh_backend

        mp = prob.resolved_max_passes(n_nodes)
        backend = mesh_backend(prob, mesh, n_nodes)

        def fn(src, dst, weight, mask, c=None) -> PeelOutcome:
            check_mesh_device(src.device, mesh)
            edges = EdgeList(src=src, dst=dst, weight=weight, mask=mask, n_nodes=n_nodes)
            return run_cell(edges, prob, c=c, backend=backend, max_passes=mp)

        return fn, mp

    def mesh_program(self, problem: Problem, mesh, n_nodes: int):
        """``fn(src, dst, weight, mask[, c]) -> PeelOutcome`` over this
        rank's shard (:func:`~repro_torch.core.mapreduce.shard_edges`): the
        lowering target of the ``make_distributed_*`` builders.  There is
        nothing to compile; the name and signature are the reference's."""
        fn, _ = self._mesh_fn(problem.resolve(n_nodes), mesh, n_nodes)
        return fn

    def mesh_ladder_program(
        self, problem: Problem, mesh, n_nodes: int, m_edges: int
    ) -> Tuple[Any, Tuple[int, ...], int]:
        """The collective mesh ladder for a graph of ``m_edges`` edge slots:
        ``(fn, schedule, n_shards)``, ``fn(src, dst, weight, mask[, c]) ->
        (PeelOutcome, rung_t)`` over this rank's shard of the edges padded
        to ``schedule[0] * n_shards``, ``rung_t`` the absolute pass count
        after each rung.  The schedule is the reference's: rung 0 the exact
        shard-rounded input, rung 1 ``pow2(ceil(m0/2))`` (the host ladder's
        half-occupancy trigger), then a stride-``_LADDER_STRIDE`` pow2 tail
        floored at ``_LADDER_MIN_EDGES // n_shards``.  The lowering target
        of ``make_distributed_peel_ladder`` and of ``solve()`` for mesh ×
        ``compaction='geometric'``."""
        from repro_torch.core.mapreduce import check_mesh_device, edge_shards

        prob = problem.resolve(n_nodes, have_mesh=True)
        n_shards = edge_shards(mesh, prob.edge_axes).count
        shard_m0 = -(-max(int(m_edges), 1) // n_shards)
        floor = pow2_bucket(max(1, _LADDER_MIN_EDGES // n_shards))
        half = pow2_bucket(-(-shard_m0 // 2), floor)
        tail = ladder_schedule(max(half // _LADDER_STRIDE, 1), floor=floor,
                               stride=_LADDER_STRIDE)
        schedule = (shard_m0,)
        schedule += (half,) if half < shard_m0 else ()
        # ladder_schedule lowers its floor to a smaller top; keep only tail
        # rungs at or above the real floor.
        schedule += tuple(cap for cap in tail if cap < schedule[-1] and cap >= floor)
        mp = prob.resolved_max_passes(n_nodes)

        def fn(src, dst, weight, mask, c=None):
            check_mesh_device(src.device, mesh)
            return self._mesh_ladder(prob, mp, mesh, n_nodes, schedule, n_shards,
                                     (src, dst, weight, mask), c)

        return fn, schedule, n_shards

    def _mesh_ladder(self, prob: Problem, mp: int, mesh, n_nodes: int,
                     schedule: Tuple[int, ...], n_shards: int, shard, c):
        """The reference's single-program ladder as a host loop over rungs,
        with no host gather or reshard: each rung is one engine segment
        whose reduced alive-edge trigger sits at the next rung's global
        capacity, so on exit its survivors fit there; they move with
        :func:`~repro_torch.core.mapreduce.mesh_compact_edges`.  Node
        bitmaps stay in the full id space, so per-pass node work stays
        O(n) on every rung (the host ladder renumbers nodes); compaction
        only re-buckets edges, so the result equals the host ladder's and
        ``compaction='off'``'s for integer-valued weights."""
        from repro_torch.core.mapreduce import mesh_backend, mesh_compact_edges

        src, dst, weight, mask = shard
        dev = src.device
        directed = prob.objective == "directed"
        backend = mesh_backend(prob, mesh, n_nodes)
        policy = _policy_for(prob, c=c)
        ones = torch.ones(n_nodes, dtype=torch.bool, device=dev)
        empty = torch.zeros(0, dtype=torch.bool, device=dev)
        alive, ta = ones, (ones if directed else empty)
        # The full set seeds the best, as the uncompacted loop's best0.
        best_alive, best_t = ones, (ones if directed else empty)
        best_rho = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        best_size = torch.zeros((), dtype=torch.int32, device=dev)
        t = 0
        # Rung 0's entry count: every masked edge has both ends alive.
        ae = backend.count_edges(mask)
        hist_len = mp if prob.track_history else 1
        hist_n = torch.full((hist_len,), -1, dtype=torch.int32, device=dev)
        hist_m = torch.zeros(hist_len, dtype=torch.float32, device=dev)
        hist_rho = torch.zeros(hist_len, dtype=torch.float32, device=dev)
        rung_t = []
        for i in range(len(schedule)):
            last = i == len(schedule) - 1
            out = run_peel(
                EdgeList(src=src, dst=dst, weight=weight, mask=mask, n_nodes=n_nodes),
                policy, backend, mp, track_history=prob.track_history,
                init_alive=alive, init_t_alive=ta if directed else None, init_t=t,
                init_best_empty=True,
                compact_below=None if last else schedule[i + 1] * n_shards,
                init_alive_edges=ae, init_ok_from_mask=True, with_edge_state=not last,
            )
            if not last:
                # The carried filter and its reduced count feed the compaction.
                out, edge_ok, ae = out
            alive, t = out.alive, out.passes
            if directed:
                ta = out.t_alive
            # Strict >: the earliest rung (pass) wins ties.
            improved = out.best_density > best_rho
            best_alive = torch.where(improved, out.best_alive, best_alive)
            if directed:
                best_t = torch.where(improved, out.best_t, best_t)
            best_rho = torch.where(improved, out.best_density, best_rho)
            best_size = torch.where(improved, out.best_size, best_size)
            if prob.track_history:
                # Absolute pass indexing: rungs write disjoint slots.
                sel = out.history_n >= 0
                hist_n = torch.where(sel, out.history_n, hist_n)
                hist_m = torch.where(sel, out.history_m, hist_m)
                hist_rho = torch.where(sel, out.history_rho, hist_rho)
            rung_t.append(t)
            if not last:
                src, dst, weight, mask = mesh_compact_edges(
                    src, dst, weight, edge_ok, ae, schedule[i + 1], mesh, prob.edge_axes)
        outcome = PeelOutcome(
            best_alive=best_alive, best_t=best_t, best_density=best_rho,
            best_size=best_size, passes=t, alive=alive, t_alive=ta,
            history_n=hist_n, history_m=hist_m, history_rho=hist_rho,
        )
        return outcome, rung_t

    def _mesh_ladder_runner(self, graph: EdgeList, prob: Problem, mesh):
        """mesh × ``'geometric'``: pads and shards the graph once, then
        returns ``run(c) -> (outcome, ladder report)`` over the collective
        ladder (the c grid reuses the shard).  The report has the
        reference's keys and values; ``single_program`` there means
        collective-only, with no host gather or reshard between rungs."""
        from repro_torch.core.mapreduce import shard_edges

        fn, schedule, n_shards = self.mesh_ladder_program(
            prob, mesh, graph.n_nodes, graph.n_edges_padded)
        sh = shard_edges(graph.with_padding(schedule[0] * n_shards), mesh, prob.edge_axes)

        def run(c: Optional[float]) -> Tuple[PeelOutcome, Dict[str, Any]]:
            out, rung_t = fn(sh.src, sh.dst, sh.weight, sh.mask, c)
            segments = []
            slots = prev = 0
            for i, cap in enumerate(schedule):
                m_buf = cap * n_shards
                passes, prev = rung_t[i] - prev, rung_t[i]
                slots += passes * m_buf
                segments.append({
                    "n_buf": int(graph.n_nodes),
                    "m_buf": m_buf,
                    "passes": passes,
                    "compact_below": (None if i == len(schedule) - 1
                                      else schedule[i + 1] * n_shards),
                    "cache_hit": False,
                })
            ladder = {
                "mode": prob.compaction,
                "segments": segments,
                "edge_slots_scanned": int(slots),
                "passes": int(out.passes),
                "single_program": True,
                "host_round_trips": 0,
                "schedule": [cap * n_shards for cap in schedule],
            }
            return out, ladder

        return run

    def _solve_compacted(self, graph: EdgeList, prob: Problem, mesh=None) -> DenseSubgraphResult:
        """solve() tail for ``compaction in ('geometric', 'twophase')``: the
        ladder once, or once a c of the grid.  mesh × geometric runs the
        collective ladder (:meth:`_mesh_ladder_runner`); everything else
        the host schedule (:meth:`_run_compacted`)."""
        if prob.substrate == "mesh" and mesh is None:
            raise ValueError("substrate='mesh' needs solve(..., mesh=Mesh)")
        if prob.substrate == "mesh" and prob.compaction == "geometric":
            run = self._mesh_ladder_runner(graph, prob, mesh)
        else:
            run = functools.partial(self._run_compacted, graph, prob, mesh=mesh)
        n = graph.n_nodes
        mp = prob.resolved_max_passes(n)
        if prob.objective == "directed" and prob.c is None:
            return self._directed_grid(graph, prob, mp, run)
        out, ladder = run(prob.c if prob.objective == "directed" else None)
        return self._wrap(out, prob, n, mp, extras={"compaction": ladder})

    def _run_compacted(
        self, graph: EdgeList, prob: Problem, c: Optional[float] = None, mesh=None
    ) -> Tuple[PeelOutcome, Dict[str, Any]]:
        """The geometric-compaction ladder, on the graph's device: runs the
        engine loop in segments and gathers the survivors (edges and nodes)
        into the next power-of-two buffer whenever the alive edge count
        falls below half the current buffer.  The schedule is the
        reference's (``repro.core.api.Solver._run_compacted``): the same
        ``compact_below``, the same buckets, the strict ``>`` earliest-wins
        merge of the best set(s) and history indexed by absolute pass, so
        the result is bit-identical to ``compaction='off'`` for
        integer-valued weights.  ``'twophase'`` compacts once, after
        ``twophase_passes``.  A directed run renumbers S and T together: a
        node alive on either side survives and keeps both bits.

        The gather and relabel are prefix sums on the device
        (:func:`~repro_torch.core.engine.compact_edges`), and so is the next
        rung's tiling; the host reads a few scalars per rung.

        With a ``mesh`` (``'twophase'``, or a direct call with
        ``'geometric'``) every rank holds the whole rung buffer and computes
        the same compaction; each rung then runs on this rank's block of
        it, and ``compact_below`` is half the sharded padded size.
        """
        dev = graph.device
        directed = prob.objective == "directed"
        n0 = graph.n_nodes
        mp = prob.resolved_max_passes(n0)
        src, dst, w, msk = graph.src, graph.dst, graph.weight, graph.mask
        id_map = torch.arange(n0, device=dev)  # compact id -> original id
        n_cur = n0
        s_al = torch.ones(n0, dtype=torch.bool, device=dev)
        t_al = s_al if directed else None

        hist_len = mp if prob.track_history else 1
        hist_n = torch.full((hist_len,), -1, dtype=torch.int32, device=dev)
        hist_m = torch.zeros(hist_len, dtype=torch.float32, device=dev)
        hist_rho = torch.zeros(hist_len, dtype=torch.float32, device=dev)
        best_rho = float("-inf")
        best_density = torch.full((), best_rho, dtype=torch.float32, device=dev)
        # S_0 (and T_0) seed the best set, as in the uncompacted loop.
        best_alive = torch.ones(n0, dtype=torch.bool, device=dev)
        empty = torch.zeros(0, dtype=torch.bool, device=dev)
        best_t = best_alive if directed else empty
        best_size = torch.zeros((), dtype=torch.int32, device=dev)
        t_done = 0
        segments = []
        slots_scanned = 0
        cur_alive_edges = msk.sum()
        twophase = prob.compaction == "twophase"
        tp_k1 = min(int(prob.twophase_passes), mp)
        no_more_compact = False

        def to_original(x: torch.Tensor) -> torch.Tensor:
            full = torch.zeros(n0, dtype=torch.bool, device=dev)
            full[id_map] = x[: len(id_map)]
            return full

        for seg_idx in range(_COMPACT_MAX_SEGMENTS):
            seg_mp = tp_k1 if (twophase and seg_idx == 0) else mp
            compact_below = None
            if prob.compaction == "geometric" and not no_more_compact:
                compact_below = max(len(src) // 2, 1)

            edges = EdgeList(src=src, dst=dst, weight=w, mask=msk,
                             n_nodes=n_cur, directed=graph.directed)
            m_buf = len(src)
            if mesh is None:
                backend = _backend_for(prob, edges)
            else:
                from repro_torch.core.mapreduce import edge_shards, mesh_backend, shard_edges

                edges = shard_edges(edges, mesh, prob.edge_axes)
                backend = mesh_backend(prob, mesh, n_cur)
                m_buf = len(edges.src) * edge_shards(mesh, prob.edge_axes).count
                if compact_below is not None:
                    compact_below = max(m_buf // 2, 1)
            out = run_cell(
                edges, prob, c=c, backend=backend, max_passes=seg_mp,
                init_alive=s_al, init_t_alive=t_al, init_t=t_done, init_best_empty=True,
                compact_below=compact_below, init_alive_edges=cur_alive_edges,
                init_ok_from_mask=True,
            )

            # ---- fold the segment into the global answer ----
            t_prev, t_done = t_done, out.passes
            s_al = out.alive
            t_al = out.t_alive if directed else None
            ta = t_al if directed else s_al
            surv = (s_al | t_al) if directed else s_al
            ok_e = msk & s_al[src] & ta[dst]
            vals = [out.best_density, s_al.sum(), ok_e.sum()]
            if directed:
                vals += [t_al.sum(), surv.sum()]
            got = hostsync.read(torch.stack([v.double() for v in vals]))
            seg_rho, n_s, e_alive = got[0], int(got[1]), int(got[2])
            n_t, n_alive = (int(got[3]), int(got[4])) if directed else (n_s, n_s)
            if seg_rho > best_rho:  # strict: the earliest pass wins ties
                best_rho = seg_rho
                best_density = out.best_density
                best_alive = to_original(out.best_alive)
                if directed:
                    best_t = to_original(out.best_t)
                best_size = out.best_size
            if prob.track_history:
                shn = out.history_n
                sel = shn >= 0
                k = len(shn)
                hist_n[:k] = torch.where(sel, shn, hist_n[:k])
                hist_m[:k] = torch.where(sel, out.history_m, hist_m[:k])
                hist_rho[:k] = torch.where(sel, out.history_rho, hist_rho[:k])
            slots_scanned += (t_done - t_prev) * m_buf
            segments.append({
                "n_buf": int(n_cur),
                "m_buf": int(m_buf),
                "passes": int(t_done - t_prev),
                "compact_below": compact_below,
                "cache_hit": False,
            })

            # ---- terminated? ----
            if t_done >= mp or not _host_keep_going(prob, n_s, n_t):
                break

            # ---- compact survivors into the next bucket ----
            new_m = pow2_bucket(max(e_alive, 1), _COMPACT_MIN_EDGES)
            new_n = pow2_bucket(max(n_alive, 1), _COMPACT_MIN_NODES)
            if new_m >= len(src) and new_n >= n_cur:
                no_more_compact = True  # bucket floor: finish on this buffer
                continue
            relabel = torch.cumsum(surv, 0, dtype=torch.int64) - 1  # keeps id order
            src, dst, w = compact_edges(
                ok_e, (relabel[src].to(torch.int32), relabel[dst].to(torch.int32), w),
                new_m,
            )
            msk = torch.arange(new_m, device=dev) < e_alive
            # id_map covers the real ids only; pad nodes are never alive.
            (id_map,) = compact_edges(surv[: len(id_map)], (id_map,), n_alive)
            if directed:
                s_al, t_al = compact_edges(surv, (s_al, t_al), new_n)
            else:
                s_al = torch.arange(new_n, device=dev) < n_alive
            n_cur = new_n
            cur_alive_edges = e_alive
        else:
            raise RuntimeError(f"compaction ladder exceeded {_COMPACT_MAX_SEGMENTS} segments")

        outcome = PeelOutcome(
            best_alive=best_alive,
            best_t=best_t,
            best_density=best_density,
            best_size=best_size,
            passes=t_done,
            alive=to_original(s_al),
            t_alive=to_original(t_al) if directed else empty,
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

    def _solve_local(self, graph: EdgeList, prob: Problem, seed) -> DenseSubgraphResult:
        """Andersen local substrate (``substrate='local'``): the
        pruned-frontier exploration around ``seed`` on the host
        (core/local.py), then the jit solve of the bucket-padded candidate
        subgraph, moved to the graph's device in one copy per leaf.

        The result's bitmaps are scattered back to the ORIGINAL id space on
        the graph's device, pad ids dropped (history and passes describe
        the padded candidate buffer); provenance reports
        ``substrate='local'`` and ``extras['local']`` carries the
        exploration counters.  A one-shot front door: the CSR is built on
        every call (a copy of the graph to the host); request-rate serving
        holds a :class:`repro_torch.serve.densest.DensestQueryEngine`
        instead, which builds it once."""
        from repro_torch.core.local import LocalExplorer

        if seed is None:
            raise ValueError(
                "substrate='local' answers per-seed queries: "
                "solve(graph, problem, seed=<node id>)"
            )
        explorer = LocalExplorer.from_edgelist(graph)
        padded, ex = explorer.extract(
            seed, budget=prob.local_budget, max_rounds=prob.local_rounds,
            alpha=prob.local_alpha,
        )
        dev = graph.device
        sub = self.solve(padded.to(dev), dataclasses.replace(prob, substrate="jit"))
        nodes = ex.candidates
        ids = torch.from_numpy(nodes).to(dev)

        def lift(bitmap: torch.Tensor) -> torch.Tensor:
            # Padded-buffer bitmap -> original id space; local ids past
            # len(nodes) are isolated pad nodes and are dropped.
            full = torch.zeros(graph.n_nodes, dtype=torch.bool, device=dev)
            full[ids] = bitmap[: len(nodes)]
            return full

        best_alive = lift(sub.best_alive)
        out = PeelOutcome(
            best_alive=best_alive,
            best_t=sub.best_t,
            best_density=sub.best_density,
            best_size=best_alive.sum(dtype=torch.int32),
            passes=sub.passes,
            alive=lift(sub.alive),
            t_alive=sub.t_alive,
            history_n=sub.history_n,
            history_m=sub.history_m,
            history_rho=sub.history_rho,
        )
        extras = {
            "local": {
                "seed": int(ex.seed),
                "candidates": nodes,
                "n_candidates": int(len(nodes)),
                "m_candidates": int(padded.mask.sum()),
                "rounds": int(ex.rounds),
                "nodes_touched": int(ex.nodes_touched),
                "edges_scanned": int(ex.edges_scanned),
                "frontier_exhausted": bool(ex.frontier_exhausted),
                "budget": int(prob.local_budget),
                "bucket": (int(padded.n_nodes), int(padded.n_edges_padded)),
            }
        }
        return self._wrap(out, prob, graph.n_nodes, sub.provenance.max_passes, extras=extras)

    def _solve_streaming(
        self, graph: EdgeList, prob: Problem, checkpoint_dir: Optional[str], resume: bool
    ) -> DenseSubgraphResult:
        """Semi-streaming substrate (the reference's ``_solve_streaming``):
        the graph's real edges come to the host once and stream from there
        in ``stream_chunk`` chunks through
        :class:`~repro_torch.core.streaming.StreamingDensest`, its node
        state on the graph's device.  ``extras['streaming']`` reports the
        pipeline's residency and straggler/compaction counters; the
        history's middle column is the alive edge count, as the
        reference's."""
        from repro_torch.core.streaming import StreamingDensest, chunked_from_arrays

        mask = hostsync.fetch(graph.mask)
        src, dst, w = (hostsync.fetch(a)[mask] for a in (graph.src, graph.dst, graph.weight))
        drv = StreamingDensest(
            chunked_from_arrays(src, dst, w, chunk=prob.stream_chunk),
            n_nodes=graph.n_nodes,
            eps=prob.eps,
            checkpoint_dir=checkpoint_dir,
            n_workers=prob.stream_workers,
            prefetch=prob.stream_prefetch,
            spill_dir=prob.spill_dir,
            residency_cap_edges=prob.residency_cap_edges,
            compaction=prob.compaction,  # resolved: 'off' or 'geometric'
            device=graph.device,
        )
        st = drv.run(max_passes=prob.max_passes, resume=resume)
        extras = {
            "streaming": {
                "peak_resident_chunks": drv.peak_resident_chunks,
                "peak_resident_edges": drv.peak_resident_edges,
                "speculative_reissues": drv.speculative_reissues,
                "compactions": drv.compactions,
                "spill_rungs": drv.spill_rungs,
            }
        }
        dev = graph.device
        hist = np.asarray(st.history, np.float64).reshape(-1, 3)
        best_alive = torch.from_numpy(st.best_alive).to(dev)
        out = PeelOutcome(
            best_alive=best_alive,
            best_t=torch.zeros(0, dtype=torch.bool, device=dev),
            best_density=torch.tensor(st.best_rho, dtype=torch.float32, device=dev),
            best_size=best_alive.sum(dtype=torch.int32),
            passes=int(st.pass_idx),
            alive=torch.from_numpy(st.alive).to(dev),
            t_alive=torch.zeros(0, dtype=torch.bool, device=dev),
            history_n=torch.from_numpy(hist[:, 0].astype(np.int32)).to(dev),
            history_m=torch.from_numpy(hist[:, 1].astype(np.float32)).to(dev),
            history_rho=torch.from_numpy(hist[:, 2].astype(np.float32)).to(dev),
        )
        mp = prob.resolved_max_passes(graph.n_nodes)
        return self._wrap(out, prob, graph.n_nodes, mp, extras=extras)

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

    def solve_batch(
        self,
        graph: Union[EdgeList, Sequence[EdgeList]],
        problem: Problem,
        *,
        eps=None,
        c=None,
    ) -> DenseSubgraphResult:
        """A whole sweep in one peel loop (the reference's batched driver)::

            sweep = solver.solve_batch(
                edges, Problem.undirected(max_passes=64), eps=[0.1, 0.5, 1.0]
            )
            sweep.best_density                 # float32[3], one per eps

        Exactly one batch axis: ``eps=`` (eps values), ``c=`` (directed
        ratio guesses), or a sequence of same-shape graphs (or a
        :func:`stack_graphs` result).  Every array of the result gains a
        leading lane axis; ``passes`` is one count a lane.  The loop runs to
        the slowest lane with one host sync a pass for all lanes; a lane
        stops changing once its own loop would have ended, so each lane is
        bit-identical to its standalone solve (for eps values exactly
        representable in float32).  Degrees: exact is one ``index_add_``
        over all lanes; pallas launches the tiled-degree kernel once per
        live lane on one tiling of the graph; sketch launches the
        Count-Sketch kernel per live lane.

        With ``max_passes=None`` the trip bound is taken at the loosest
        point of the sweep (min eps).  Lanes share one buffer, so
        ``compaction='auto'`` quietly resolves to off and an explicit
        ladder raises.
        """
        with self.kernel_cache(problem):
            return self._solve_batch(graph, problem, eps=eps, c=c)

    def _solve_batch(self, graph, problem: Problem, *, eps=None, c=None) -> DenseSubgraphResult:
        stacked = isinstance(graph, (list, tuple)) or (
            isinstance(graph, EdgeList) and graph.src.dim() == 2
        )
        if sum(x is not None for x in (eps, c)) + stacked != 1:
            raise ValueError(
                "solve_batch needs exactly one batch axis: eps=, c=, or "
                "stacked same-shape graphs (a sequence or a stack_graphs result)"
            )

        def _resolve_batchable(n_nodes: int) -> Problem:
            p = problem.resolve(n_nodes)
            if p.stream_mode == "turnstile":
                raise ValueError(
                    "solve_batch sweeps are single vmapped programs; the "
                    "turnstile runtime is a host update/query driver — "
                    "query a live TurnstileDensest per sweep point instead"
                )
            if p.compaction != "off":
                if problem.compaction == "auto":
                    p = dataclasses.replace(p, compaction="off")
                else:
                    raise ValueError(
                        "solve_batch sweeps share one vmapped program; "
                        "per-lane compaction is not possible — use "
                        "compaction='off' (or 'auto')"
                    )
            return p

        if stacked:
            batched = graph if isinstance(graph, EdgeList) else stack_graphs(list(graph))
            prob = _resolve_batchable(batched.n_nodes)
            if prob.substrate != "jit":
                raise ValueError("solve_batch runs on the jit substrate")
            if prob.backend == "pallas":
                raise ValueError(
                    "stacked-graph sweeps need a graph-independent backend "
                    "(tile bucketing is per-graph); use exact or sketch"
                )
            if prob.objective == "directed" and prob.c is None:
                raise ValueError("stacked directed sweeps need a fixed c")
            mp = prob.resolved_max_passes(batched.n_nodes)
            out = run_cell(batched, prob, max_passes=mp)
            return self._wrap(out, prob, batched.n_nodes, mp, batch="graphs")

        if not isinstance(graph, EdgeList):
            raise TypeError(
                f"solve_batch takes an EdgeList or a sequence, got {type(graph).__name__}"
            )
        prob = _resolve_batchable(graph.n_nodes)
        if prob.substrate != "jit":
            raise ValueError("solve_batch runs on the jit substrate")
        n = graph.n_nodes

        if eps is not None:
            eps_host = _host_f32(eps)
            if prob.max_passes is not None:
                mp = int(prob.max_passes)
            else:
                loosest = dataclasses.replace(prob, eps=float(eps_host.min()))
                mp = loosest.resolved_max_passes(n)
            if prob.objective == "directed" and prob.c is None:
                raise ValueError("eps sweeps over a directed Problem need a fixed c")
            out = run_cell(graph, prob, eps=torch.from_numpy(eps_host).to(graph.device),
                           max_passes=mp, lanes=len(eps_host))
            return self._wrap(out, prob, n, mp, batch="eps")

        if prob.objective != "directed":
            raise ValueError("c sweeps only apply to the directed objective")
        c_host = _host_f32(c)
        mp = prob.resolved_max_passes(n)
        out = run_cell(graph, prob, c=torch.from_numpy(c_host).to(graph.device),
                       max_passes=mp, lanes=len(c_host))
        return self._wrap(out, prob, n, mp, batch="c")

    def _wrap(
        self,
        out: PeelOutcome,
        problem: Problem,
        n_nodes: int,
        mp: int,
        extras: Optional[Dict[str, Any]] = None,
        batch: Optional[str] = None,
    ) -> DenseSubgraphResult:
        prov = Provenance(
            objective=problem.objective,
            policy=_policy_name(problem),
            backend=problem.backend,
            substrate=problem.substrate,
            n_nodes=n_nodes,
            max_passes=mp,
            batch=batch,
            compaction=problem.compaction,
        )
        return DenseSubgraphResult.from_outcome(out, provenance=prov, extras=extras)


default_solver = Solver()


def solve(graph: EdgeList, problem: Problem, **kw) -> DenseSubgraphResult:
    """Module-level :meth:`Solver.solve` (``seed=`` for ``substrate='local'``,
    ``checkpoint_dir=``/``resume=`` for ``substrate='streaming'``)."""
    return default_solver.solve(graph, problem, **kw)


def solve_batch(graph, problem: Problem, **kw) -> DenseSubgraphResult:
    """Module-level :meth:`Solver.solve_batch`."""
    return default_solver.solve_batch(graph, problem, **kw)
