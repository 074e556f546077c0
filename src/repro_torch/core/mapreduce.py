"""MapReduce realization of Algorithms 1/2/3 on an edge-sharded mesh of
ranks (paper §5.2; counterpart of ``repro.core.mapreduce``).

The paper's per-pass MapReduce jobs become collectives over a
``torch.distributed`` process group:

  map  (emit <u;v>, <v;u>)          ->  per-shard ``index_add_`` into deg[N]
  shuffle + reduce (count per key)  ->  one ``all_reduce`` over the edge axes
  density counters                  ->  the alive weight, in the same reduction
  node filter (2 MR passes)         ->  alive-bitmap mask, recomputed locally

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` name the ``edge_axes`` (:func:`make_mesh`, the
counterpart of ``jax.make_mesh``).  The run is SPMD: one process per
device (``torchrun --nproc-per-node=N``); every rank calls the same entry
point with the same full graph, keeps its contiguous block of the edges
(:func:`shard_edges`) and the whole O(n) node state, and returns the same
result.  Every decision the host makes (the pass loop's one read a pass,
the ladder's trigger, the c grid's best c, the rung sizes) is taken from
reduced values, so the ranks never part ways.

The ``make_distributed_*`` builders go through the front door's mesh
lowering (:meth:`repro_torch.core.api.Solver.mesh_program`): the pass body
is the engine's, with :class:`~repro_torch.core.engine.MeshSegmentSumBackend`
(one fused ``all_reduce`` of ``[deg | total]`` a pass) or the Count-Sketch
:class:`_MeshSketchBackend` (the hand-written kernel K2 on each rank's
shard, then one ``all_reduce`` of the ``t·b`` counters).  Every collective
is counted in :mod:`repro_torch.collectives`.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import weakref
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.core.api import DenseSubgraphResult, Problem, default_solver, solve
from repro_torch.core.density import max_passes_bound
from repro_torch.core.engine import (
    MeshSegmentSumBackend,
    PeelOutcome,
    UndirectedThreshold,
    compact_edges,
    run_peel,
)
from repro_torch.graph.edgelist import Device, EdgeList, resolve_device

__all__ = [
    "EdgeShards",
    "densest_subgraph_distributed",
    "edge_shards",
    "make_distributed_directed_peel",
    "make_distributed_peel",
    "make_distributed_peel_compacted",
    "make_distributed_peel_ladder",
    "make_distributed_peel_twophase",
    "make_distributed_sketched_peel",
    "make_distributed_topk_peel",
    "make_mesh",
    "mesh_compact_edges",
    "shard_edges",
]

# How long a collective of the groups made here waits for its peers.
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: Device = None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` of ``shape``
    over the ranks, its dimensions named ``axes`` (``jax.make_mesh``'s
    counterpart).  It follows the port's device rule: the card unless the
    caller asks for ``device='cpu'``, and it raises without CUDA.  A card
    mesh reduces over NCCL, a CPU mesh over gloo; there is no fallback
    from one to the other.

    If no process group is running yet, this starts one: from the
    environment ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, the store's
    address), or else a world of this one process over an in-memory store.
    A card world binds NCCL to the card (``device_id``) and runs gloo for
    CPU tensors beside it; a CPU world runs gloo.  A world started here is
    destroyed when the interpreter exits (:func:`_teardown`), with every
    group made in it; a world the caller started is the caller's to end."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "gloo"
        kw: dict = {"timeout": GROUP_TIMEOUT}
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(index)
            backend = "cpu:gloo,cuda:nccl"
            kw["device_id"] = torch.device("cuda", index)
        if "WORLD_SIZE" not in os.environ:
            kw.update(store=dist.HashStore(), rank=0, world_size=1)
        dist.init_process_group(backend, **kw)
        atexit.register(_teardown, weakref.ref(dist.group.WORLD))
    need = "nccl" if dev.type == "cuda" else "gloo"
    running = dist.get_backend()
    if need not in running:
        raise RuntimeError(
            f"a {dev.type} mesh reduces over {need}; the process group runs {running!r}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))
    _MESHES.append(weakref.ref(mesh))
    return mesh


# The meshes make_mesh returned (weak references), for the teardown.
_MESHES: list = []


def _teardown(world_ref) -> None:
    """At exit: if the world :func:`make_mesh` started is still the running
    one, destroy it with every group made in it, and drop the groups the
    meshes hold (``edge_shards``' and the mesh's own ``_pg_registry``), so
    that each group's C++ object and its gloo or NCCL threads are freed
    here.  ``destroy_process_group`` only unregisters the groups: one the
    user's mesh still holds outlives the interpreter, and its threads still
    run while the C++ runtime tears down, which can abort the process
    (``terminate called without an active exception``)."""
    if not dist.is_initialized() or dist.group.WORLD is not world_ref():
        return
    for ref in _MESHES:
        mesh = ref()
        if mesh is not None:
            mesh.__dict__.pop("_edge_shards", None)
            getattr(mesh, "_pg_registry", {}).clear()
    _MESHES.clear()
    dist.destroy_process_group()


def check_mesh_device(device: torch.device, mesh) -> None:
    """The edges must lie on the kind of device the mesh spans."""
    if torch.device(device).type != mesh.device_type:
        raise ValueError(
            f"the graph lies on {device}, but the mesh spans {mesh.device_type} devices"
        )


@dataclasses.dataclass(frozen=True)
class EdgeShards:
    """How a mesh's edge axes shard the edges, seen from this rank."""

    group: Any  # process group of the ranks that split the edges with this one
    count: int  # shards: the product of the edge axes' sizes
    index: int  # this rank's block: its row-major index over the edge axes
    # Block order of the group's ranks when it is not theirs (a gather
    # returns the blocks in group-rank order, which is ascending rank).
    perm: Optional[torch.Tensor]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` (one per rank, equal lengths), concatenated
        in block order: the counterpart of ``lax.all_gather(..., tiled=True)``."""
        out = collectives.all_gather(x, self.group)
        if self.perm is None:
            return out
        return out.view(self.count, -1)[self.perm.to(out.device)].reshape(-1)


def edge_shards(mesh, axes: Sequence[str]) -> EdgeShards:
    """The edge sharding of ``mesh`` over ``axes`` (kept on the mesh object).

    The first call for a mesh and axes makes one process group for each
    set of ranks that differ only along ``axes``, in the same order on
    every rank, as ``torch.distributed.new_group`` requires."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names or ())
    for a in axes:
        if a not in names:
            raise ValueError(f"edge axis {a!r} is not a dimension of the mesh {names}")
    per_mesh = mesh.__dict__.setdefault("_edge_shards", {})
    if axes in per_mesh:
        return per_mesh[axes]
    # repro: allow(host-sync) a DeviceMesh keeps its layout as a CPU tensor: host data
    layout = mesh.mesh.cpu()
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(layout.dim()) if d not in dims]
    count = int(np.prod([layout.shape[d] for d in dims]))
    # repro: allow(host-sync) the mesh layout, host data (above)
    rows = layout.permute(rest + dims).reshape(-1, count).tolist()
    me = dist.get_rank()
    found = None
    for row in rows:
        group = dist.new_group(sorted(row), timeout=GROUP_TIMEOUT)
        if me in row:
            order = [row.index(r) for r in sorted(row)]  # block of each group rank
            perm = None
            if order != list(range(count)):
                perm = torch.as_tensor(np.argsort(order))
            found = EdgeShards(group=group, count=count, index=row.index(me), perm=perm)
    if found is None:
        # repro: allow(host-sync) the mesh layout, host data (above)
        raise ValueError(f"rank {me} is not in the mesh {layout.tolist()}")
    per_mesh[axes] = found
    return found


def shard_edges(edges: EdgeList, mesh, axes: Sequence[str]) -> EdgeList:
    """This rank's block of ``edges``: E padded to a multiple of the shard
    count (``with_padding``), then the contiguous block at this rank's
    row-major index over ``axes``, the order a gather concatenates in."""
    check_mesh_device(edges.device, mesh)
    sh = edge_shards(mesh, axes)
    padded = edges.with_padding(sh.count)
    per = padded.n_edges_padded // sh.count
    block = slice(sh.index * per, (sh.index + 1) * per)
    return EdgeList(
        src=padded.src[block], dst=padded.dst[block], weight=padded.weight[block],
        mask=padded.mask[block], n_nodes=padded.n_nodes, directed=padded.directed,
    )


def mesh_compact_edges(
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    ok: torch.Tensor,
    alive_edges: torch.Tensor,
    new_cap: int,
    mesh,
    axes: Sequence[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One compaction step of the collective mesh ladder: every shard's
    edges and post-removal filter ``ok`` are gathered (four
    ``all_gather``s), the survivors are compacted in order into the next
    rung's ``new_cap`` slots a shard (their reduced count is
    ``alive_edges``), and this rank keeps its block.  No host round trip.

    The gather is O(m_i), and the rungs shrink geometrically, so the
    traffic over the whole ladder telescopes to O(m_0); but for a moment
    every rank holds all m_i slots, so rung 0 needs O(m_0) memory on each
    rank.  Shards are contiguous blocks in gather order and the compaction
    is stable, so the survivors keep their global order: degree sums see
    the same addends in the same order as the host ladder.

    Returns this rank's ``(src', dst', weight', mask')``."""
    sh = edge_shards(mesh, axes)
    g_ok, g_src, g_dst, g_w = (sh.gather(x) for x in (ok, src, dst, weight))
    total_next = new_cap * sh.count
    n_src, n_dst, n_w = compact_edges(g_ok, (g_src, g_dst, g_w), total_next)
    n_mask = torch.arange(total_next, device=ok.device) < alive_edges
    block = slice(sh.index * new_cap, (sh.index + 1) * new_cap)
    return n_src[block], n_dst[block], n_w[block], n_mask[block]


def mesh_backend(problem: Problem, mesh, n_nodes: int):
    """The DegreeBackend of a resolved mesh Problem."""
    sh = edge_shards(mesh, problem.edge_axes)
    if problem.backend == "sketch":
        from repro_torch.core.countsketch import make_sketch_params

        return _MeshSketchBackend(
            params=make_sketch_params(
                problem.sketch_tables, problem.sketch_buckets, problem.sketch_seed),
            group=sh.group,
            node_chunk=min(problem.sketch_node_chunk, max(n_nodes, 1)),
        )
    return MeshSegmentSumBackend(sh.group, problem.wire_dtype)


def make_distributed_peel(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    n_nodes: Optional[int] = None,
    wire_dtype: str = "f32",
):
    """Algorithm 1 on the mesh: ``fn(src, dst, weight, mask) ->
    PeelOutcome`` over this rank's shard (:func:`shard_edges`), the result
    the same on every rank.

    ``wire_dtype='bf16'`` halves the per-pass degree reduction: the
    partial degrees and total are cast to bf16 before it and back after.
    Unweighted partials are exact integers up to 256; the reduced sum
    carries up to 0.4% relative rounding."""
    if n_nodes is None:
        raise ValueError("make_distributed_peel needs n_nodes")
    problem = Problem.undirected(
        eps=eps, max_passes=max_passes, substrate="mesh", edge_axes=tuple(edge_axes),
        wire_dtype=wire_dtype,
    )
    return default_solver.mesh_program(problem, mesh, n_nodes)


def densest_subgraph_distributed(
    edges: EdgeList,
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    compaction: str = "off",
) -> DenseSubgraphResult:
    """Shards and runs through the front door.  ``compaction`` is off by
    default, as in the reference; ``'geometric'`` is the collective mesh
    ladder."""
    problem = Problem.undirected(
        eps=eps, max_passes=max_passes, substrate="mesh", edge_axes=tuple(edge_axes),
        compaction=compaction,
    )
    return solve(edges, problem, mesh=mesh)


def make_distributed_peel_compacted(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    n_nodes: Optional[int] = None,
    wire_dtype: str = "f32",
    compaction: str = "geometric",
):
    """Algorithm 1 on the mesh's compaction ladder: ``run(edges) ->
    DenseSubgraphResult`` (the full graph, on every rank).  ``'geometric'``
    is the collective ladder, ``'twophase'`` the host schedule with a
    reshard per rung.  ``n_nodes``, if given, is checked against each
    graph."""
    problem = Problem.undirected(
        eps=eps, max_passes=max_passes, substrate="mesh", edge_axes=tuple(edge_axes),
        wire_dtype=wire_dtype, compaction=compaction,
    )

    def run(edges: EdgeList) -> DenseSubgraphResult:
        if n_nodes is not None and edges.n_nodes != n_nodes:
            raise ValueError(
                f"graph has n_nodes={edges.n_nodes}, builder was sized for {n_nodes}"
            )
        return solve(edges, problem, mesh=mesh)

    return run


def make_distributed_peel_ladder(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    n_nodes: Optional[int] = None,
    m_edges: Optional[int] = None,
    wire_dtype: str = "f32",
):
    """The collective mesh ladder: every rung's peel segment and every
    compaction between rungs over collectives only (per pass the degree
    reduction and the trigger count, per rung four gathers; no host gather
    or reshard).  The rung sizes come from the padded edge count alone
    (rung ``i`` exits below rung ``i+1``'s capacity, so its survivors fit
    there).

    Returns ``run(src, dst, weight, mask) -> PeelOutcome`` over this
    rank's shard of the edges padded to ``run.n_edge_slots`` (=
    ``run.schedule[0] * n_shards``); ``run.schedule`` holds the per-shard
    rung capacities.  The front door (``solve(..., Problem(substrate=
    'mesh', compaction='geometric'))``) adds the ladder report."""
    if n_nodes is None or m_edges is None:
        raise ValueError("the ladder's rung sizes need n_nodes and m_edges")
    problem = Problem.undirected(
        eps=eps, max_passes=max_passes, substrate="mesh", edge_axes=tuple(edge_axes),
        wire_dtype=wire_dtype, compaction="geometric",
    )
    fn, schedule, n_shards = default_solver.mesh_ladder_program(problem, mesh, n_nodes, m_edges)

    def run(src, dst, weight, mask) -> PeelOutcome:
        out, _rung_t = fn(src, dst, weight, mask)
        return out

    run.schedule = schedule
    run.n_edge_slots = schedule[0] * n_shards
    return run


def make_distributed_peel_twophase(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    n_nodes: Optional[int] = None,
    phase1_passes: int = 8,
    wire_dtype: str = "f32",
):
    """Algorithm 1 with one compaction at a static point: phase 1 runs up
    to K passes on the full id space; Lemma 4 bounds the survivors by
    n/(1+eps)^K, so they are renumbered into that static size ``n2`` (dead
    edges to a trash node ``n2``) and phase 2 continues there, its
    per-pass degree reduction (1+eps)^K times smaller.  The same engine
    loop runs both phases.  ``fn(src, dst, weight, mask) -> PeelOutcome``
    over this rank's shard, as :func:`make_distributed_peel`."""
    if n_nodes is None:
        raise ValueError("make_distributed_peel_twophase needs n_nodes")
    n = n_nodes
    mp = max_passes if max_passes is not None else max_passes_bound(n, eps)
    k1 = min(phase1_passes, mp)
    n2 = int(np.ceil(n / (1.0 + eps) ** k1)) + 1  # static Lemma-4 bound
    mp2 = max(mp - k1, 4)
    policy = UndirectedThreshold(eps)
    backend = MeshSegmentSumBackend(edge_shards(mesh, edge_axes).group, wire_dtype)

    def run(src, dst, weight, mask) -> PeelOutcome:
        check_mesh_device(src.device, mesh)
        # ---- phase 1: up to K passes on the full id space ----
        out1 = run_peel(EdgeList(src, dst, weight, mask, n), policy, backend, k1,
                        init_best_empty=True)
        alive1 = out1.alive
        # ---- renumber the survivors into [0, n2) ----
        n_alive1 = alive1.sum(dtype=torch.int32)
        relabel = torch.cumsum(alive1, 0, dtype=torch.int32) - 1  # full -> compact
        relabel = torch.clamp(relabel, max=n2 - 1)  # the bound is provable
        ok_e = mask & alive1[src] & alive1[dst]
        trash = torch.tensor(n2, dtype=torch.int32, device=src.device)
        src2 = torch.where(ok_e, relabel[src], trash)
        dst2 = torch.where(ok_e, relabel[dst], trash)
        w2 = torch.where(ok_e, weight, 0.0)
        # ---- phase 2: the same engine loop on the compact ids ----
        alive2 = torch.arange(n2 + 1, device=src.device) < n_alive1
        out2 = run_peel(EdgeList(src2, dst2, w2, ok_e, n2 + 1), policy, backend, mp2,
                        init_alive=alive2, init_best_empty=True)
        # ---- map phase 2's sets back to the full ids ----
        best2_full = alive1 & out2.best_alive[relabel]
        use2 = out2.best_density > out1.best_density
        best_alive = torch.where(use2, best2_full, out1.best_alive)
        dev = src.device
        return PeelOutcome(
            best_alive=best_alive,
            best_t=torch.zeros(0, dtype=torch.bool, device=dev),
            best_density=torch.maximum(out1.best_density, out2.best_density),
            best_size=best_alive.sum(dtype=torch.int32),
            passes=out1.passes + out2.passes,
            alive=alive1 & out2.alive[relabel],
            t_alive=torch.zeros(0, dtype=torch.bool, device=dev),
            history_n=torch.zeros(1, dtype=torch.int32, device=dev),
            history_m=torch.zeros(1, dtype=torch.float32, device=dev),
            history_rho=torch.zeros(1, dtype=torch.float32, device=dev),
        )

    return run


@dataclasses.dataclass(frozen=True)
class _MeshSketchBackend:
    """Count-Sketch degrees of an edge shard (§5.1 at §5.2 scale).

    Each rank builds its shard's ``[t, b]`` counters with the hand-written
    kernel K2 (its plain version on a CPU tensor); one ``all_reduce`` of
    ``[t·b counters | total]`` sums them, so a pass moves O(t·b) over the
    wire, not O(n).  The degree queries then run over node chunks of
    ``node_chunk`` ids (the reference's ``lax.map``), so the query's
    transient memory stays O(node_chunk) beside the O(n) estimates."""

    params: Any  # SketchParams
    group: Any  # torch.distributed ProcessGroup over the edge axes
    node_chunk: int

    def undirected(self, edges: EdgeList, w_alive: torch.Tensor):
        from repro_torch.core.countsketch import query_degrees, sketch_degrees_from_edges

        t, b = self.params.n_tables, self.params.n_buckets
        local = sketch_degrees_from_edges(self.params, edges, w_alive)
        packed = torch.cat([local.reshape(-1), w_alive.sum()[None]])
        packed = collectives.all_reduce(packed, self.group)  # O(t*b), not O(n)
        counters = packed[:-1].view(t, b)
        n = edges.n_nodes
        est = [
            query_degrees(self.params, counters, torch.arange(
                lo, min(lo + self.node_chunk, n), dtype=torch.int32, device=w_alive.device))
            for lo in range(0, n, self.node_chunk)
        ]
        return torch.cat(est), packed[-1]

    def directed(self, edges: EdgeList, w_alive: torch.Tensor):
        raise NotImplementedError("use SketchBackend for directed sketched peels")


def make_distributed_sketched_peel(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: int = 48,
    n_nodes: Optional[int] = None,
    t: int = 5,
    b: int = 1 << 17,
    node_chunk: int = 1 << 20,
    seed: int = 0,
):
    """Algorithm 1 on the mesh with Count-Sketch degrees (paper §5.1): the
    billion-node configuration, only edges sharded, node bitmaps on every
    rank, one O(t·b) reduction a pass.  Returns ``fn(src, dst, weight,
    mask) -> (best_alive, best_rho, passes)``."""
    if n_nodes is None:
        raise ValueError("make_distributed_sketched_peel needs n_nodes")
    problem = Problem.undirected(
        eps=eps, max_passes=max_passes, substrate="mesh", backend="sketch",
        edge_axes=tuple(edge_axes), sketch_tables=t, sketch_buckets=b, sketch_seed=seed,
        sketch_node_chunk=node_chunk,
    )
    fn = default_solver.mesh_program(problem, mesh, n_nodes)

    def run(src, dst, weight, mask):
        out = fn(src, dst, weight, mask)
        return out.best_alive, out.best_density, out.passes

    return run


def make_distributed_topk_peel(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    k: int = 1,
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    n_nodes: Optional[int] = None,
):
    """Algorithm 2 (|S| >= k) on the mesh: each pass removes the
    ceil(eps/(1+eps)·|S|) lowest-degree nodes among the threshold-eligible
    ones.  The degrees are the same on every rank after the reduction, so
    the ranking needs no collective of its own."""
    if n_nodes is None:
        raise ValueError("make_distributed_topk_peel needs n_nodes")
    problem = Problem.at_least_k(
        k=k, eps=eps, max_passes=max_passes, substrate="mesh", edge_axes=tuple(edge_axes),
        min_deg_fallback=False, ceil_count=True,
    )
    return default_solver.mesh_program(problem, mesh, n_nodes)


def make_distributed_directed_peel(
    mesh,
    edge_axes: Tuple[str, ...] = ("data",),
    eps: float = 0.5,
    max_passes: Optional[int] = None,
    n_nodes: Optional[int] = None,
):
    """Algorithm 3 (directed) on the mesh for a ratio c given at call time:
    ``fn(src, dst, weight, mask, c) -> (best_s, best_t, rho, passes)``."""
    if n_nodes is None:
        raise ValueError("make_distributed_directed_peel needs n_nodes")
    problem = Problem.directed(
        eps=eps, max_passes=max_passes, substrate="mesh", edge_axes=tuple(edge_axes),
    )
    fn = default_solver.mesh_program(problem, mesh, n_nodes)

    def run(src, dst, weight, mask, c):
        out = fn(src, dst, weight, mask, c)
        return out.best_alive, out.best_t, out.best_density, out.passes

    return run
