"""Per-device FLOP, byte and collective accounting of a traced step
(counterpart of ``repro.launch.hlo_stats``).

The reference reads its three roofline inputs from the compiled,
SPMD-partitioned HLO text.  The port has no compiled program: it counts
what the step *dispatches*.  :class:`OpStats` is a ``TorchDispatchMode``
that lets every DTensor op through (it returns ``NotImplemented`` for
one) and counts the ops DTensor then runs on this device's local shards,
so every figure is per device, not logical:

* ``flops``: matmul and convolution FLOPs, as ``torch.utils.flop_counter``
  counts them (its registry), on the local shapes;
* ``hbm_bytes``: each op's input and output bytes (views and allocations
  move none; a gather reads its result and indices, a scatter reads and
  writes its updates, the reference's sparse rule);
* ``collective_bytes`` and ``by_collective``: each collective, DTensor's
  (``_c10d_functional``) or the port's (``repro_torch.collectives`` through
  ``c10d``), charged with the reference's wire formula (``_collective_bytes``):
  all-reduce over g ranks 2·S·(g−1)/g, all-gather and reduce-scatter and
  all-to-all S·(g−1)/g of the gathered or scattered size, a send S;
  collectives also count their input and output in ``hbm_bytes``;
* ``unknown_trip_loops``: always 0.  The reference counts a ``while`` body
  times its trip count, read from the loop's compare constant; the port's
  loops are Python loops whose counts the tracer knows (``launch/cells.py``).

A host read of a fake tensor (``.item()``, ``.tolist()``:
``aten._local_scalar_dense``) has no value; ``OpStats(answer=fn)``
answers it with ``fn(tensor)`` and keeps a snapshot of the totals at each
read (``reads``), so a data-dependent loop can be traced one pass at a
time (``launch/cells.py`` counts the densest cells' passes that way).

``peak_bytes`` is the largest sum of live local storages the trace made
(freed when their last tensor dies), over what was live at entry.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import loops

_aten = torch.ops.aten

# Ranks a node: a collective whose ranks share one node (consecutive ranks
# in blocks of 8, an HGX H100 board) moves its bytes over NVLink.
RANKS_PER_NODE = 8

# Ops that move no bytes of their own: allocation, metadata and aliasing.
_NO_TRAFFIC = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "lift_fresh", "_local_scalar_dense", "device", "alias", "set_", "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "wait_tensor", "record_stream", "_unsafe_view", "split",
    "split_with_sizes", "unsafe_split", "chunk", "unbind", "as_strided",
}
_GATHERS = {"index_select", "gather", "embedding", "index"}
_SCATTERS = {"index_add", "index_add_", "index_put", "index_put_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "_index_put_impl_", "index_copy", "index_copy_", "embedding_dense_backward"}

# Collective ops by name -> the kind the wire formula charges.
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast", "broadcast_": "broadcast",
}
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "recv", "broadcast_": "broadcast",
}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def wire_bytes(kind: str, in_bytes: int, out_bytes: int, g: int) -> float:
    """Per-device bytes a collective over ``g`` ranks puts on the wire: the
    reference's ring model (``hlo_stats._collective_bytes``)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * in_bytes * (g - 1) / g
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind in ("reduce-scatter", "all-to-all"):
        return in_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(in_bytes)
    return 0.0


def _group_ranks(args) -> list:
    """The global ranks of a collective's group: from its ProcessGroup
    argument (``c10d``) or its group name (``_c10d_functional``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = next((a for a in args if isinstance(a, dist.ProcessGroup)), None)
    for a in args if group is None else ():
        if isinstance(a, torch.ScriptObject):  # c10d ops pass the group boxed
            try:
                group = dist.ProcessGroup.unbox(a)
                break
            except (RuntimeError, TypeError):
                continue
    for a in args if group is None else ():
        if isinstance(a, str):
            try:
                group = _resolve_process_group(a)
                break
            except (KeyError, RuntimeError, ValueError):
                continue
    return dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)


def _io_bytes(ns: str, name: str, args, out) -> tuple:
    """(input bytes, output bytes) of a collective's call."""
    sz = lambda tree: sum(nbytes(t) for t in _tensors(tree))  # noqa: E731
    if ns == "c10d":
        if name in ("allreduce_", "allreduce_coalesced_", "send", "recv_", "broadcast_"):
            return sz(args[0]), sz(args[0])
        # (output(s), input(s), group, ...)
        return sz(args[1]), sz(args[0])
    return sz(args[0]), sz(out)


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_count: float = 0.0
    by_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_trip_loops: int = 0
    collective_bytes_intra_node: float = 0.0
    collective_in_bytes: float = 0.0  # what the collectives' inputs hold (the port's counters)

    def copy(self) -> "Totals":
        return dataclasses.replace(self, by_collective=dict(self.by_collective))

    def scaled(self, k: float) -> "Totals":
        return Totals(self.flops * k, self.hbm_bytes * k, self.collective_bytes * k,
                      self.collective_count * k,
                      {n: v * k for n, v in self.by_collective.items()},
                      self.unknown_trip_loops, self.collective_bytes_intra_node * k,
                      self.collective_in_bytes * k)

    def add(self, o: "Totals") -> "Totals":
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.collective_bytes += o.collective_bytes
        self.collective_count += o.collective_count
        for n, v in o.by_collective.items():
            self.by_collective[n] = self.by_collective.get(n, 0.0) + v
        self.unknown_trip_loops += o.unknown_trip_loops
        self.collective_bytes_intra_node += o.collective_bytes_intra_node
        self.collective_in_bytes += o.collective_in_bytes
        return self

    def minus(self, o: "Totals") -> "Totals":
        return self.copy().add(o.scaled(-1.0))

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_count": self.collective_count,
            "by_collective": dict(self.by_collective),
            "unknown_trip_loops": self.unknown_trip_loops,
            "collective_bytes_intra_node": self.collective_bytes_intra_node,
            "collective_in_bytes": self.collective_in_bytes,
        }


def _site() -> str:
    """The innermost frame of the port's own code that led to this op."""
    import sys

    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "op_stats" not in fn:
            return f"{fn.split('repro_torch/')[-1]}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and not rets[0].alias_info.is_write


class OpStats(TorchDispatchMode):
    """Counts the local ops dispatched under it (see the module docstring).

    ``per_op`` maps an op's name to ``{"count", "flops", "bytes",
    "collective_bytes"}``; ``peak_bytes`` is the peak of the live local
    storages made inside, above what lived at entry."""

    def __init__(self, answer: Optional[Callable[[torch.Tensor], object]] = None,
                 sites: bool = False):
        super().__init__()
        self.sites = sites
        self.totals = Totals()
        self.per_op: Dict[str, Dict[str, float]] = {}
        self.answer = answer
        self.reads: List[Totals] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._muted = 0

    # -- DTensor's own shape inference ---------------------------------------
    # The first time DTensor meets an op's placements it runs the op on fake
    # tensors of the GLOBAL shapes to learn its output's shape; those calls
    # pass through this mode and are not the step's work.
    _META_FNS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._muted = 0
        self._patched = []
        for name in self._META_FNS:
            fn = ShardingPropagator.__dict__.get(name)
            if fn is None:
                continue

            def muted(*a, _fn=fn, **k):
                self._muted += 1
                try:
                    return _fn(*a, **k)
                finally:
                    self._muted -= 1

            setattr(ShardingPropagator, name, muted)
            self._patched.append((name, fn))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, fn in self._patched:
            setattr(ShardingPropagator, name, fn)
        return super().__exit__(*exc)

    # -- storage tracking ---------------------------------------------------
    def _track(self, outs) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._seen:
                continue
            size = st.nbytes()
            self._seen[key] = size
            self.live_bytes += size
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    # -- accounting ---------------------------------------------------------
    def _charge(self, name: str, flops: float, b: float, coll: float = 0.0) -> None:
        k = loops.scale()
        flops, b, coll = flops * k, b * k, coll * k
        if self.sites:
            name = f"{name} @ {_site()}"
        row = self.per_op.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0,
                                            "collective_bytes": 0.0})
        row["count"] += k
        row["flops"] += flops
        row["bytes"] += b
        row["collective_bytes"] += coll
        self.totals.flops += flops
        self.totals.hbm_bytes += b

    def _collective(self, func, kind: str, args, out) -> None:
        ns, _, name = func._schema.name.partition("::")
        if kind == "recv":  # the sender is charged
            return
        in_b, out_b = _io_bytes(ns, name, args, out)
        ranks = _group_ranks(args)
        w = wire_bytes(kind, in_b, out_b, len(ranks))
        n = loops.scale()  # the times a counted loop body runs this call
        if len({r // RANKS_PER_NODE for r in ranks}) == 1:
            self.totals.collective_bytes_intra_node += w * n
        self.totals.collective_bytes += w * n
        self.totals.collective_count += n
        self.totals.collective_in_bytes += in_b * n
        self.totals.by_collective[kind] = self.totals.by_collective.get(kind, 0.0) + w * n
        self._charge(func._schema.name, 0.0, in_b + out_b, w)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._muted:
            return func(*args, **kwargs)
        if func is _aten._local_scalar_dense.default and self.answer is not None:
            self.reads.append(self.totals.copy())
            return self.answer(args[0])
        out = func(*args, **kwargs)
        ns, _, name = func._schema.name.partition("::")
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if ns == "_c10d_functional" and name in _FUNCOL:
            self._collective(func, _FUNCOL[name], args, out)
        elif ns == "c10d" and name in _C10D:
            self._collective(func, _C10D[name], args, out)
        elif name in _NO_TRAFFIC or ns == "prim" or _is_view(func):
            pass
        elif name in _GATHERS:
            idx = sum(nbytes(t) for t in ins[1:])
            self._charge(func._schema.name, 0.0, 2 * sum(nbytes(t) for t in outs) + idx)
        elif name in _SCATTERS:
            upd = sum(nbytes(t) for t in ins[1:])
            self._charge(func._schema.name, 0.0, 2 * upd)
        else:
            from torch.utils.flop_counter import flop_registry

            fl = 0.0
            counter = flop_registry.get(func.overloadpacket)
            if counter is not None:
                fl = float(counter(*args, **kwargs, out_val=out))
            b = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
            self._charge(func._schema.name, fl, b)
        self._track(outs)
        return out

    def result(self) -> Dict[str, float]:
        return self.totals.as_dict()


def top_ops(per_op: Dict[str, Dict[str, float]], top: int = 12, key: str = "bytes"):
    """The ``top`` ops of a trace by ``key`` ('bytes', 'flops' or
    'collective_bytes'): ``[(name, row)]``, largest first."""
    rows = sorted(per_op.items(), key=lambda kv: -kv[1][key])
    return [(n, r) for n, r in rows[:top] if r[key] > 0]
