"""Sharded forms of the ops whose DTensor strategy would not do what the
reference's SPMD partitioner does with them (used by the models only when
their inputs are DTensors, i.e. under the dry-run's sharding context; on
plain tensors nothing here runs).

* :func:`fsdp_weight`: a parameter is all-gathered over the mesh axes that
  split its input dimension before a product (ZeRO/FSDP), unless the
  activation's contracting dimension is split over the same axis (a
  row-parallel product, whose output is then a partial sum).  Left to
  itself, DTensor would rather move the activation than the weight and
  make a partial sum of the whole global batch.
* :func:`take_rows`: a row lookup in a table split by rows over some mesh
  axes (vocab-parallel): each device looks its ids up in its own block,
  zeros the rest, and the result is a partial sum over those axes.
* :func:`edge_local`: the §5.2 MapReduce of the GNN aggregations: edges
  split, node state whole on every device, each device's ``index_add_``
  (``scatter_reduce`` for a max, ``index_select`` for a gather) over its
  edges, and a node result a partial sum (max) over the edge axes.
* :func:`split_dim` / :func:`merge_dims`: a head split (or merge) of a
  feature dimension that an axis does not divide evenly gathers that axis
  first.

Each runs the plain function on the local shards (``run_local``, the
counterpart of ``shard_map``) and wraps its output as a DTensor;
``to_local``/``from_local`` carry the gradients, the inputs' gradients as
partial sums where the forward read a replicated input from split data.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _redistribute(x, placements):
    placements = tuple(placements)
    return x if tuple(x.placements) == placements else x.redistribute(x.device_mesh, placements)


def _shard_dim(p):
    from torch.distributed.tensor import Shard

    return p.dim if isinstance(p, Shard) else None


def _whole(t, *dims: int):
    """``t`` with dimensions ``dims`` gathered on every device (the mesh
    axes that split them replicated)."""
    from torch.distributed.tensor import Replicate

    dims = {d % t.dim() for d in dims}
    return _redistribute(t, [Replicate() if _shard_dim(p) is not None
                             and _shard_dim(p) % t.dim() in dims else p for p in t.placements])


def block_index(mesh, axes) -> int:
    """This device's block along a dimension split over mesh ``axes`` (the
    first the major one): its row-major coordinate over those axes."""
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    index = 0
    for a in axes:
        index = index * mesh.size(a) + coord[a]
    return index


def run_local(fn: Callable, args: Sequence, out_placements, grad_placements=None,
              shapes=None):
    """``fn`` on the local shards of ``args`` (a DTensor becomes its local
    tensor, anything else passes through); its tensor output(s) wrapped as
    DTensors with ``out_placements`` (one tuple, or a tuple per output) and
    global ``shapes`` (one, or one per output; default: the local shapes
    times the splits, which only an even split gives).
    ``grad_placements[i]`` is the placement of the gradient of DTensor
    argument ``i`` (default: its own)."""
    from torch.distributed.tensor import DTensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    grads = list(grad_placements or [None] * len(args))
    local = [a.to_local(grad_placements=g) if is_dtensor(a) else a for a, g in zip(args, grads)]
    out = fn(*local)
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    pls = (out_placements,) if single else tuple(out_placements)
    shp = (shapes,) if single else tuple(shapes or [None] * len(outs))

    def wrap(o, pl, shape):
        if shape is None:
            return DTensor.from_local(o, mesh, pl, run_check=False)
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    wrapped = tuple(wrap(o, pl, sh) for o, pl, sh in zip(outs, pls, shp))
    return wrapped[0] if single else wrapped


def _contiguous(shape):
    stride, run = [], 1
    for n in reversed(tuple(shape)):
        stride.append(run)
        run *= max(int(n), 1)
    return tuple(reversed(stride))


def fsdp_weight(w, x, in_dim: int = 0):
    """``w`` redistributed for ``x @ w`` (``in_dim`` the contracting
    dimension of ``w``): gathered over every mesh axis that splits its
    input dimension where ``x``'s last dimension is not split, and over
    every axis that splits its other dimensions where ``x``'s rows are
    split (one axis cannot split both)."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(w):
        return w
    in_dim = in_dim % w.dim()
    xp = x.placements if is_dtensor(x) else (Replicate(),) * w.device_mesh.ndim
    want = []
    for pw, px in zip(w.placements, xp):
        dw, dx = _shard_dim(pw), _shard_dim(px)
        if dx is not None:
            dx = dx % x.dim()
        if dw is None or (w.dim() == 3 and dw == 0):  # a batched product's batch dim
            want.append(pw)
        elif dw == in_dim:
            want.append(pw if dx == x.dim() - 1 else Replicate())
        else:
            want.append(Replicate() if dx is not None and dx != x.dim() - 1 else pw)
    return _redistribute(w, want)


def matmul(x, w):
    """``x @ w`` for a DTensor weight ``w [d_in, d_out]`` (:func:`fsdp_weight`
    applied first), as each device's product of its shards: rows of ``x``
    split -> rows of the output split; ``w``'s output columns split ->
    columns split; the contraction split on both -> a partial sum.  The
    gradients' layouts follow (a split row's weight gradient is a partial
    sum, a split column's input gradient too), so DTensor picks no
    strategy for the product or its backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    w = fsdp_weight(w, x)
    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    last = x.dim() - 1
    xp, out, gx, gw = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        dx, dw = _shard_dim(px), _shard_dim(pw)
        dx = None if dx is None else dx % x.dim()
        if dw == 0 and dx == last:  # row-parallel: a partial sum
            xp.append(px), out.append(Partial()), gx.append(px), gw.append(pw)
        elif dw == 1:  # column-parallel: x whole on this axis
            xp.append(Replicate()), out.append(Shard(last)), gx.append(Partial())
            gw.append(pw)
        elif dx is not None and dx != last:  # rows split, w whole
            xp.append(px), out.append(px), gx.append(px), gw.append(Partial())
        else:
            xp.append(Replicate()), out.append(Replicate()), gx.append(Replicate())
            gw.append(pw)
    x = _redistribute(x, xp)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    return run_local(lambda a, b: a @ b, (x, w), tuple(out), grad_placements=(tuple(gx), tuple(gw)),
                     shapes=shape)


def take_rows(table, ids):
    """``table[ids]`` for a DTensor ``table`` ``[R, C]``: vocab-parallel.
    Over an axis that splits the table's rows, the ids are gathered (they
    are small) and each device looks them up in its own block, zeros
    elsewhere: a partial sum over that axis, reduce-scattered back onto
    the ids' split where the ids were split there.  An axis that
    splits the columns keeps them split, unless it also splits the ids
    (then the columns are gathered)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    ids_pl = tuple(ids.placements)
    tp, ip = [], []
    for pt, pi in zip(table.placements, ids.placements):
        d = _shard_dim(pt)
        if d == 0:
            tp.append(pt), ip.append(Replicate())
        elif d is not None and _shard_dim(pi) is not None:
            tp.append(Replicate()), ip.append(pi)
        else:
            tp.append(pt), ip.append(pi)
    table, ids = _redistribute(table, tp), _redistribute(ids, ip)
    row_axes = [i for i, p in enumerate(tp) if _shard_dim(p) == 0]
    start = block_index(mesh, row_axes)
    out_pl = []
    for i, (pt, pi) in enumerate(zip(tp, ip)):
        if i in row_axes:
            out_pl.append(Partial())
        elif _shard_dim(pt) == 1:
            out_pl.append(Shard(ids.dim()))
        elif _shard_dim(pi) is not None:
            out_pl.append(Shard(_shard_dim(pi)))
        else:
            out_pl.append(Replicate())

    def local(t, i):
        if not row_axes:
            return t[i.long()]
        rows = t.shape[0]
        rel = i.long() - start * rows
        ok = (rel >= 0) & (rel < rows)
        return t[rel.clamp(0, rows - 1)] * ok[..., None].to(t.dtype)

    out = run_local(local, (table, ids), tuple(out_pl),
                    shapes=tuple(ids.shape) + tuple(table.shape[1:]))
    # the partial sums back onto the ids' own split: a reduce-scatter
    back = [p if i in row_axes and _shard_dim(p) is not None else q
            for i, (p, q) in enumerate(zip(ids_pl, out.placements))]
    return _redistribute(out, back)


def split_dim(t, dim: int, *shape):
    """``t`` with dimension ``dim`` reshaped to ``shape`` (e.g. a feature
    dimension into heads).  On a DTensor, a mesh axis that splits ``dim``
    is gathered first where the split would not fall on ``shape[0]``'s
    boundaries (40 heads over 16 devices), where the reference's
    partitioner would pad."""
    from torch.distributed.tensor import Replicate

    dim %= t.dim()
    if is_dtensor(t):
        mesh = t.device_mesh
        want, run = list(t.placements), 1
        for i, p in enumerate(t.placements):  # mesh order: the major split first
            if _shard_dim(p) is not None and _shard_dim(p) % t.dim() == dim:
                if shape[0] % (run * mesh.size(i)):
                    want[i] = Replicate()
                else:
                    run *= mesh.size(i)
        t = _redistribute(t, want)
        out = (*t.shape[:dim], *shape, *t.shape[dim + 1:])
        try:
            return _Reshape.apply(t, out, range(dim, dim + len(shape)))
        except RuntimeError:  # a split DTensor cannot express: gather the dimension
            return _Reshape.apply(_whole(t, dim), out, range(dim, dim + len(shape)))
    return t.reshape(*t.shape[:dim], *shape, *t.shape[dim + 1:])


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward first gathers the mesh axes that
    split the reshaped dimensions of the incoming gradient (which the
    downstream ops may have split anywhere), so the reverse reshape is one
    DTensor can express."""

    @staticmethod
    def forward(ctx, t, shape, dims):
        ctx.shape, ctx.dims = tuple(t.shape), tuple(dims)
        return t.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            g = _whole(g, *ctx.dims)
        return g.reshape(ctx.shape), None, None


def merge_dims(t, dim: int):
    """``t`` with dimensions ``dim`` and ``dim + 1`` flattened into one.  On
    a DTensor, a mesh axis that splits the inner one, or the outer one
    unevenly, is gathered first."""
    from torch.distributed.tensor import Replicate

    dim %= t.dim()
    if is_dtensor(t):
        mesh = t.device_mesh
        want = []
        for i, p in enumerate(t.placements):
            d = _shard_dim(p)
            d = None if d is None else d % t.dim()
            bad = d == dim + 1 or (d == dim and t.shape[dim] % mesh.size(i))
            want.append(Replicate() if bad else p)
        t = _redistribute(t, want)
        return _Reshape.apply(t, (*t.shape[:dim], t.shape[dim] * t.shape[dim + 1],
                                  *t.shape[dim + 2:]), (dim,))
    return t.reshape(*t.shape[:dim], t.shape[dim] * t.shape[dim + 1], *t.shape[dim + 2:])


def as_placed(t, like):
    """``t`` (a plain tensor, or a DTensor) laid out as ``like``'s leading
    dimensions are: the same splits of those dimensions, whole elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    want = [p if _shard_dim(p) is not None and _shard_dim(p) % like.dim() < t.dim()
            else Replicate() for p in like.placements]
    return _redistribute(t, want)


def take_last(logits, idx):
    """``logits.gather(-1, idx[..., None])[..., 0]`` on each device's rows:
    the last dimension gathered whole, the ids split like the rows (a
    DTensor gather strategy would mask)."""
    logits = whole_last(logits)
    idx = as_placed(idx, logits)
    return run_local(lambda lg, y: lg.gather(-1, y.long().unsqueeze(-1)).squeeze(-1),
                     (logits, idx), tuple(logits.placements))


def index_copy(t, dim: int, index: torch.Tensor, src):
    """``t.index_copy(dim, index, src)`` of DTensors on each device's shard
    (``dim`` whole on every device; ``src`` laid out as ``t``)."""
    t = _whole(t, dim)
    src = _redistribute(src, t.placements) if is_dtensor(src) else src
    return run_local(lambda a, b: a.index_copy(dim, index, b), (t, src), tuple(t.placements),
                     shapes=tuple(t.shape))


def index_select(t, dim: int, index: torch.Tensor):
    """``t.index_select(dim, index)`` on each device's shard, ``dim`` whole
    on every device (its backward, an ``index_add``, runs per shard too)."""
    if not is_dtensor(t):
        return t.index_select(dim, index)
    t = _whole(t, dim)
    shape = list(t.shape)
    shape[dim] = index.shape[0]
    return run_local(lambda a: a.index_select(dim, index), (t,), tuple(t.placements),
                     shapes=tuple(shape))


def roll(t, shift: int, dim: int):
    """``torch.roll(t, shift, dim)`` as two slices and a concatenation (which
    DTensor shards where the rolled dimension is whole)."""
    n = t.shape[dim]
    shift %= n
    if not shift:
        return t
    return torch.cat([t.narrow(dim, n - shift, shift), t.narrow(dim, 0, n - shift)], dim=dim)


def whole_last(t):
    """A DTensor with its last dimension gathered on every device (a
    softmax's or an argmax's axis); a plain tensor as it is."""
    return _whole(t, -1) if is_dtensor(t) else t


def edge_local(fn: Callable, nodes: Sequence, edges: Sequence, out: str = "nodes",
               reduce_op: str = "sum"):
    """``fn(*nodes, *edges)`` on each device's edges (the §5.2 MapReduce):
    the edge tensors split alike over the axes that split the first one's
    rows, the node tensors whole over their rows on every device (gathered
    where split; their gradients partial sums).  ``out='nodes'``: the
    result is a node tensor, a partial sum (``reduce_op``) over the edge
    axes; ``out='edges'``: an edge tensor, split like the edges."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    first = next(t for t in (*edges, *nodes) if is_dtensor(t))
    mesh = first.device_mesh
    lead = next((t for t in edges if is_dtensor(t)
                 and any(_shard_dim(p) == 0 for p in t.placements)), None)
    edge_axes = ([i for i, p in enumerate(lead.placements) if _shard_dim(p) == 0]
                 if lead is not None else [])
    epl = tuple(Shard(0) if i in edge_axes else Replicate() for i in range(mesh.ndim))

    def as_d(t, pl):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)

    edges = [as_d(t, epl) for t in edges]
    feat = {}
    node_args, grads = [], []
    for t in nodes:
        if not is_dtensor(t):
            t = as_d(t, (Replicate(),) * mesh.ndim)
        pl = tuple(Replicate() if _shard_dim(p) in (None, 0) or i in edge_axes else p
                   for i, p in enumerate(t.placements))
        for i, p in enumerate(pl):
            if _shard_dim(p) is not None and i not in edge_axes:
                feat[i] = p
        node_args.append(_redistribute(t, pl))
        grads.append(tuple(Partial() if i in edge_axes else p for i, p in enumerate(pl)))
    out_pl = []
    for i in range(mesh.ndim):
        if i in edge_axes:
            out_pl.append(Partial(reduce_op) if out == "nodes" else Shard(0))
        else:
            out_pl.append(feat.get(i, Replicate()))
    return run_local(fn, (*node_args, *edges), tuple(out_pl),
                     grad_placements=(*grads, *([None] * len(edges))))
