"""GPipe pipeline parallelism over one mesh axis (counterpart of
``repro.sharding.pipeline``).

The layer stack is split into ``n_stages`` contiguous stages, one a rank
along one dimension of a ``DeviceMesh`` (the multi-pod mesh's 'pod' axis:
pipeline traffic, one activation a microbatch a boundary, is the lightest
cut of a model, so it takes the slowest links).  Microbatches stream
through the stages in the GPipe tick schedule:

    for t in range(n_micro + n_stages - 1):      # pipeline "ticks"
        each stage processes microbatch (t - stage) if in range
        boundary activations shift stage -> stage+1

The schedule is one ``torch.autograd.Function``.  Its forward runs the
ticks, each shift one ``batch_isend_irecv`` a rank (send to the next
stage, receive from the previous), and keeps each tick's stage input; its
backward runs the ticks in reverse, recomputes each active tick's stage
output from the kept input (GPipe's recompute) and shifts the input
gradients the other way, to the previous stage: JAX's AD through the
reference's ``ppermute``.  Both directions exchange at the same ticks on
every rank, so the sends pair up whatever order autograd would pick.  An
idle tick sends zeros and computes nothing (the reference computes it and
masks the result: the same values).  The bubble is the (n_stages - 1) /
(n_micro + n_stages - 1) idle fraction (:func:`bubble_fraction`).  The
last stage's outputs go to every rank (a broadcast); the loss of that
replicated output is taken once, so its gradient enters on the last
stage.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _exchange(h: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Sends ``h`` to global rank ``send_to`` and returns what ``recv_from``
    sends (either may be -1: no peer; nothing received is zeros)."""
    out = torch.zeros_like(h)
    ops = []
    if send_to >= 0:
        ops.append(dist.P2POp(dist.isend, h.contiguous(), send_to, group))
    if recv_from >= 0:
        ops.append(dist.P2POp(dist.irecv, out, recv_from, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, x, fn, group, stage: int, n_stages: int, prev: int, nxt: int,
                last_rank: int):
        n_micro = x.shape[0]
        is_last = stage == n_stages - 1
        outs = torch.zeros_like(x)
        inbuf = torch.zeros_like(x[0])
        ins = []
        for t in range(n_micro + n_stages - 1):
            mb = t - stage  # the microbatch this stage works on at tick t
            x_in = x[min(max(mb, 0), n_micro - 1)] if stage == 0 else inbuf
            ins.append(x_in)
            h = fn(params, x_in) if 0 <= mb < n_micro else torch.zeros_like(x_in)
            if is_last and 0 <= mb < n_micro:
                outs[mb] = h
            inbuf = _exchange(h, group, send_to=nxt, recv_from=prev)
        dist.broadcast(outs, src=last_rank, group=group)
        ctx.save_for_backward(params, *ins)
        ctx.meta = (fn, group, stage, n_stages, prev, nxt)
        return outs

    @staticmethod
    def backward(ctx, g_out):
        params, *ins = ctx.saved_tensors
        fn, group, stage, n_stages, prev, nxt = ctx.meta
        n_micro = g_out.shape[0]
        n_ticks = n_micro + n_stages - 1
        g_params = torch.zeros_like(params)
        g_x_in = None  # the gradient of the stage input of the tick after this one
        for t in reversed(range(n_ticks)):
            g_h = torch.zeros_like(ins[t])
            if t < n_ticks - 1:  # the last tick's shift reaches no one's loss
                send = g_x_in if g_x_in is not None else torch.zeros_like(ins[t])
                g_h = _exchange(send, group, send_to=prev, recv_from=nxt)
            mb = t - stage
            g_x_in = None
            if 0 <= mb < n_micro:
                if stage == n_stages - 1:
                    g_h = g_h + g_out[mb]
                with torch.enable_grad():
                    p = params.detach().requires_grad_()
                    xi = ins[t].detach().requires_grad_(stage > 0)
                    wrt = (p, xi) if stage > 0 else (p,)
                    grads = torch.autograd.grad(fn(p, xi), wrt, g_h)
                g_params += grads[0]
                if stage > 0:
                    g_x_in = grads[1]
        return g_params, None, None, None, None, None, None, None, None


def pipelined_apply(
    mesh,
    axis: str,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: torch.Tensor,  # [n_stages, ...]: this rank applies its stage's slice
    x: torch.Tensor,  # [n_micro, micro_batch, ...] microbatched input, the same on every rank
) -> torch.Tensor:
    """Runs ``x`` through ``n_stages`` pipeline stages laid out along
    ``axis`` of ``mesh`` (a ``DeviceMesh`` of a running process group).

    ``stage_fn(params_for_stage, h) -> h`` must preserve h's shape (the
    transformer-layer contract).  ``stage_params`` is the stacked
    parameters of every stage (a DTensor split along ``axis`` on dim 0 is
    taken as its local block); this rank applies slice ``stage``, so its
    gradient lands in that slice.  Returns ``[n_micro, micro_batch, ...]``
    outputs of the LAST stage, on every rank."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    prev = ranks[stage - 1] if stage > 0 else -1
    nxt = ranks[stage + 1] if stage < n_stages - 1 else -1
    if hasattr(stage_params, "to_local"):
        params = stage_params.to_local()[0]
    else:
        params = stage_params[stage]
    return _GPipe.apply(params, x, stage_fn, group, stage, n_stages, prev, nxt, ranks[-1])
