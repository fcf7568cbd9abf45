"""Pipeline parallelism over a mesh axis (GPipe schedule; the port of
``repro.train.pipeline``).

``pipeline_apply`` runs on every rank of a mesh axis's process group: each
rank holds one *stage* (a slice of the layer stack) and microbatches flow
stage → stage through :func:`ppermute`, a ``torch.autograd.Function`` that
sends to the next stage and receives from the previous one with
``dist.batch_isend_irecv``.  The schedule is the classic GPipe bubble:
T = M + S − 1 ticks for M microbatches over S stages.  Autograd
differentiates straight through: the backward of a ppermute is the reversed
permutation, as JAX's transpose is, which gives the symmetric backward
schedule.  Every rank runs the backward of every tick's ppermute in the same
(reverse) order, so the sends and receives pair up.

Intended placement (multi-pod mesh): the ``pod`` axis as stages when the
cross-pod link is too slow for a per-step gradient all-reduce; then only
microbatch activations cross pods, once a tick.  Bubble fraction =
(S − 1)/(M + S − 1): pick M ≥ 4·S.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial

from ..models.params import tree_map


class _PPermute(torch.autograd.Function):
    """Group rank ``src`` sends ``x`` to ``dst`` for each (src, dst) pair;
    a rank that receives nothing gets zeros (``lax.ppermute``)."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _exchange(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        reverse = tuple((dst, src) for src, dst in ctx.perm)
        return _exchange(grad.contiguous(), ctx.group, reverse), None, None


def _exchange(x: torch.Tensor, group, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst),
                                  group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def ppermute(x: torch.Tensor, group, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    return _PPermute.apply(x, group, tuple(perm))


class _StageSum(torch.autograd.Function):
    """The sum over the group's ranks (an all-reduce); its gradient is the
    incoming one, unchanged: every rank returns the same loss and
    back-propagates its own copy of the same cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x_mb) -> y_mb
    stage_params,  # params of MY stage
    x_mb: torch.Tensor,  # (M, mb, ...) microbatched input (stage 0 consumes)
    *,
    group,
    num_stages: int,
) -> torch.Tensor:
    """(M, mb, ...) last-stage outputs (zeros on the other stages).  Call
    on every rank of ``group``, whose rank is the stage."""
    s = dist.get_rank(group)
    M = x_mb.shape[0]
    fwd = [(i, i + 1) for i in range(num_stages - 1)]
    first = torch.tensor(s == 0, device=x_mb.device)
    buf = torch.zeros_like(x_mb[0])
    outs: list = []
    for t in range(M + num_stages - 1):
        # stage 0 injects microbatch t (clamped; inactive ticks are ignored)
        buf = torch.where(first, x_mb[min(t, M - 1)], buf)
        y = stage_fn(stage_params, buf)
        if not outs:
            outs = [torch.zeros_like(y)] * M
        # the last stage records its result at position t - (S - 1) when
        # active; a select on every stage keeps every tick in every rank's
        # backward graph, so the ranks' reversed ppermutes pair up
        at = min(max(t - (num_stages - 1), 0), M - 1)
        active = torch.tensor(s == num_stages - 1 and t >= num_stages - 1, device=y.device)
        outs[at] = torch.where(active, y, outs[at])
        buf = ppermute(y, group, fwd)  # hand my activation to the next stage
    return torch.stack(outs)


def _local(x, grad_partial: bool):
    """A DTensor's local part, whose gradient is ``Partial`` where asked (a
    replicated parameter that only one stage uses); a plain tensor as is."""
    if not isinstance(x, DTensor):
        return x
    if grad_partial:
        return x.to_local(grad_placements=[Partial()] * x.device_mesh.ndim)
    return x.to_local()


def make_pipelined_loss(
    stage_fn: Callable,  # (stage_params, x) -> x  (homogeneous stages)
    loss_head: Callable,  # (head_params, y_mb, target_mb) -> scalar
    mesh,
    axis_name: str = "pod",
):
    """Builds loss(params, batch) where params = {"stages": (S, ...) stacked
    stage params, "head": head params}; batch = {"x": (M, mb, ...),
    "y": (M, mb, ...)}.  ``mesh`` is a 1-D ``DeviceMesh`` over the stages
    (``axis_name`` its dim).  Stage leaves are DTensors sharded on dim 0
    over the axis (each rank holds its own stage) or whole tensors (each
    rank takes row ``s``); head leaves, replicated DTensors or whole
    tensors, live on the last stage.  The loss is computed there and summed
    over the stages, so every stage returns the same value; gradients flow
    to every stage's params (a replicated head's gradient is ``Partial``,
    nonzero on the last stage only)."""
    num_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    group = mesh.get_group(axis_name)

    def loss(params, batch):
        s = dist.get_rank(group)
        stage = tree_map(lambda a: _local(a, False)[0] if isinstance(a, DTensor) else a[s],
                         params["stages"])
        head = tree_map(lambda a: _local(a, True), params["head"])
        outs = pipeline_apply(stage_fn, stage, batch["x"], group=group, num_stages=num_stages)
        per_mb = loss_head(head, outs, batch["y"])
        last = torch.tensor(s == num_stages - 1, device=per_mb.device)
        return _StageSum.apply(torch.where(last, per_mb, 0.0), group)

    return loss
