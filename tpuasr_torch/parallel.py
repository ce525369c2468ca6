"""The collectives of distributed training and their autograd.

``torch.distributed`` calls outside the kernels, over a rank's groups
(``Group``; ``train.mesh.make_mesh`` makes them): ``all_reduce``,
``all_gather`` and ``broadcast`` only, since gloo has no
``reduce_scatter``. On gloo, collectives of CUDA tensors go through host
memory (ranks that share one card); NCCL takes them on the card.

Autograd through the collectives (``SumOverGroup``, ``CopyToModel``,
``GatherDirections``, ``GatherColumns``): after the recurrent layers
every model rank computes the same loss from the same values, so a
gather's backward keeps the rank's own piece of the (replicated)
gradient and never sums it, while the gradient of a recurrent layer's
input, which each direction saw only in part, is summed over the model
group (Megatron's f and g pair).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """One of a rank's groups: the process group, its size, the rank's
    index in it, and whether CUDA tensors go through host memory."""

    pg: object
    size: int
    index: int
    staged: bool = False


def _host(t: torch.Tensor, staged: bool) -> torch.Tensor:
    return t.cpu() if staged else t


def all_reduce(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """``t`` summed over ``group`` (in place, returned); a no-op without
    a group, and on a staged group of one rank (no round trip through
    host memory for nothing)."""
    if group is None or (group.staged and group.size == 1):
        return t
    h = _host(t, group.staged)
    dist.all_reduce(h, group=group.pg)
    if h is not t:
        t.copy_(h)
    return t


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """(group.size, *t.shape): every rank's ``t`` in group-index order."""
    h = _host(t.contiguous(), group.staged)
    parts = [torch.empty_like(h) for _ in range(group.size)]
    dist.all_gather(parts, h, group=group.pg)
    return torch.stack(parts).to(t.device)


def broadcast(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` (in place) as the group's first rank holds it."""
    h = _host(t, group.staged)
    dist.broadcast(h, src=dist.get_global_rank(group.pg, 0), group=group.pg)
    if h is not t:
        t.copy_(h)
    return t


class SumOverGroup(torch.autograd.Function):
    """Sum over a group whose ranks each add their own part of one loss:
    the gradient of every part is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (a recurrent layer's input under direction TP, where each rank
    sees it through one direction)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class GatherDirections(torch.autograd.Function):
    """(group.size, *x.shape), every model rank's ``x``; the backward
    keeps the rank's own slice of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.index = group.index
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None


class GatherColumns(torch.autograd.Function):
    """The model ranks' shards joined along the last axis (a gate-sharded
    weight made whole); the backward keeps the rank's own columns of the
    replicated gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.index, ctx.cols = group.index, x.shape[-1]
        parts = all_gather(x, group)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.cols, ctx.cols), None
