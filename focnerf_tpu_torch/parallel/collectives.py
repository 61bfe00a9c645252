"""Collectives over a process group, differentiable where the port needs it.

JAX differentiates ``all_gather``/``psum`` inside ``shard_map`` by their
transposes; these ``torch.autograd.Function``s reproduce those transposes
exactly, whatever the backend (gloo has no reduce-scatter, so the gather's
transpose all-reduces and keeps its own slot):

  - ``gather``: all-gather forward -> [W, *x.shape]; backward all-reduces
    (SUM) the cotangent over the ranks and keeps this rank's slot;
  - ``all_sum``: all-reduce SUM forward; backward is the identity on each
    rank (each rank differentiates its own share: a loss summed over the
    ranks would otherwise get its gradient W times);
  - ``all_max`` and ``all_mean``: forward only;
  - ``mean_gradients`` / ``sum_gradients``: the ``.grad`` of replicated
    parameters averaged (data parallel) or summed (each rank's share of
    one loss, the collapse-sharded factor steps) over the ranks.

Every rank of the group must make the same calls in the same order, the
backward ones included: a rank that drops a gathered value from its loss
still has to keep it in the graph (multiply it by 0), or the others wait
for it forever.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[ctx.rank], None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order -> [W, *x.shape]."""
    return _Gather.apply(x, group)


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``; the gradient stays with this rank's share."""
    return _Sum.apply(x, group)


def all_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` (no gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every rank's ``x`` (no gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)


def _reduce_gradients(tensors, group, mean: bool) -> None:
    tensors = list(tensors)
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.grad = flat[offset:offset + n].view_as(t).clone()
        offset += n


def mean_gradients(tensors, group=None) -> None:
    """Replace each tensor's ``.grad`` with its mean over the ranks, in one
    all-reduce of the flattened gradients (a tensor without a gradient
    counts as zeros). Every rank ends with the same bits."""
    _reduce_gradients(tensors, group, mean=True)


def sum_gradients(tensors, group=None) -> None:
    """Replace each tensor's ``.grad`` with its sum over the ranks (one
    all-reduce, as ``mean_gradients``): the gradient of a replicated input
    whose ranks each differentiate their own share of the loss, which JAX
    gets by psumming the cotangent of a ``P()`` input to ``shard_map``."""
    _reduce_gradients(tensors, group, mean=False)
