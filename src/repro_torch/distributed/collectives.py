"""The port's collectives: every cross-rank call of the port goes through
this module, which counts it.

The reference reads its collectives off compiled HLO (``dryrun.
collective_stats``, ``analysis/hlo.partial_sum_allreduces``); the port makes
them as explicit ``torch.distributed`` calls, so the count comes from the
calls themselves. Three kinds are counted, each with its calls and the
bytes of the local tensors sent into them:

* ``all_gather``: a tensor's bands from every rank of a group,
  concatenated in rank order along one dim;
* ``all_reduce_sum``: a SUM over a group, the partial-sum all-reduce the
  CASCADE placement removes from the serving graph (paper Sections 2.2,
  13.5);
* ``all_reduce_max``: a MAX over a group (no partial sum: the compressed
  all-reduce's shared scale).

The counters are per process: each rank counts its own calls.

Under autograd (a training step on a mesh, the dry run's train cells) the
calls are differentiable in explicit SPMD, where every rank of the group
computes the same function of what a collective hands it: the gradient of
an all-gather is this rank's band of the (replicated) output gradient, of
a SUM all-reduce the output gradient itself. A replicated tensor that
feeds a rank's own band of work (a column-banded linear's input) passes
through :func:`sum_grads`, which all-reduces its gradient (the rank's
partial of it) and is counted there.

NCCL takes one rank a card; ranks sharing one card run gloo, which takes
CUDA tensors in these three collectives (the H100's torch, 2.11), so no call
is staged through host memory.
"""
from __future__ import annotations

import copy

import torch
import torch.distributed as dist

KINDS = ("all_gather", "all_reduce_sum", "all_reduce_max")

#: calls and payload bytes since the last reset, by kind
COUNTS = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_counts() -> None:
    for k in KINDS:
        COUNTS[k] = {"calls": 0, "bytes": 0}


def snapshot() -> dict:
    return copy.deepcopy(COUNTS)


def since(before: dict) -> dict:
    """The calls and bytes of each kind made since ``snapshot()`` returned
    ``before``."""
    return {k: {f: COUNTS[k][f] - before[k][f] for f in ("calls", "bytes")} for k in KINDS}


def partial_sum_allreduces(counts: dict) -> int:
    """The partial-sum all-reduces among ``counts`` (a :func:`since` record)."""
    return counts["all_reduce_sum"]["calls"]


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind]["calls"] += 1
    COUNTS[kind]["bytes"] += t.numel() * t.element_size()


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    _count("all_gather", t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    _count("all_reduce_sum", t)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.width, ctx.sum_grads = group, dim, t.shape[dim], sum_grads
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = _all_reduce_sum(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


def all_gather(t: torch.Tensor, group, dim: int = -1, sum_grads: bool = False) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    ``dim`` in the group's rank order. ``sum_grads``: the ranks use what
    they gather on rows of their own (a weight band gathered whole under
    full data parallelism), so the gradient is summed over the group
    before this rank's band is taken."""
    if t.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(t, group, dim, sum_grads)
    return _all_gather(t, group, dim)


def sum_grads(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; under autograd its gradient is all-reduced (summed)
    over ``group``: every rank's partial gradient of a replicated tensor
    that fed this rank's band of work."""
    if t.requires_grad and torch.is_grad_enabled():
        return _SumGrads.apply(t, group)
    return t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """SUM (``op="sum"``) or MAX over the group; returns a new tensor."""
    if op == "sum":
        if t.requires_grad and torch.is_grad_enabled():
            return _AllReduceSum.apply(t, group)
        return _all_reduce_sum(t, group)
    _count("all_reduce_max", t)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
