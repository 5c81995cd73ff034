"""The port's collectives: every cross-rank call of the port goes through
this module, which counts it.

The reference reads its collectives off compiled HLO (``dryrun.
collective_stats``, ``analysis/hlo.partial_sum_allreduces``); the port makes
them as explicit ``torch.distributed`` calls, so the count comes from the
calls themselves. Five kinds are counted, each with its calls and the
bytes of the local tensors sent into them:

* ``all_gather``: a tensor's bands from every rank of a group,
  concatenated in rank order along one dim;
* ``all_reduce_sum``: a SUM over a group, the partial-sum all-reduce the
  CASCADE placement removes from the serving graph (paper Sections 2.2,
  13.5);
* ``all_reduce_max``: a MAX over a group (no partial sum: the compressed
  all-reduce's shared scale);
* ``reduce_scatter``: a SUM over a group of which each rank keeps one
  band along a dim (ZeRO's gradients onto their data band, megatron's
  partial sums onto a rank's rows under sequence parallelism);
* ``all_to_all``: each rank's tensor cut into the group's bands along one
  dim, band j sent to rank j, the received bands concatenated along
  another dim (a column band's output to the rank's rows under sequence
  parallelism; expert weights from column bands to expert bands).

The counters are per process: each rank counts its own calls.

Under autograd (a training step on a mesh, the dry run's train cells) the
calls are differentiable in explicit SPMD, where every rank of the group
computes the same function of what a collective hands it: the gradient of
an all-gather is this rank's band of the (replicated) output gradient, of
a SUM all-reduce the output gradient itself, of a reduce-scatter the
all-gathered output gradient, of an all-to-all the all-to-all back, and of
:func:`split` (this rank's band, no call) the all-gathered gradient. A
replicated tensor that
feeds a rank's own band of work (a column-banded linear's input) passes
through :func:`sum_grads`, which all-reduces its gradient (the rank's
partial of it) and is counted there.

NCCL takes one rank a card; ranks sharing one card run gloo, which takes
CUDA tensors in all five collectives (the H100's torch, 2.11), so no call
is staged through host memory.
"""
from __future__ import annotations

import copy

import torch
import torch.distributed as dist

KINDS = ("all_gather", "all_reduce_sum", "all_reduce_max", "reduce_scatter", "all_to_all")

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


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    _count("reduce_scatter", t)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_to_all(t: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    _count("all_to_all", t)
    src = t.movedim(split_dim, 0).contiguous()
    got = torch.empty_like(src)
    dist.all_to_all_single(got, src, group=group)
    # the ranks' bands along split_dim, in rank order, laid side by side
    parts = got.movedim(0, split_dim).chunk(dist.get_world_size(group), dim=split_dim)
    return torch.cat(parts, dim=cat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, sum_grads, grad_op):
        ctx.group, ctx.dim, ctx.width, ctx.sum_grads = group, dim, t.shape[dim], sum_grads
        ctx.grad_op = grad_op
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads and ctx.grad_op == "reduce_scatter":
            return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None, None
        if ctx.sum_grads:
            g = _all_reduce_sum(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width), None, None, None, None


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


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return _all_to_all(t, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.cat_dim, ctx.split_dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        w = t.shape[dim] // n
        return t.narrow(dim, r * w, w)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def all_gather(t: torch.Tensor, group, dim: int = -1, sum_grads: bool = False,
               grad_op: str = "all_reduce") -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    ``dim`` in the group's rank order. ``sum_grads``: the ranks use what
    they gather on rows of their own (a weight band gathered whole under
    full data parallelism), so the gradient is summed over the group
    before this rank's band is taken: by an all-reduce and a narrow, or
    (``grad_op="reduce_scatter"``, FSDP's) by one reduce-scatter."""
    if t.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(t, group, dim, sum_grads, grad_op)
    return _all_gather(t, group, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The SUM of ``t`` over the group, of which this rank keeps its band
    along ``dim`` (the group's size divides it); under autograd the
    gradient is the output gradients all-gathered."""
    if t.requires_grad and torch.is_grad_enabled():
        return _ReduceScatter.apply(t, group, dim)
    return _reduce_scatter(t, group, dim)


def all_to_all(t: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``t`` cut into the group's bands along ``split_dim``, band j sent to
    rank j; what each rank sent this one, concatenated along ``cat_dim`` in
    rank order. A column band (..., S, N/m) becomes this rank's rows with
    every column (..., S/m, N) with ``split_dim=-2, cat_dim=-1``."""
    if t.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(t, group, split_dim, cat_dim)
    return _all_to_all(t, group, split_dim, cat_dim)


def split(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's band of ``t`` (whole and equal on every rank of the
    group) along ``dim``, with no call; under autograd the ranks' band
    gradients are all-gathered into the whole one."""
    if t.requires_grad and torch.is_grad_enabled():
        return _Split.apply(t, group, dim)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w = t.shape[dim] // n
    return t.narrow(dim, r * w, w)


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
