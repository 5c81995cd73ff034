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


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    ``dim`` in the group's rank order."""
    _count("all_gather", t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """SUM (``op="sum"``) or MAX over the group; returns a new tensor."""
    _count({"sum": "all_reduce_sum", "max": "all_reduce_max"}[op], t)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    return out
