"""Continuous-batching slot operations on the dense stacked KV cache.

The serving engine keeps ONE stacked cache for the whole slot grid:
``{"layers": {"k", "v": (L, B, T, Hkv, D), "pos": (L, B)}}``. The slot axis
is stated, not probed: it is axis 1 of every leaf. Admission writes a
batch-1 cache into a slot in place; nothing is reallocated.
"""
from __future__ import annotations

import torch

#: the slot (batch) axis of every leaf of a stacked dense cache
SLOT_AXIS = 1


def _leaves(cache: dict):
    return cache["layers"].items()


def cache_at(cache: dict, i: int) -> dict:
    """Batch-1 view of slot ``i`` (shares storage with the grid)."""
    return {"layers": {name: buf.narrow(SLOT_AXIS, i, 1) for name, buf in _leaves(cache)}}


def write_cache(cache: dict, sub: dict, i: int) -> dict:
    """Write a batch-1 cache ``sub`` into slot ``i`` of ``cache``, in place."""
    for name, buf in _leaves(cache):
        buf.narrow(SLOT_AXIS, i, 1).copy_(sub["layers"][name])
    return cache


def take_last_valid(x: torch.Tensor, n_valid) -> torch.Tensor:
    """(B, S, ...) -> (B, 1, ...) at index ``n_valid - 1`` per row.

    Chunks are right-padded, so the row that continues the stream is the
    last VALID one, not row S-1. The index is clamped into [0, S-1] as the
    reference's ``dynamic_slice`` clamps it.
    """
    b, s = x.shape[:2]
    nv = s if n_valid is None else n_valid
    if not isinstance(nv, torch.Tensor):          # one index for every row
        last = min(max(int(nv) - 1, 0), s - 1)
        return x[:, last:last + 1]
    last = (nv.to(torch.int64).expand(b) - 1).clamp(0, s - 1)
    return x[torch.arange(b, device=x.device), last][:, None]
