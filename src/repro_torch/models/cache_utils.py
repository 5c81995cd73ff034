"""Continuous-batching slot operations on stacked caches, and layer views.

The serving engine keeps ONE stacked cache for the whole slot grid. Every
model's cache is ``{"layers": {...}}`` with each leaf stacked ``(L, B,
...)``, plus, for some models, per-slot leaves beside ``layers`` that are
``(B, ...)``:

* dense transformer: ``{"layers": {"k", "v": (L, B, T, Hkv, D), "pos": (L, B)}}``;
* Mamba-2: ``{"layers": {"conv": (L, B, w-1, conv_dim), "state": (L, B, H,
  P, N)}, "pos": (B,)}``.

The slot axis is stated, not probed: axis 1 under ``layers``, axis 0
beside it. Admission writes a batch-1 cache into a slot in place; nothing
is reallocated.
"""
from __future__ import annotations

import torch

#: the slot (batch) axis of every leaf stacked under ``layers``
LAYER_SLOT_AXIS = 1
#: the slot axis of a per-slot leaf beside ``layers`` (Mamba-2's ``pos``)
TOP_SLOT_AXIS = 0


def _leaves(cache: dict):
    """(path, leaf, slot axis) for every leaf of a stacked cache."""
    for name, buf in cache["layers"].items():
        yield ("layers", name), buf, LAYER_SLOT_AXIS
    for name, buf in cache.items():
        if name != "layers":
            yield (name,), buf, TOP_SLOT_AXIS


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def cache_at(cache: dict, i: int) -> dict:
    """Batch-1 view of slot ``i`` (shares storage with the grid)."""
    out: dict = {"layers": {}}
    for path, buf, ax in _leaves(cache):
        parent = out["layers"] if path[0] == "layers" else out
        parent[path[-1]] = buf.narrow(ax, i, 1)
    return out


def write_cache(cache: dict, sub: dict, i: int) -> dict:
    """Write a batch-1 cache ``sub`` into slot ``i`` of ``cache``, in place,
    cast to the grid's dtype as the reference's ``write_cache`` casts."""
    for path, buf, ax in _leaves(cache):
        buf.narrow(ax, i, 1).copy_(_get(sub, path))
    return cache


def layer_view(tree, i: int):
    """The i-th layer's view of a stacked param or cache tree."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def stack_layers(trees: list):
    """Stack per-layer trees into one tree of (L, ...) leaves."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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
