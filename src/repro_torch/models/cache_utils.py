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

Speculative rewind primitives (the verify pass appends a draft chunk, then
each slot keeps only its accepted prefix):

* **seq-indexed KV** (linear caches): snapshot the rows the chunk will
  overwrite BEFORE the verify pass, then restore the rejected rows in place
  and rewind the per-slot position. A dense cache strictly needs only the
  position rewind (stale rows above ``pos`` are masked), but the rows are
  restored as in the reference. The ring-buffer branch waits for windowed
  attention.
* **recurrent state** (conv window, SSD state): the verify pass checkpoints
  the state after every chunk token and the rewind selects checkpoint
  ``keep[b]`` per slot (``slice_rows_per_slot``).
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


def _rows(pos: torch.Tensor, s: int, t: int) -> tuple:
    """Index tuple selecting rows ``min(pos + j, t - 1)``, j < s, of every
    (lead..., B, T, ...) buffer whose position table is ``pos`` (lead..., B)."""
    lead = pos.shape
    rows = (pos.to(torch.int64)[..., None] + torch.arange(s, device=pos.device)).clamp_(max=t - 1)
    idx = [torch.arange(n, device=pos.device).reshape((n,) + (1,) * (len(lead) - i))
           for i, n in enumerate(lead)]
    return tuple(idx) + (rows,)


def seq_rows_snapshot(cache: dict, s: int, out: dict | None = None) -> dict:
    """Copy the ``s`` rows an extend of length ``s`` will write.

    ``cache`` is one attention-cache dict: a per-slot position table ``pos``
    (lead..., B) beside seq-indexed buffers (lead..., B, T, ...). Rows
    ``pos + j`` are copied (clamped to the last row, as the reference's
    ``take_along_axis`` clamps; the engine keeps ``pos + s <= T`` for live
    slots), as is ``pos``. The rows are COPIED: the verify pass then
    overwrites the cache in place. With ``out`` (a snapshot of the same
    shapes) the copy lands there and ``out`` is returned.
    """
    pos = cache["pos"]
    snap = {}
    for name, buf in cache.items():
        if name == "pos":
            continue
        rows = buf[_rows(pos, s, buf.shape[pos.dim()])]
        snap[name] = rows if out is None else out[name].copy_(rows)
    snap["pos"] = pos.clone() if out is None else out["pos"].copy_(pos)
    return snap


def seq_rows_restore(cache: dict, snap: dict, keep: torch.Tensor) -> dict:
    """Rewind a seq-indexed cache after a verify pass, in place.

    The first ``keep[b]`` chunk rows stay committed; rows ``keep[b]..s-1``
    are restored from the snapshot and the per-slot position is rewound to
    ``pos0 + keep[b]``. ``keep`` is (B,) (0 for inactive slots: a full
    rewind restores the pre-verify cache). Returns ``cache``.
    """
    pos0 = snap["pos"]
    name0 = next(n for n in snap if n != "pos")
    s = snap[name0].shape[pos0.dim()]
    keep = keep.to(pos0.device)
    rejected = torch.arange(s, device=pos0.device) >= keep.to(torch.int64)[:, None]  # (B, s)
    for name, buf in cache.items():
        if name == "pos":
            continue
        idx = _rows(pos0, s, buf.shape[pos0.dim()])
        mask = rejected.reshape(rejected.shape + (1,) * (buf.dim() - pos0.dim() - 1))
        buf[idx] = torch.where(mask, snap[name], buf[idx])
    cache["pos"].copy_(pos0 + keep.to(pos0.dtype))
    return cache


def slice_rows_per_slot(ck: torch.Tensor, keep: torch.Tensor, b_axis: int, n: int) -> torch.Tensor:
    """Rows ``keep[b] .. keep[b] + n - 1`` along axis ``b_axis + 1`` of a
    checkpoint stack ``ck`` (lead..., B, C, rest...), per slot b: the
    recurrent rewind primitive (conv windows: n = width - 1; states: n = 1).
    Returns (lead..., B, n, rest...)."""
    b = ck.shape[b_axis]
    rows = keep.to(device=ck.device, dtype=torch.int64)[:, None] + torch.arange(n, device=ck.device)
    slot = torch.arange(b, device=ck.device)[:, None]
    return ck[(slice(None),) * b_axis + (slot, rows)]
