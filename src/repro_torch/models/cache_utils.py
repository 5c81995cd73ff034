"""Continuous-batching slot operations on stacked caches, and layer views.

The serving engine keeps ONE stacked cache for the whole slot grid. Every
model's cache is ``{"layers": {...}}`` with each leaf stacked ``(L, B,
...)``, plus, for some models, per-slot leaves beside ``layers`` that are
``(B, ...)``:

* dense transformer: ``{"layers": {"k", "v": (L, B, T, Hkv, D), "pos": (L, B)}}``;
* dense transformer, paged: ``{"layers": {"k", "v": (L, P, ps, Hkv, D), "pos":
  (L, B)}}``, a page pool shared by the slots (see the paged primitives below);
* Mamba-2: ``{"layers": {"conv": (L, B, w-1, conv_dim), "state": (L, B, H,
  P, N)}, "pos": (B,)}``;
* MoE: the dense transformer's (olmoe) or MLA's ``{"layers": {"c_kv": (L,
  B, T, kv_lora), "k_rope": (L, B, T, rope), "pos": (L, B)}}`` (deepseek-v2),
  one stack of every layer, and their paged pools ``(L, P, ps, ...)``;
* Griffin: its recurrent blocks' ``{"layers": {"conv": (Lr, B, w-1, lru),
  "h": (Lr, B, lru) f32}}`` beside its attention blocks' ring buffers
  ``{"attn": {"k", "v": (La, B, window, Hkv, D), "slot_pos": (La, B,
  window), "pos": (La, B)}}``.

The slot axis is stated for the slot operations below: axis 1 in
``layers`` and in every other dict of stacked leaves, axis 0 in a per-slot
leaf beside them. Mesh placement probes it instead, as the reference does
(:func:`probe_slot_axes`: build the cache at two batch sizes, the one axis
that changed is the slot axis), so :func:`slot_pspecs` places any model's
cache without a schema of its own.
Admission writes a batch-1 cache into a slot in place (a ring's
``slot_pos`` with it, so a reused slot keeps nothing of its last stream);
nothing is reallocated.

Speculative rewind primitives (the verify pass appends a draft chunk, then
each slot keeps only its accepted prefix):

* **seq-indexed KV** (linear caches): snapshot the rows the chunk will
  overwrite BEFORE the verify pass, then restore the rejected rows in place
  and rewind the per-slot position. A dense cache strictly needs only the
  position rewind (stale rows above ``pos`` are masked), but the rows are
  restored as in the reference. A ring buffer (a cache with ``slot_pos``)
  writes rows ``(pos + j) % T`` and loses clobbered in-window entries
  without the restore; its ``slot_pos`` rows are restored with them.
* **recurrent state** (conv window, SSD state): the verify pass checkpoints
  the state after every chunk token and the rewind selects checkpoint
  ``keep[b]`` per slot (``slice_rows_per_slot``).

Paged pool primitives (``paged_*``): the K/V of every slot live in one pool
of ``P`` pages of ``ps`` rows, ``(P, ps, rest...)`` per layer, and a
host-owned ``(B, nb)`` integer block table maps slot b's logical block j (rows
``j*ps .. j*ps+ps-1``) to a physical page. Page 0 is the TRASH page: never
allocated, so zeroed table rows (free slots), unbacked blocks and rows past
capacity land there instead of on a live page. Several writes of one call
may land on one trash row (CUDA then keeps an arbitrary one); that is
harmless only because no trash row is ever read as live: reads gather a
slot's pages back into the dense ``(B, nb*ps, rest...)`` view the dense
cache holds, and every row backed by the trash page sits above the slot's
``pos``, where attention gives it weight exactly 0. Writes go in place
through a flat ``(P*ps, rest...)`` view of each pool; no pool is rebuilt.
"""
from __future__ import annotations

import torch

#: the slot (batch) axis of every leaf stacked under ``layers`` (or another
#: dict of stacked leaves: Griffin's ``attn``)
LAYER_SLOT_AXIS = 1
#: the slot axis of a per-slot leaf beside ``layers`` (Mamba-2's ``pos``)
TOP_SLOT_AXIS = 0
#: probe shapes: small enough to be free (on the meta device), distinct
#: enough to be unambiguous
_PROBE_BATCHES = (2, 3)
_PROBE_LEN = 8


def probe_slot_axes(init_cache, probe_len: int = _PROBE_LEN):
    """The tree of per-leaf slot-axis indices, found by probing:
    ``init_cache(batch, max_len)`` at two batch sizes, and in each leaf
    exactly one axis must differ."""
    from repro_torch import tree as T
    b0, b1 = _PROBE_BATCHES
    small, big = init_cache(b0, probe_len), init_cache(b1, probe_len)

    def axis_of(a, b):
        diffs = [i for i, (p, q) in enumerate(zip(a.shape, b.shape)) if p != q]
        if len(diffs) != 1:
            raise ValueError(
                f"cache leaf {tuple(a.shape)} -> {tuple(b.shape)}: expected exactly one "
                f"batch-dependent axis, found {diffs}; every cache leaf must carry a "
                "per-slot dimension")
        return diffs[0]

    return T.tree_map(axis_of, small, big)


def slot_pspecs(spec, cache, mesh, data_axis: str = "data"):
    """The spec tree placing each leaf's probed slot axis over ``data_axis``
    (each data shard owns a contiguous band of slots) and every other dim
    replicated; a leaf whose slot extent the axis does not divide stays
    replicated."""
    from repro_torch import tree as T
    size = mesh.shape.get(data_axis, 1) if mesh is not None else 1

    def one(ax, leaf):
        parts = [None] * leaf.dim()
        if size > 1 and leaf.shape[ax] % size == 0:
            parts[ax] = data_axis
        return tuple(parts)

    return T.tree_map(one, spec, cache)


def model_cache_pspecs(model, cache, mesh, data_axis: str = "data"):
    """A model's ``cache_pspecs``: its cache's slot axes probed once (on
    the meta device), then :func:`slot_pspecs`."""
    axes = getattr(model, "_slot_axes", None)
    if axes is None:
        axes = probe_slot_axes(lambda b, t: model.init_cache(b, t, device="meta"))
        model._slot_axes = axes
    return slot_pspecs(axes, cache, mesh, data_axis)


def _leaves(cache: dict):
    """(path, leaf, slot axis) for every leaf of a stacked cache."""
    for group, node in cache.items():
        if isinstance(node, dict):
            for name, buf in node.items():
                yield (group, name), buf, LAYER_SLOT_AXIS
        else:
            yield (group,), node, TOP_SLOT_AXIS


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def cache_at(cache: dict, i: int) -> dict:
    """Batch-1 view of slot ``i`` (shares storage with the grid)."""
    out: dict = {}
    for path, buf, ax in _leaves(cache):
        parent = out.setdefault(path[0], {}) if len(path) == 2 else out
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


def unstack_layers(tree) -> list:
    """Every layer's view of a stacked param tree at once (one
    ``torch.unbind`` a leaf). Under autograd the views' gradients reach the
    stacked leaf as one stack, where a ``layer_view`` a layer would add a
    zero-padded copy of the whole leaf for each layer."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


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


def _rows(pos: torch.Tensor, s: int, t: int, ring: bool = False) -> tuple:
    """Index tuple selecting rows ``min(pos + j, t - 1)`` (a ring buffer's
    ``(pos + j) % t``), j < s, of every (lead..., B, T, ...) buffer whose
    position table is ``pos`` (lead..., B)."""
    lead = pos.shape
    rows = pos.to(torch.int64)[..., None] + torch.arange(s, device=pos.device)
    rows = rows % t if ring else rows.clamp_(max=t - 1)
    idx = [torch.arange(n, device=pos.device).reshape((n,) + (1,) * (len(lead) - i))
           for i, n in enumerate(lead)]
    return tuple(idx) + (rows,)


#: one-byte float dtypes: a cache of them is moved row by row as its bytes
FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a float8 ``t`` viewed as uint8: the row copies,
    gathers, scatters and selects of an FP8 cache move its codes as bytes
    (CUDA has no float8 ``index_copy_``, ``index_put_`` or ``where``)."""
    return t.view(torch.uint8) if t.dtype in FLOAT8 else t


def seq_rows_snapshot(cache: dict, s: int, out: dict | None = None) -> dict:
    """Copy the ``s`` rows an extend of length ``s`` will write.

    ``cache`` is one attention-cache dict: a per-slot position table ``pos``
    (lead..., B) beside seq-indexed buffers (lead..., B, T, ...). Rows
    ``pos + j`` are copied (clamped to the last row, as the reference's
    ``take_along_axis`` clamps; the engine keeps ``pos + s <= T`` for live
    slots; a ring buffer's rows ``(pos + j) % T``, its ``slot_pos`` too), as
    is ``pos``. The rows are COPIED: the verify pass then
    overwrites the cache in place. With ``out`` (a snapshot of the same
    shapes) the copy lands there and ``out`` is returned.
    """
    pos = cache["pos"]
    ring = "slot_pos" in cache
    snap = {}
    for name, buf in cache.items():
        if name == "pos":
            continue
        rows = as_bytes(buf)[_rows(pos, s, buf.shape[pos.dim()], ring)].view(buf.dtype)
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
    ring = "slot_pos" in cache
    for name, buf in cache.items():
        if name == "pos":
            continue
        idx = _rows(pos0, s, buf.shape[pos0.dim()], ring)
        mask = rejected.reshape(rejected.shape + (1,) * (buf.dim() - pos0.dim() - 1))
        raw = as_bytes(buf)
        raw[idx] = torch.where(mask, as_bytes(snap[name]), raw[idx])
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


def paged_phys_rows(bt: torch.Tensor, rows: torch.Tensor, page_size: int) -> torch.Tensor:
    """Logical rows -> flat physical rows through a block table.

    bt: (lead..., B, nb) page ids; rows: (lead..., B, s) logical positions.
    Rows past capacity (``>= nb * page_size``) map into the trash page
    (page 0) rather than clamping onto a live page. Returns int64."""
    nb = bt.shape[-1]
    rows = rows.to(torch.int64)
    blk = torch.clamp(rows // page_size, 0, nb - 1)
    phys = torch.gather(bt.to(torch.int64), -1, blk) * page_size + rows % page_size
    return torch.where(rows < nb * page_size, phys, rows % page_size)


def _flat(pool: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """(lead..., P, ps, rest...) -> a (lead..., P*ps, rest...) view."""
    return pool.view(pool.shape[:lead] + (-1,) + pool.shape[lead + 2:])


def paged_gather(pool: torch.Tensor, bt: torch.Tensor, page_size: int) -> torch.Tensor:
    """Dense per-slot copy of a page pool: (P, ps, rest...) -> (B, nb*ps,
    rest...). Rows a slot has written equal the dense cache's; unbacked rows
    read the trash page and lie above the slot's ``pos``."""
    b, nb = bt.shape
    idx = bt.to(torch.int64)[:, :, None] * page_size + torch.arange(page_size, device=bt.device)
    out = _flat(as_bytes(pool)).index_select(0, idx.reshape(-1)).view(pool.dtype)
    return out.view((b, nb * page_size) + pool.shape[2:])


def paged_update_rows(pool: torch.Tensor, new: torch.Tensor, phys: torch.Tensor) -> None:
    """In place, write ``new`` (B, s, rest...) at the flat physical rows
    ``phys`` (B, s) of ``pool`` (P, ps, rest...), cast to the pool's dtype.

    ``phys`` is :func:`paged_phys_rows` of the rows ``pos .. pos+s-1``: the
    reference's ``paged_update_rows(pool, new, bt, pos, ps)`` with the
    mapping taken out, so K and V share one. Writes whose block is unbacked
    (page 0 in the table) or past capacity land on the trash page."""
    b, s = new.shape[:2]
    _flat(as_bytes(pool)).index_copy_(0, phys.reshape(-1), as_bytes(
        new.reshape((b * s,) + new.shape[2:]).to(pool.dtype)))


def _paged_rows(cache: dict, bt: torch.Tensor, s: int, pos: torch.Tensor):
    """(layer index, flat physical rows) addressing, per layer, the ``s`` rows
    from ``pos`` (lead..., B) on of every pool leaf (lead..., P, ps, ...)."""
    rows = pos.to(torch.int64)[..., None] + torch.arange(s, device=pos.device)
    ps = next(buf for name, buf in cache.items() if name != "pos").shape[pos.dim()]
    phys = paged_phys_rows(bt.expand(pos.shape[:-1] + bt.shape), rows, ps)   # (lead..., B, s)
    lead = pos.shape[:-1]
    idx = [torch.arange(n, device=pos.device).reshape((n,) + (1,) * (len(lead) - i + 1))
           for i, n in enumerate(lead)]
    return tuple(idx) + (phys,)


def paged_rows_snapshot(cache: dict, bt: torch.Tensor, s: int, out: dict | None = None) -> dict:
    """Paged :func:`seq_rows_snapshot`: copy the ``s`` physical rows a verify
    extend will write through the block table ``bt`` (B, nb), and ``pos``.

    ``cache`` holds pool leaves (lead..., P, ps, rest...) and ``pos``
    (lead..., B). With ``out`` (a snapshot of the same shapes) the copy
    lands there and ``out`` is returned."""
    pos = cache["pos"]
    idx = _paged_rows(cache, bt, s, pos)
    snap = {}
    for name, buf in cache.items():
        if name == "pos":
            continue
        rows = _flat(as_bytes(buf), pos.dim() - 1)[idx].view(buf.dtype)
        snap[name] = rows if out is None else out[name].copy_(rows)
    snap["pos"] = pos.clone() if out is None else out["pos"].copy_(pos)
    return snap


def paged_rows_restore(cache: dict, snap: dict, bt: torch.Tensor, keep: torch.Tensor) -> dict:
    """Rewind a paged cache after a verify pass, in place: restore the
    rejected chunk rows (``keep[b]`` on) from the snapshot through the block
    table the verify pass wrote through, and rewind ``pos`` to ``pos0 +
    keep``. Pages the chunk spilled into stay mapped (the engine releases
    them at retire). Returns ``cache``."""
    pos0 = snap["pos"]
    name0 = next(n for n in snap if n != "pos")
    s = snap[name0].shape[pos0.dim()]
    keep = keep.to(pos0.device)
    idx = _paged_rows(cache, bt, s, pos0)
    rejected = torch.arange(s, device=pos0.device) >= keep.to(torch.int64)[:, None]  # (B, s)
    for name, buf in cache.items():
        if name == "pos":
            continue
        flat = _flat(as_bytes(buf), pos0.dim() - 1)
        mask = rejected.reshape(rejected.shape + (1,) * (buf.dim() - pos0.dim() - 1))
        flat[idx] = torch.where(mask, as_bytes(snap[name]), flat[idx])
    cache["pos"].copy_(pos0 + keep.to(pos0.dtype))
    return cache


def reset_slot_pos(cache: dict, slot: int, value: int) -> dict:
    """Set every per-slot ``pos`` entry of ``slot`` to ``value``, in place.

    Paged admission prefills straight into the resident grid, so a slot
    whose first ``value`` prompt tokens matched resident pages starts its
    suffix at ``pos = value`` (dense admission stages a fresh cache at 0)."""
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            reset_slot_pos(leaf, slot, value)
        elif name == "pos":
            leaf[..., slot].fill_(value)
    return cache
