"""Placement policies -- CASCADE column-parallel (paper-faithful) against
Megatron-style row+column tensor parallelism -- and the port's explicit
SPMD placement on ``torch.distributed`` (the reference's
``repro/distributed/sharding.py``).

The paper's central distribution claim (Sections 2.2, 13.5): CASCADE makes
the OUTPUT column the unit of parallelism, so every reduction stays on one
rank and no all-reduce of partial sums exists in the serving graph.

* ``cascade`` -- every weight is sharded on its output dim over ``model``,
  expert weights included (on their N); a linear computes this rank's
  output columns and all-gathers them. The embedding table is sharded on
  d, a tied one stays replicated (its head contracts over d).
* ``megatron`` -- the baseline: the row modules (``wo``, ``w_down``,
  ``w_out``, ``out_proj``) take a row band of their weight, multiply the
  matching feature band of their input and all-reduce the partial sums;
  experts are expert-parallel (E over ``model``); the embedding table is
  sharded on the vocabulary (tied or not), its lookup all-reduced and a
  tied head's vocabulary bands of logits all-gathered.

The spec functions return, for every leaf, the reference's
``PartitionSpec`` as a plain tuple of per-dim axis names (``None``:
replicated; a tuple of names: sharded over their product), padded with
``None`` to the leaf's rank; they read only ``.shape``/``.ndim`` (meta
tensors do).

Placement is explicit SPMD: every rank runs the same host program on the
same requests and holds exactly the local bands the specs give it
(:func:`shard_tree`); the model code runs on local tensors and calls the
collectives of ``distributed/collectives.py`` where a band must meet the
others. The installed :class:`ActivationPolicy` (the reference's
``set/get/clear_activation_policy``) tells the model code which leaves are
banded over ``model`` and on which dim. Its collective points stand where
the reference's ``constrain_*`` hooks pin activations:

* ``constrain_matmul_input`` (features replicated before a linear): here
  the linear that made a column band gathers it (:meth:`ActivationPolicy.
  gather_model`), or its consumer does, so every linear input that wants
  its features whole, every residual and every recurrence and norm input is
  whole on every rank of a model group;
* ``constrain_replicated`` (logits rows that feed sampling, the MoE
  dispatch, attention against a cache): logits rows are whole after the
  head's gather; the engine's data shards each sample their own rows from
  the full grid's noise and all-gather the tokens (``serve/engine.py``);
  the serving MoE dispatch is drop-free, so a token's expert rows depend on
  that token alone and a data shard dispatches its own rows;
* ``constrain_residual``: nothing to do, the residual is never banded.

Within a layer a band may stay unjoined where its consumer works on it:
the MLP's elementwise gate on its hidden columns, attention on the rank's
heads; it is joined before a linear that wants it whole, and handed as it
is to a row-banded one (megatron).

A mesh engine places its cache by the models' ``cache_pspecs`` (the slot
axis over ``data``, as the reference's engine does) and by
:func:`kv_head_bands`, the part of :func:`cache_specs` it places (the KV
heads over ``model`` where they divide; the reference's engine places no
model band at all); a rank then attends on its heads, whose q/k/v are its
columns of the projections, unjoined (``models/layers.attn_apply``). The
dry run (``launch/dryrun.py``) places the whole of :func:`cache_specs`, as
the reference's dry run does, and the decode step carries every band:

* a k/v cache's time band (where its heads do not divide the axis; the
  ring of a windowed config too): the rank whose band holds the new row
  writes it, every rank attends over its band and returns its (out,
  log-sum-exp), and the bands' partials are all-gathered and merged in
  rank order in f32 (:meth:`ActivationPolicy.join_time_bands`): the sum
  runs in another order than the unsharded attention's, so this path is
  held at a tolerance, not bit for bit;
* MLA's latent rows (``c_kv``, ``k_rope``): the same, in latent space;
* Mamba-2's ``state`` heads and ``conv`` channels, Griffin's ``h`` and
  ``conv`` channels: the rank steps its heads or channels and gathers what
  the next consumer needs whole; heads and channels are independent, so
  this path is bit-equal to the unsharded step.

The installed :class:`ActivationPolicy` says which dim of each cache leaf
is banded (:meth:`ActivationPolicy.cache_band`). Only ``decode_step`` runs
on a cache with a band other than the KV heads': extend (chunked prefill,
the speculative verify pass) and the paged cache raise ``ValueError``
there.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Optional

import torch

from repro_torch.distributed import collectives as C

# modules whose 2D weight contracts on dim 0 and expands on dim 1
_COLUMN_MODULES = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "wa", "wx", "in_proj",
    "wq_a", "wq_b", "wkv_a", "wkv_b", "lm_head",
}
# modules whose OUTPUT returns to d_model (Megatron shards these on dim 0)
_ROW_MODULES = {"wo", "w_down", "w_out", "out_proj"}
_EXPERT_MODULES = {"wg", "wu", "wd"}


def _pad(spec: tuple, ndim: int) -> tuple:
    return (None,) * (ndim - len(spec)) + tuple(spec)


def spec_for_param(path: tuple, leaf, policy: str, model_axis: str = "model",
                   tied_embed: bool = False) -> tuple:
    """The spec of one param leaf, by (module name, leaf name, ndim)."""
    leaf_name = path[-1] if path else ""
    module = path[-2] if len(path) >= 2 else ""
    ndim = leaf.ndim
    if module in _EXPERT_MODULES:
        # experts (.., E, K, N) / codes (.., E, K//2, N) / scale (.., E, G, N)
        if ndim >= 3:
            return _pad((model_axis, None, None) if policy == "megatron"
                        else (None, None, model_axis), ndim)
        return _pad((None,), ndim)
    if leaf_name == "table":                      # embedding (V, d)
        if policy == "megatron":
            return _pad((model_axis, None), ndim)
        if tied_embed:
            return _pad((None, None), ndim)
        return _pad((None, model_axis), ndim)
    if module == "router":
        return _pad((None, None), ndim)
    is_linear = module in _COLUMN_MODULES or module in _ROW_MODULES
    row = policy == "megatron" and module in _ROW_MODULES
    if is_linear and leaf_name in ("w", "codes"):
        return _pad((model_axis, None) if row else (None, model_axis), ndim)
    if is_linear and leaf_name == "scale":        # FP4 quant scales (G, N)
        return _pad((None, None) if row else (None, model_axis), ndim)
    if is_linear and leaf_name == "b":
        return _pad((None,) if row else (model_axis,), ndim)
    return (None,) * ndim


def _map_with_path(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map2(fn, a, b):
    """``fn`` over corresponding leaves of ``a`` (a tree of tensors or
    shapes) and ``b`` (a tree of spec tuples: a tuple is a leaf)."""
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [_map2(fn, v, w) for v, w in zip(a, b)]
    return fn(a, b)


def param_specs(params_tree: Any, policy: str = "cascade", model_axis: str = "model",
                tied_embed: bool = False):
    """The spec tree of ``params_tree``. ``tied_embed`` marks the models
    whose head is the embedding's transpose: their table stays replicated
    under cascade, so the tied head never contracts over a banded dim."""
    return _map_with_path(lambda p, leaf: spec_for_param(p, leaf, policy, model_axis,
                                                         tied_embed), params_tree)


def _axis_size(mesh, name) -> int:
    names = name if isinstance(name, tuple) else (name,)
    return math.prod(mesh.shape.get(a, 1) for a in names)


def filter_divisible(specs_tree: Any, shapes_tree: Any, mesh):
    """Drop mesh-axis names from the dims their axis size does not divide
    (such leaves stay replicated)."""
    def fix(leaf, spec):
        parts = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        return tuple(name if name is not None and leaf.shape[i] % _axis_size(mesh, name) == 0
                     else None for i, name in enumerate(parts))

    return _map2(fix, shapes_tree, specs_tree)


def _batch_axes(mesh, batch_axes) -> tuple:
    axes = tuple(a for a in batch_axes if mesh is None or a in mesh.shape)
    size = math.prod(mesh.shape[a] for a in axes) if mesh is not None else 1
    return axes, size


def batch_specs(batch_tree: Any, batch_axes=("pod", "data"), mesh=None):
    """The leading batch dim of every input over the data axes (the M-RoPE
    position stream's axis 1); replicated where the batch does not divide."""
    axes, size = _batch_axes(mesh, batch_axes)

    def spec(path, leaf):
        bdim = 1 if path and path[-1] == "positions" else 0          # (3, B, S)
        if leaf.shape[bdim] % max(size, 1) != 0:
            return (None,) * leaf.ndim
        out = [None] * leaf.ndim
        out[bdim] = axes if len(axes) > 1 else (axes[0] if axes else None)
        return tuple(out)

    return _map_with_path(spec, batch_tree)


def cache_specs(cache_tree: Any, mesh, model_axis: str = "model", batch_axes=("pod", "data")):
    """The reference's KV/state cache spec: batch over the data axes; heads
    (or a head-like dim) over ``model`` where divisible, else the cache's
    time dim (k/v). Layouts: attn k/v (L, B, T, Hkv, hd); MLA c_kv (L, B,
    T, lora); ssm state (L, B, H, P, N); conv (L, B, w-1, dim). The port's
    caches stack every dict of leaves (``models/cache_utils.py``)."""
    model_size = mesh.shape.get(model_axis, 1)
    axes, data_size = _batch_axes(mesh, batch_axes)
    baxis = axes if len(axes) > 1 else (axes[0] if axes else None)

    def spec(path, leaf):
        leaf_name = path[-1]
        # every leaf of a dict of stacked leaves is (L, B, ...) ("layers",
        # Griffin's "attn"); a per-slot leaf beside them is (B, ...)
        stacked = len(path) > 1 and not path[0].isdigit()
        if leaf.ndim == 0 or leaf_name in ("pos", "slot_pos"):
            return (None,) * leaf.ndim
        bdim = 1 if stacked else 0
        out = [None] * leaf.ndim
        if leaf.shape[bdim] % max(data_size, 1) == 0 and data_size > 1:
            out[bdim] = baxis
        if leaf_name in ("k", "v"):
            hdim, tdim = leaf.ndim - 2, leaf.ndim - 3
            if leaf.shape[hdim] % model_size == 0:
                out[hdim] = model_axis
            elif leaf.shape[tdim] % model_size == 0:
                out[tdim] = model_axis
        elif leaf_name in ("c_kv", "k_rope") and leaf.shape[-2] % model_size == 0:
            out[-2] = model_axis
        elif leaf_name == "state" and leaf.ndim >= bdim + 4:
            if leaf.shape[bdim + 1] % model_size == 0:
                out[bdim + 1] = model_axis
        elif leaf_name in ("conv", "h"):
            if leaf.shape[-1] % model_size == 0:
                out[-1] = model_axis
        return tuple(out)

    return _map_with_path(spec, cache_tree)


def kv_head_bands(cache_tree, mesh, model_axis: str = "model"):
    """The model bands of :func:`cache_specs` that a mesh engine places:
    its head band of every k/v leaf (the last dim but one). The engine
    drops the rest of that spec (a k/v cache's T band, MLA's latent rows,
    Mamba-2's and Griffin's state, conv and ``h`` bands, which the decode
    step carries under the dry run's placement): its extend and paged
    paths run on whole leaves, and the reference's engine places no model
    band at all."""
    whole = cache_specs(cache_tree, mesh, model_axis, batch_axes=())
    placed = mesh.shape.get(model_axis, 1) > 1

    def keep(path, leaf):
        spec = _spec_at(whole, path)
        head = leaf.ndim - 2
        return tuple(name if placed and i == head and path[-1] in ("k", "v") else None
                     for i, name in enumerate(spec))

    return _map_with_path(keep, cache_tree)


def _spec_at(specs, path: tuple) -> tuple:
    for step in path:
        specs = specs[int(step)] if isinstance(specs, list) else specs[step]
    return specs


def merge_specs(a, b):
    """Two spec trees of one tree, each dim taking the axis either names."""
    return _map2(lambda x, y: tuple(p if p is not None else q for p, q in zip(x, y)), a, b)


def add_data_dim(specs_tree, shapes_tree, mesh, batch_axes=("pod", "data"), first: Any = None):
    """ZeRO-style: also shard each leaf over the data axes on its first
    unsharded, divisible dim (optimizer moments; FSDP params). ``first``, a
    tree of ints beside the specs, makes a leaf look from that dim on
    before it looks at the dims in front of it (:func:`data_band_specs`)."""
    axes, size = _batch_axes(mesh, batch_axes)
    daxis = axes if len(axes) > 1 else (axes[0] if axes else None)

    def upd(leaf, spec, start=0):
        if size <= 1 or leaf.ndim == 0:
            return spec
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        for i in list(range(start, leaf.ndim)) + list(range(start)):
            if parts[i] is None and leaf.shape[i] % size == 0:
                parts[i] = daxis
                return tuple(parts)
        return spec

    if first is None:
        return _map2(upd, shapes_tree, specs_tree)
    return _map2(lambda leaf, sf: upd(leaf, *sf), shapes_tree,
                 _map2(lambda sp, f: (sp, f), specs_tree, first))


def data_band_specs(specs_tree, params_tree, mesh, batch_axes=("pod", "data")):
    """The ZeRO-1 moments' and FSDP params' specs: :func:`add_data_dim` of
    the placed param specs, but a leaf of a stacked ``layers`` dict keeps
    its layer dim whole, so that every layer of the stack is a band of each
    rank's and the FSDP forward gathers one layer at a time
    (:meth:`ActivationPolicy.gather_layer`). Such a leaf takes the data
    axes on its first other dim that is free and divides them; else on a
    dim banded over ``model`` that divides both (the name ``("model",
    *data axes)``: the data band within the model band, e.g. a stacked
    bias (L, N)) where the reference bands its layer dim; else on the
    layer dim, as the reference. Its bytes a rank are the reference's
    ``add_data_dim``'s in each case."""
    axes, size = _batch_axes(mesh, batch_axes)
    daxis = axes if len(axes) > 1 else (axes[0] if axes else None)
    stacked = isinstance(params_tree, dict) and isinstance(params_tree.get("layers"), dict)

    def band(path, leaf, spec):
        if not (stacked and path[:1] == ("layers",) and leaf.ndim > 1) or size <= 1:
            return add_data_dim(spec, leaf, mesh, batch_axes)
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        for i in range(1, leaf.ndim):
            if parts[i] is None and leaf.shape[i] % size == 0:
                parts[i] = daxis
                return tuple(parts)
        if parts[0] is not None or leaf.shape[0] % size:
            return tuple(parts)                  # the reference bands it nowhere either
        for i in range(1, leaf.ndim):
            if parts[i] is not None and leaf.shape[i] % (_axis_size(mesh, parts[i]) * size) == 0:
                parts[i] = _axis_names(parts[i]) + axes
                return tuple(parts)
        return add_data_dim(spec, leaf, mesh, batch_axes)

    return _map_with_path(lambda path, leaf: band(path, leaf, _spec_at(specs_tree, path)),
                          params_tree)


# ---------------------------------------------------------------------------
# explicit SPMD placement
# ---------------------------------------------------------------------------

def _band_index(mesh, name) -> tuple:
    """(index, count) of this rank's band over axis ``name`` (or a tuple of
    axes, row-major over them)."""
    names = name if isinstance(name, tuple) else (name,)
    idx, count = 0, 1
    for a in names:
        idx = idx * mesh.size(a) + mesh.coord(a)
        count *= mesh.size(a)
    return idx, count


def local_band(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, in storage of its own (a
    contiguous copy: the kernels read packed rows by their pitch). A leaf
    replicated on every dim is returned as it is."""
    out = t
    for dim, name in enumerate(spec):
        if name is None:
            continue
        idx, count = _band_index(mesh, name)
        w = t.shape[dim] // count
        out = out.narrow(dim, idx * w, w)
    if out is t:
        return t
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's local bands of every leaf of ``tree`` under ``specs``,
    leaf by leaf (the full leaf can be freed as soon as its band is cut)."""
    return _map2(lambda t, s: local_band(t, s, mesh), tree, specs)


def placed_param_specs(params_tree: Any, mesh, policy: str = "cascade",
                       tied_embed: bool = False):
    """The specs a mesh engine places a param tree by:
    ``filter_divisible(param_specs(...))`` on its whole shapes (a tree of
    meta tensors will do)."""
    return filter_divisible(param_specs(params_tree, policy, tied_embed=tied_embed),
                            params_tree, mesh)


def param_placer(mesh, policy: str = "cascade", tied_embed: bool = False):
    """The ``place`` of a model's ``init_params``: a fragment of the param
    tree (a layer's dict, or ``{"embed": ...}``), cut to this rank's bands
    as soon as it is drawn. Its leaves' specs are the ones they take in the
    whole tree: a spec reads the leaf's module, its name and its trailing
    dims, and the layer dim a stacked leaf adds in front is never banded."""
    return lambda fragment: shard_tree(
        fragment, placed_param_specs(fragment, mesh, policy, tied_embed), mesh)


def gather_band(t: torch.Tensor, spec: tuple, mesh, sum_grads: bool = False) -> torch.Tensor:
    """The inverse of :func:`local_band`: the whole leaf, all-gathered over
    every axis that bands it (innermost axis first). ``sum_grads``: the
    ranks use the whole leaf on rows of their own (full data parallelism),
    so under autograd its gradient is summed over them onto the band."""
    for dim in reversed(range(len(spec))):
        name = spec[dim]
        if name is None:
            continue
        for a in reversed(name if isinstance(name, tuple) else (name,)):
            if mesh.size(a) > 1:
                t = C.all_gather(t, mesh.group(a), dim=dim, sum_grads=sum_grads)
    return t


def gather_tree(tree: Any, specs: Any, mesh, sum_grads: bool = False) -> Any:
    """Every leaf whole again on every rank (checkpoints, failover; a full
    data-parallel step's params, ``sum_grads``)."""
    return _map2(lambda t, s: gather_band(t, s, mesh, sum_grads), tree, specs)


# ---------------------------------------------------------------------------
# the activation policy: what the model code reads while a mesh step runs
# ---------------------------------------------------------------------------

class ActivationPolicy:
    """The installed placement of one mesh engine (or trainer, or dry-run
    step): the policy name (the tp policy: ``cascade`` or ``megatron``),
    the mesh, and for each local param leaf banded
    over ``model`` the banded dim, counted from the end (a layer's view of
    a stacked leaf, or an expert stack's, keeps its trailing dims). Leaves
    are found by their storage, which every view of a leaf shares (fake
    tensors too). ``moe_ep`` sends the MoE layers to the expert-parallel
    dispatch (``models/moe_shardmap.py``), as the reference's ``moe_ep``
    flag does. ``cache_bands`` is the spec tree of the model bands placed
    on the cache (a mesh engine's :func:`kv_head_bands`, the dry run's
    whole :func:`cache_specs`): :meth:`cache_band` says, by leaf name, on
    which dim a layer's cache leaf holds this rank's band, whose offset on
    that dim is ``model_rank`` times the local extent.

    ``act`` is the activation placement (the reference's ``--act-policy``):

    * ``cascade`` (and ``none``): the residual stream whole on every model
      rank, the rank's rows of the batch only. The reference's ``none``
      leaves GSPMD to propagate; in explicit SPMD nothing is left to
      propagate (each param band forces its own collectives), so ``none``
      runs the tp policy's own route with no pin, as the reference's
      engine pairs megatron with ``none``;
    * ``seqpar`` (sequence parallelism, the reference's
      ``constrain_residual`` with its ``seq`` axis): between blocks a
      (B, S, d) residual whose S divides 16 and the model axis holds this
      rank's S/m rows (:meth:`seq_rows`); the norms run on them; the rows
      are all-gathered before each mixer and MLP, which run the tp policy's
      route on the whole sequence (attention over every query row, as the
      cascade cell runs it); the block's output linear returns to the
      rank's rows inside :func:`rows_out` (a column band by an all-to-all,
      a row band's partial sums by a reduce-scatter). Decode (S = 1) keeps
      the batch placement, as the reference falls back. The MoE expert
      buffer goes E over ``model`` (``constrain_expert_buffer``): a
      column-banded expert stack is re-banded by experts with one
      all-to-all a leaf (``core.cascade``);
    * ``fulldp`` (pure data parallelism, the reference's batch over every
      axis): a train step's batch is placed over every axis already (the
      dry run's train cells gather the params whole). In the serving modes
      (``prefill``, ``decode``) the batch comes placed over the data axes,
      as the reference's serving in_specs leave it, and between blocks each
      rank holds its share of its data group's rows over ``model``
      (:meth:`holds_rows`: dim 0, padded to a multiple of the axis where it
      does not divide, as GSPMD pads an uneven shard). The params keep their
      tp bands: the rows are gathered before each mixer and MLP, which run
      the tp policy's route on the data group's rows (the cache read and
      written where the plain cell reads and writes it), and the block's
      output linear returns the rank's rows inside :func:`rows_out`, as
      under ``seqpar``. The expert buffer and the logits rows are whole, as
      the reference replicates them.

    ``data_specs`` (ZeRO-3/FSDP) is the spec tree of the local params'
    data bands (:func:`data_band_specs`): :meth:`gather_layer` gathers a
    layer's leaves over the data axes where the model code reads them, and
    ``whole`` (full data parallelism) their model bands too."""

    def __init__(self, mesh, policy: str, local_params: Any = None, specs: Any = None,
                 model_axis: str = "model", moe_ep: bool = False, cache_bands: Any = None,
                 act: str = "cascade", data_specs: Any = None,
                 data_axes: tuple = ("pod", "data"), whole: bool = False):
        self.mesh = mesh
        self.policy = policy
        self.act = act
        self.moe_ep = moe_ep
        self.model_axis = model_axis
        self.model_size = mesh.size(model_axis)
        self.model_rank = mesh.coord(model_axis)
        self.data_axes = tuple(a for a in data_axes if a in mesh.shape)
        self.whole = whole
        self._rows = 0                   # the row count of the rows whole (``pad_rows``)
        self._bands: dict = {}
        self._model_bands: dict = {}
        self._data_bands: dict = {}
        self._cache_bands: dict = {}
        if local_params is not None:
            def note(t, spec, dspec=None):
                for dim, name in enumerate(spec):
                    if model_axis in _axis_names(name) and self.model_size > 1:
                        self._model_bands[_storage_key(t)] = dim - t.ndim
                for dim, name in enumerate(dspec or ()):
                    daxes = tuple(a for a in _axis_names(name) if a in self.data_axes) \
                        if name is not None else ()
                    if daxes:
                        self._data_bands[_storage_key(t)] = (dim - t.ndim, daxes)
                return t
            if data_specs is None:
                _map2(note, local_params, specs)
            else:
                _map2(lambda t, sd: note(t, *sd), local_params,
                      _map2(lambda a, b: (a, b), specs, data_specs))
            if not whole:
                self._bands = dict(self._model_bands)
        if self.model_size == 1:
            return
        for path, spec in _spec_leaves(cache_bands):
            for dim, name in enumerate(spec):
                if model_axis in _axis_names(name):
                    d = dim - len(spec)
                    if self._cache_bands.setdefault(path[-1], d) != d:
                        raise ValueError(f"cache leaves named {path[-1]!r} are banded on "
                                         f"two dims")

    # ---- rows between blocks: sequence parallelism and serving fulldp
    def seq_rows(self, s: int) -> bool:
        """Whether a residual of ``s`` rows is held as this rank's S/m rows
        between blocks (``seqpar``; the reference's ``S % 16`` rule)."""
        return (self.act == "seqpar" and self.model_size > 1 and s % 16 == 0
                and s % self.model_size == 0)

    def holds_rows(self, x: torch.Tensor, mode: str) -> bool:
        """Whether a layer loop in ``mode`` over the (B, S, d) embeddings
        ``x`` holds this rank's rows of them between blocks: ``seqpar``'s
        rows of the sequence in the whole-sequence modes, ``fulldp``'s rows
        of the batch in the serving modes."""
        if self.act == "fulldp":
            return self.model_size > 1 and mode in ("prefill", "decode")
        return mode in ("full", "prefill") and self.seq_rows(x.shape[1])

    @property
    def rows_dim(self) -> int:
        """The dim of a (B, S, ...) activation whose rows a rank holds:
        the batch's under ``fulldp``, else the sequence's."""
        return 0 if self.act == "fulldp" else 1

    def pad_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (its rows whole) with its row count noted, padded with
        zero rows to a multiple of the model axis (a no-op where it divides)."""
        d, m = self.rows_dim, self.model_size
        self._rows = x.shape[d]
        if self._rows % m == 0:
            return x
        pad = [0, 0] * (x.ndim - 1 - d) + [0, -self._rows % m]
        return torch.nn.functional.pad(x, pad)

    def take_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an activation whole on every model rank."""
        return C.split(self.pad_rows(x), self.mesh.group(self.model_axis), self.rows_dim)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every model rank's rows of ``x``, in rank order, without the pad."""
        y = self.gather_model(x, self.rows_dim)
        return y if y.shape[self.rows_dim] == self._rows else y.narrow(self.rows_dim, 0,
                                                                        self._rows)

    # ---- ZeRO-3 / FSDP
    def data_band(self, t: torch.Tensor):
        """(dim from the end, data axes) of local leaf ``t``'s data band, or None."""
        return self._data_bands.get(_storage_key(t))

    def gather_layer(self, tree: Any) -> Any:
        """``tree`` (a layer's params, or the params outside the layers) with
        every data-banded leaf all-gathered over the data axes (and, under
        ``whole``, every model band over ``model``). Under autograd each
        gather's backward reduce-scatters the gradient back onto the band.
        A gathered leaf keeps its model band's entry, so the model code
        runs it on its band."""
        if not self._data_bands and not self.whole:
            return tree

        def gather(t):
            if not isinstance(t, torch.Tensor):
                return t
            key = _storage_key(t)
            db, mb = self._data_bands.get(key), self._model_bands.get(key)
            out = t
            if db is not None:
                for a in reversed(db[1]):
                    if self.mesh.size(a) > 1:
                        out = C.all_gather(out, self.mesh.group(a), dim=db[0], sum_grads=True,
                                           grad_op="reduce_scatter")
            if self.whole and mb is not None:
                out = C.all_gather(out, self.mesh.group(self.model_axis), dim=mb,
                                   sum_grads=True, grad_op="reduce_scatter")
            elif mb is not None and out is not t:
                self._note_band(out, mb)
            return out

        return _map_tree(gather, tree)

    def _note_band(self, t: torch.Tensor, dim: int) -> None:
        """Register a gathered leaf's model band until its storage is freed."""
        key = _storage_key(t)
        self._bands[key] = dim
        weakref.finalize(t.untyped_storage(), self._bands.pop, key, None)

    def cache_band(self, name: str) -> Optional[int]:
        """The dim (negative, from the end) on which a cache leaf named
        ``name`` ("k", "c_kv", "state", ...) holds this rank's band over
        ``model``; None where it is whole."""
        return self._cache_bands.get(name)

    def join_time_bands(self, o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """Attention over the whole of a cache's time axis from every model
        rank's partial over its band: ``o`` (..., D) this band's output,
        ``lse`` (...) its log-sum-exp (-inf: no live key in the band). The
        partials are all-gathered in one call and merged in rank order
        (:func:`merge_time_bands`)."""
        packed = torch.cat([o.to(torch.float32), lse.to(torch.float32)[..., None]], dim=-1)
        return merge_time_bands(self.gather_model(packed[None], 0))

    def band(self, t: Optional[torch.Tensor]) -> Optional[int]:
        """The dim (negative, from the end) on which local leaf ``t`` (or a
        view of it) is banded over ``model``; None where it is whole."""
        if t is None or not self._bands:
            return None
        return self._bands.get(_storage_key(t))

    def gather_model(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's band of ``y``, concatenated along ``dim``."""
        return C.all_gather(y, self.mesh.group(self.model_axis), dim=dim)

    def sum_model(self, y: torch.Tensor) -> torch.Tensor:
        """The SUM of ``y`` over the model ranks (a partial-sum all-reduce)."""
        return C.all_reduce(y, self.mesh.group(self.model_axis), "sum")

    def band_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, whole on every model rank, as the input of this rank's band
        of work: under autograd its gradient (this rank's partial) is
        summed over the model ranks (``collectives.sum_grads``)."""
        return C.sum_grads(x, self.mesh.group(self.model_axis))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def holds_rows(x: torch.Tensor, mode: str) -> bool:
    """Whether the installed policy holds this rank's rows of a layer loop's
    residual between blocks (``ActivationPolicy.holds_rows``)."""
    return _ACT_POLICY is not None and _ACT_POLICY.holds_rows(x, mode)


def gather_layer(tree: Any) -> Any:
    """A layer's params as the model code reads them under the installed
    policy (``ActivationPolicy.gather_layer``); ``tree`` itself without one."""
    return tree if _ACT_POLICY is None else _ACT_POLICY.gather_layer(tree)


_ROWS_OUT = False


def rows_out_active() -> bool:
    """Inside :func:`rows_out`: a block's output linear returns this rank's rows."""
    return _ROWS_OUT


@contextlib.contextmanager
def rows_out(on: bool = True):
    """While on, a block's output linear (``cascade.out_apply``) hands back
    this rank's rows of its (B, S, N) output (``seqpar``, serving
    ``fulldp``). The block sets it inside its own body, so a rematerialized
    block sets it again when it is recomputed."""
    global _ROWS_OUT
    prev, _ROWS_OUT = _ROWS_OUT, bool(on)
    try:
        yield
    finally:
        _ROWS_OUT = prev


def merge_time_bands(parts: torch.Tensor) -> torch.Tensor:
    """Merge the bands' attention partials ``parts`` (m, ..., D + 1): each
    band's output and, last, its log-sum-exp. In rank order, in f32: ``m =
    max_r lse_r``, then ``o = sum_r e^(lse_r - m) o_r / sum_r e^(lse_r -
    m)``. A band with no live key (lse -inf) weighs 0; a row needs one live
    key somewhere (a decode step's own token always is)."""
    lse = parts[..., -1].to(torch.float32)
    mx = lse.amax(dim=0)
    w = torch.exp(lse - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
    num, den = parts[0, ..., :-1] * w[0, ..., None], w[0]
    for r in range(1, parts.shape[0]):
        num = num + parts[r, ..., :-1] * w[r, ..., None]
        den = den + w[r]
    return num / den[..., None]


def _axis_names(name) -> tuple:
    return name if isinstance(name, tuple) else (name,)


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by its views: the storage's
    own handle (a fake or meta tensor's storages have no data pointers)."""
    return t.untyped_storage()._cdata


def _spec_leaves(specs: Any, path: tuple = ()):
    """(path, spec) of every leaf of a spec tree (a spec is a tuple)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_leaves(v, path + (str(k),))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_leaves(v, path + (str(i),))
    elif specs is not None:
        yield path, specs


_ACT_POLICY: Optional[ActivationPolicy] = None


def set_activation_policy(policy: Optional[ActivationPolicy]) -> None:
    global _ACT_POLICY
    _ACT_POLICY = policy


def get_activation_policy() -> Optional[ActivationPolicy]:
    return _ACT_POLICY


def clear_activation_policy() -> None:
    set_activation_policy(None)


@contextlib.contextmanager
def activation_policy(policy: Optional[ActivationPolicy]):
    """Install ``policy`` for the calls inside, and put back the one before
    (an unsharded engine in the same process, a failover survivor, runs
    with none)."""
    prev = _ACT_POLICY
    set_activation_policy(policy)
    try:
        yield policy
    finally:
        set_activation_policy(prev)
