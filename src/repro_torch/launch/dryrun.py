"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
of one rank of the production meshes, with no device and no memory (the
reference's ``repro/launch/dryrun.py``).

The reference compiles each cell for 256 or 512 virtual XLA devices and
reads XLA's cost and memory analyses. The port's counterpart runs the real
step code of ONE rank, rank 0, in a world of 256 or 512 ranks that PyTorch's
``fake`` process-group backend makes (its collectives move nothing), under
``FakeTensorMode``: every tensor is a fake CPU tensor with a shape, a dtype
and a storage size, and nothing is allocated or computed. It is a
device-free tool by design, as the reference's is; it is not a fallback
from the card. Rank 0's program is the per-device record, as the
reference's SPMD compile is. A PyTorch without the fake backend makes the
run fail and say so; no smaller world stands in for it.

For each cell this shows that the placement is coherent (the step runs on
its bands), and records (``run_cell``) the reference's keys:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the step (matrix products and attention, forward, backward and
  rematerialization). Every op the step runs is counted as often as it
  runs; the reference's XLA count counts a while-loop body once
  (``repro/analysis/hlo.py``), so this is its loop-corrected count;
* ``bytes_accessed_per_device``: each op's operand bytes plus its output
  bytes, views excluded, unfused: an upper count, not XLA's fused one;
* ``memory``: ``argument_bytes``, the rank's local params, optimizer
  state, batch and cache, summed leaf by leaf (an exact integer);
  ``output_bytes``, the step's outputs that are not arguments;
  ``temp_bytes``, the peak of the live storages beyond the arguments during
  the step (a tally of the fake storages, each counted until it is freed);
  ``peak_bytes`` = argument + temp, as in the reference;
* ``collectives``: the reference's five kinds, each with ``count`` and
  ``bytes``, and ``total_bytes``, from the port's counted collectives
  (``distributed/collectives.py``): all-gather, all-reduce (SUM and MAX),
  reduce-scatter and all-to-all; the port makes no collective-permute, so
  that one is zero. ``bytes`` are the bytes each rank sends into the calls
  (the reference counts each op's output: an all-gather's is the group's
  size times larger);
* ``trace_s`` (the reference's ``compile_s``): the wall seconds of drawing
  the rank's tensors and tracing its step.

A cell places its params by ``sharding.placed_param_specs`` (the
``param_specs`` of ``--tp-policy``, replicated on the dims the axis does
not divide: the reference's jit refuses such arguments, e.g. mamba2-370m's
50,280-row table under megatron), its batch by ``batch_specs`` and its
decode cache by the WHOLE of ``cache_specs`` (KV heads, else the time
axis, MLA's latent rows, the recurrent state and conv window over
``model``); the decode step carries those bands (``distributed/
sharding.py``). ``pos`` and a ring's ``slot_pos`` are replicated there,
and the rank steps its data shard's rows of them. The prefill cell places
its output cache by the model bands of ``cache_specs`` (its rows are the
rank's already). Cells run the reference's default ``CascadeConfig``:
``serve_fp4`` (``train`` for train cells), ``use_kernel=False``, the
dequantize-and-multiply route the reference lowers. Train cells run
``train/loop.make_train_step`` with remat and AdamW, the gradients averaged
over the data shards (one counted all-reduce a leaf and data axis), and
the clip's global norm that of the whole gradients: the banded leaves'
sum of squares all-reduced over ``model`` (one counted all-reduce).

Policies (the reference's flags; ``sharding.ActivationPolicy`` has each
activation placement):

* ``--act-policy cascade`` (the batch over ``pod``/``data``), ``none``
  (in explicit SPMD the tp policy's own route with no pin: the same
  program as cascade) and ``seqpar`` (sequence parallelism between blocks
  on prefill and train cells, whose S divides 16; decode keeps the batch
  placement; the MoE expert buffer E over ``model``);
* for train cells, full data parallelism (the batch over every axis, as
  the reference's ``full_dp`` places a train cell's; ``--act-policy
  fulldp`` and ``--full-dp`` each ask for it and imply the other). Every
  rank holds rows of its own, so the step gathers the model-banded params
  whole once, at its start (``WholeParams``; their gradients summed back
  onto the bands), or, with ``--dp-shard fsdp``, a layer at a time inside
  its remat region (ZeRO-3 over every axis). On a serving cell the
  reference's ``full_dp`` changes no spec, so ``--full-dp`` alone traces
  the plain cell (the record says ``full_dp: true``). ``--act-policy
  fulldp`` there keeps the plain cell's arguments (the params on their tp
  bands, the batch over ``pod``/``data``, the cache by ``cache_specs``: the
  reference's in_specs do not change) and places the activations as the
  reference's ``constrain_residual`` and ``constrain_matmul_input`` pin
  them: between blocks each rank holds its share of its data group's rows
  over ``model`` (padded where the axis does not divide them), and the
  params keep their bands: the rows are gathered before each mixer and MLP,
  which run the cascade cell's route (attention against a time, latent or
  state band of the cache as that cell runs it), and the block's output
  linear returns the rank's rows (``sharding.ActivationPolicy``, ``act =
  "fulldp"``). Gathering the weights whole instead would move every param
  each step; gathering the rows moves a layer's activations;
* ``--dp-shard zero1`` (the moments' data bands) and ``fsdp`` (the
  params' too) on train cells (``train.loop.MeshGrads``); serving cells
  ignore it, as the reference's in_specs do;
* ``moe_ep=True`` (``run_cell``): the MoE layers through the
  expert-parallel dispatch (``models/moe_shardmap.py``), a column-banded
  expert stack re-banded by experts first; ``microbatches`` as the
  reference's ``make_train_step``.

A cell that raises is a FAILED record in a sweep.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out DIR/x.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as T
from repro_torch.configs import base as cfgbase
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import cache_utils, registry
from repro_torch.optim.adamw import AdamW
from repro_torch.train import loop as train_loop

#: the reference's collective kinds (``dryrun.collective_stats``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
ACT_POLICIES = ("none", "cascade", "seqpar", "fulldp")
DP_SHARDS = ("none", "zero1", "fsdp")


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank 0,
    torn down on the way out whatever happens inside."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"this PyTorch ({torch.__version__}) has no fake process-group "
                           "backend: the dry run needs one and runs no smaller world") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the dry run makes its own")
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def check_policies(act_policy: str, dp_shard: str, full_dp: bool) -> tuple:
    """A train cell's ``(act_policy, full_dp)``, full data parallelism asked
    by either (``fulldp`` and ``--full-dp`` imply each other);
    ``ValueError`` for an unknown name."""
    if act_policy not in ACT_POLICIES:
        raise ValueError(f"unknown --act-policy {act_policy!r}")
    if dp_shard not in DP_SHARDS:
        raise ValueError(f"unknown --dp-shard {dp_shard!r}")
    full_dp = bool(full_dp) or act_policy == "fulldp"
    return ("fulldp" if full_dp else act_policy), full_dp


def cell_policies(kind: str, act_policy: str, dp_shard: str, full_dp: bool) -> tuple:
    """``(act_policy, full_dp)`` of a cell of step ``kind``: a train cell's
    by :func:`check_policies`; a serving cell's as given, ``--full-dp``
    changing no spec there (the reference's serving in_specs take their
    default axes), ``--act-policy fulldp`` implying ``full_dp``."""
    if kind == "train":
        return check_policies(act_policy, dp_shard, full_dp)
    check_policies(act_policy, dp_shard, False)
    return act_policy, bool(full_dp) or act_policy == "fulldp"


# ---------------------------------------------------------------------------
# a cell: its step and its rank's arguments
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One rank's step of a cell. ``trees`` maps each argument group
    ("params", "batch", "cache" or "opt") to its whole tree of meta tensors
    and its spec tree; ``step(args)`` runs the step on the rank's local
    trees (``local_args``) and returns its outputs."""
    shape: cfgbase.ShapeConfig
    mesh: Any
    tp_policy: str
    batch_axes: tuple
    trees: dict
    step: Callable[[dict], Any]
    act_policy: str = "cascade"
    dp_shard: str = "none"
    moe_ep: bool = False
    data_specs: Any = None          # zero1/fsdp: the params' data bands (moments; fsdp params)

    def local_args(self, make: Callable) -> dict:
        """The rank's bands of every argument tree, each leaf made by
        ``make(shape, dtype)`` (``torch.empty`` under ``FakeTensorMode``).
        Train cells get ``requires_grad`` params, their optimizer state and
        the train state's step, as the reference's ``TrainState``."""
        out = {name: sharding._map2(lambda t, s: make(local_shape(t.shape, s, self.mesh),
                                                      t.dtype), tree, specs)
               for name, (tree, specs) in self.trees.items()}
        if self.shape.kind == "train":
            for p in T.leaves(out["params"]):
                p.requires_grad_(True)
            out["opt"] = AdamW().init(out["params"])
            if self.data_specs is not None:        # the moments' data bands
                moments = lambda: sharding._map2(
                    lambda t, s: make(local_shape(t.shape, s, self.mesh), torch.float32),
                    self.trees["params"][0], self.data_specs)
                out["opt"] = out["opt"]._replace(mu=moments(), nu=moments())
            out["step"] = make((), torch.int32)
        return out

    def policy(self, args: dict) -> sharding.ActivationPolicy:
        """The activation policy of the rank's step: its param bands (none
        under full data parallelism, whose step runs on the params
        gathered whole, but with FSDP, whose layers gather them), their
        data bands under FSDP, and the decode cache's model bands."""
        fsdp = self.dp_shard == "fsdp" and self.shape.kind == "train"
        kw = dict(act=self.act_policy, moe_ep=self.moe_ep)
        if "model" in self.batch_axes and not fsdp:
            return sharding.ActivationPolicy(self.mesh, self.tp_policy, **kw)
        return sharding.ActivationPolicy(
            self.mesh, self.tp_policy, args["params"], self.model_specs,
            cache_bands=self.trees["cache"][1] if "cache" in self.trees else None,
            data_specs=self.data_specs if fsdp else None, whole="model" in self.batch_axes,
            **kw)

    @property
    def model_specs(self):
        """The params' model bands (their placed specs without the data bands)."""
        return _without_axes(self.trees["params"][1], ("pod", "data"))


class WholeParams:
    """``model`` under full data parallelism: ``forward`` takes the rank's
    bands of the params and runs on them all-gathered whole over the mesh
    (every rank holds rows of its own), the gathers' gradients summed over
    the ranks onto the bands."""

    def __init__(self, model, specs, mesh):
        self.model, self.specs, self.mesh = model, specs, mesh

    def forward(self, params, batch, ccfg, **kw):
        whole = sharding.gather_tree(params, self.specs, self.mesh, sum_grads=True)
        return self.model.forward(whole, batch, ccfg, **kw)


class FsdpParams:
    """``model`` under ``--dp-shard fsdp``: ``forward`` takes the rank's data
    (and model) bands of the params; the leaves outside the layers are
    gathered at its start, each layer's inside its remat region
    (``models.remat.layer_fn``), by the installed policy's
    ``gather_layer``: the whole params are never live at once."""

    LAYERS = ("layers", "dense_layers")

    def __init__(self, model):
        self.model = model

    def forward(self, params, batch, ccfg, **kw):
        rest = sharding.gather_layer({k: v for k, v in params.items() if k not in self.LAYERS})
        return self.model.forward(dict(params, **rest), batch, ccfg, **kw)


def local_shape(shape, spec, mesh) -> tuple:
    """A leaf's shape on one rank under ``spec``."""
    return tuple(d // sharding._axis_size(mesh, name) if name is not None else d
                 for d, name in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def _without_axes(specs, axes: tuple):
    """``specs`` with the names of ``axes`` dropped (a tuple of names keeps
    the rest)."""
    def drop(spec):
        out = []
        for name in spec:
            names = tuple(n for n in sharding._axis_names(name) if n not in axes) \
                if name is not None else ()
            out.append(None if not names else (names[0] if len(names) == 1 else names))
        return tuple(out)
    return _map_specs(drop, specs)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _data_rows(mesh, axes: tuple, global_b: int) -> tuple:
    """(first row, rows) of this rank's data shard of a ``global_b`` batch
    over ``axes`` (all of them when they do not divide it)."""
    idx, count = sharding._band_index(mesh, tuple(a for a in axes if a in mesh.shape))
    if count <= 1 or global_b % count:
        return 0, global_b
    return idx * (global_b // count), global_b // count


def rank_cache_view(cache: dict, specs: dict, batch_axes: tuple, b0: int, nb: int) -> dict:
    """The cache as the rank's step reads it: every leaf whose slot axis
    ``cache_specs`` leaves replicated over the data axes (``pos``, a ring's
    ``slot_pos``) narrowed to the rank's rows ``[b0, b0 + nb)`` (a view: the
    step's in-place writes land in the replicated leaf)."""
    out: dict = {}
    for path, buf, ax in cache_utils._leaves(cache):
        spec = cache_utils._get(specs, path)
        sharded = spec[ax] is not None and any(a in sharding._axis_names(spec[ax])
                                               for a in batch_axes)
        view = buf if sharded or buf.shape[ax] == nb else buf.narrow(ax, b0, nb)
        parent = out.setdefault(path[0], {}) if len(path) == 2 else out
        parent[path[-1]] = view
    return out


def build_cell(arch: str, shape, mesh, ccfg: Optional[CascadeConfig] = None,
               tp_policy: str = "cascade", act_policy: str = "cascade",
               dp_shard: str = "none", full_dp: bool = False, remat_policy: str = "dots",
               cfg=None, moe_ep: bool = False, microbatches: int = 1) -> Cell:
    """The cell's step and argument trees (the reference's ``build_step``).
    ``shape`` is a name of ``SHAPES`` or a ``ShapeConfig``; ``cfg`` another
    config of the arch's family (a smoke config)."""
    shape = cfgbase.SHAPES[shape] if isinstance(shape, str) else shape
    act_policy, full_dp = cell_policies(shape.kind, act_policy, dp_shard, full_dp)
    if cfg is None:
        cfg = registry.get_config(arch)
    model = registry.build_model(cfg)
    if ccfg is None:
        ccfg = CascadeConfig(mode="train" if shape.kind == "train" else "serve_fp4")
    train = shape.kind == "train"
    batch_axes = ("pod", "data", "model") if full_dp and train else ("pod", "data")
    tied = bool(cfg.tie_embeddings)
    params = model.init_params(0, ccfg, device="meta")
    pspecs = sharding.placed_param_specs(params, mesh, tp_policy, tied)
    dspecs = (sharding.data_band_specs(pspecs, params, mesh)
              if train and dp_shard != "none" else None)
    batch = cfgbase.input_specs(cfg, shape)
    bspecs = sharding.batch_specs(batch, batch_axes=batch_axes, mesh=mesh)
    trees = {"params": (params, dspecs if dp_shard == "fsdp" and train else pspecs),
             "batch": (batch, bspecs)}
    b0, nb = _data_rows(mesh, batch_axes, shape.global_batch)

    if train:
        opt = AdamW()
        grads = train_loop.MeshGrads(mesh, params, pspecs, dspecs,
                                     dp_shard if dspecs is not None else "none",
                                     batch_axes, full_dp)
        if dp_shard == "fsdp":
            net = FsdpParams(model)
        else:
            net = WholeParams(model, pspecs, mesh) if full_dp else model
        train_step = train_loop.make_train_step(
            net, ccfg, opt, microbatches=microbatches, remat=True, remat_policy=remat_policy,
            mesh_grads=grads)

        def step(args):
            state = train_loop.TrainState(params=args["params"], opt=args["opt"],
                                          step=args["step"])
            return train_step(state, args["batch"])[1]

    elif shape.kind == "prefill":
        whole = model.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=ccfg.resolved_kv_dtype, device="meta")
        model_bands = _without_axes(sharding.cache_specs(whole, mesh), batch_axes)

        def step(args):
            logits, cache = model.prefill(args["params"], args["batch"], ccfg,
                                          max_len=shape.seq_len)
            return logits, sharding.shard_tree(cache, model_bands, mesh)

    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=ccfg.resolved_kv_dtype, device="meta")
        cspecs = sharding.cache_specs(cache, mesh)
        trees["cache"] = (cache, cspecs)

        def step(args):
            view = rank_cache_view(args["cache"], cspecs, batch_axes, b0, nb)
            return model.decode_step(args["params"], args["batch"], view, ccfg)[0]

    return Cell(shape=shape, mesh=mesh, tp_policy=tp_policy, batch_axes=batch_axes,
                trees=trees, step=step, act_policy=act_policy,
                dp_shard=dp_shard if train else "none", moe_ep=moe_ep, data_specs=dspecs)


# ---------------------------------------------------------------------------
# tracing one rank's step
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            out += _tensors(v)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StorageTally(TorchDispatchMode):
    """Counts, over the ops dispatched inside it, the bytes each op reads
    and writes (operands plus outputs, views excluded) and the storages the
    ops create: each is live from its first appearance until it is freed,
    and ``peak`` is the most bytes live at once. Storages in ``known`` (the
    arguments) are not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.known = set(known)
        self.live: dict = {}
        self.current = 0
        self.peak = 0
        self.bytes_accessed = 0

    def _free(self, key):
        self.current -= self.live.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = sharding._storage_key(t)
        if key in self.known or key in self.live:
            return
        self.live[key] = st.nbytes()
        self.current += self.live[key]
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs)
                                       + _tensors(out))
        for t in _tensors(out):
            self.track(t)
        return out


def _collective_record(counts: dict) -> dict:
    got = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
    got["all-gather"] = {"count": counts["all_gather"]["calls"],
                         "bytes": counts["all_gather"]["bytes"]}
    got["all-reduce"] = {f: counts["all_reduce_sum"][k] + counts["all_reduce_max"][k]
                         for f, k in (("count", "calls"), ("bytes", "bytes"))}
    for kind, name in (("reduce-scatter", "reduce_scatter"), ("all-to-all", "all_to_all")):
        got[kind] = {"count": counts[name]["calls"], "bytes": counts[name]["bytes"]}
    got["total_bytes"] = sum(v["bytes"] for v in got.values())
    return got


def trace_cell(cell: Cell) -> dict:
    """Run the cell's step on fake tensors: FLOPs, bytes, memory and
    collectives of rank 0's step (the record's numbers)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = cell.local_args(lambda s, dt: torch.empty(s, dtype=dt, device="cpu"))
        leaves = [t for name in args for t in T.leaves(args[name])]
        argument_bytes = sum(_nbytes(t) for t in leaves)
        pol = cell.policy(args)
        before = collectives.snapshot()
        tally = StorageTally(sharding._storage_key(t) for t in leaves)
        flops = FlopCounterMode(display=False)
        with sharding.activation_policy(pol), flops, tally:
            out = cell.step(args)
        known = set(tally.known)
        output_bytes = sum(st.nbytes() for st in
                           {sharding._storage_key(t): t.untyped_storage()
                            for t in _tensors(out)
                            if sharding._storage_key(t) not in known}.values())
        counts = collectives.since(before)
    return {"flops": flops.get_total_flops(), "bytes_accessed": tally.bytes_accessed,
            "argument_bytes": argument_bytes, "output_bytes": output_bytes,
            "temp_bytes": tally.peak, "collectives": counts}


def run_cell(arch: str, shape, mesh, ccfg: Optional[CascadeConfig] = None,
             tp_policy: str = "cascade", verbose: bool = True, act_policy: str = "cascade",
             dp_shard: str = "none", full_dp: bool = False, remat_policy: str = "dots",
             cfg=None, moe_ep: bool = False, microbatches: int = 1) -> dict:
    """Trace one cell on rank 0 of ``mesh`` (a mesh over a fake world);
    return its record (the reference's ``lower_cell``). ``shape``: a name of
    ``SHAPES`` or a ``ShapeConfig``."""
    shape = cfgbase.SHAPES[shape] if isinstance(shape, str) else shape
    act_policy, full_dp = cell_policies(shape.kind, act_policy, dp_shard, full_dp)
    cfg = cfg or registry.get_config(arch)
    if not cfgbase.shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape.name, "status": "skipped",
                "reason": "full-attention arch: long_500k requires sub-quadratic attention"}
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, ccfg, tp_policy, act_policy, dp_shard, full_dp,
                      remat_policy, cfg=cfg, moe_ep=moe_ep, microbatches=microbatches)
    got = trace_cell(cell)
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": dict(mesh.shape),
        "tp_policy": tp_policy,
        "act_policy": act_policy,
        "dp_shard": dp_shard,
        "full_dp": full_dp,
        "moe_ep": moe_ep,
        "microbatches": microbatches,
        "status": "ok",
        "trace_s": round(time.time() - t0, 1),
        "flops_per_device": got["flops"],
        "bytes_accessed_per_device": got["bytes_accessed"],
        "memory": {
            "argument_bytes": got["argument_bytes"],
            "output_bytes": got["output_bytes"],
            "temp_bytes": got["temp_bytes"],
            "peak_bytes": got["argument_bytes"] + got["temp_bytes"],
        },
        "collectives": _collective_record(got["collectives"]),
    }
    if verbose:
        print(json.dumps(record), flush=True)
    return record


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_all(archs, shapes, multi_pods, **kw) -> list:
    """Every cell of ``archs`` x ``shapes`` on each production mesh, one fake
    world a mesh; a cell that raises becomes a FAILED record."""
    records = []
    for mp in multi_pods:
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp)
            for arch in archs:
                for shape in shapes:
                    try:
                        rec = run_cell(arch, shape, mesh, **kw)
                    except Exception as e:     # a failure here is a bug in the port
                        rec = {"arch": arch, "shape": getattr(shape, "name", shape),
                               "mesh": dict(mesh.shape),
                               "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                        print(json.dumps(rec), flush=True)
                    records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(cfgbase.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--tp-policy", default="cascade", choices=["cascade", "megatron"])
    ap.add_argument("--act-policy", default="cascade", choices=list(ACT_POLICIES))
    ap.add_argument("--dp-shard", default="none", choices=list(DP_SHARDS))
    ap.add_argument("--full-dp", action="store_true")
    ap.add_argument("--remat-policy", default="dots", choices=["dots", "none", "save_all"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    check_policies(args.act_policy, args.dp_shard, args.full_dp)

    archs = list(registry.ALIASES) if (args.all or args.arch is None) else [args.arch]
    shapes = list(cfgbase.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    records = run_all(archs, shapes, meshes, tp_policy=args.tp_policy,
                      act_policy=args.act_policy, dp_shard=args.dp_shard,
                      full_dp=args.full_dp, remat_policy=args.remat_policy,
                      moe_ep=args.moe_ep, microbatches=args.microbatches)
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    n_fail = sum(r["status"] == "FAILED" for r in records)
    print(f"\n{len(records)} cells: {len(records) - n_fail} ok/skipped, {n_fail} FAILED",
          file=sys.stderr)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
