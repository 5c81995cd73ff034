"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

* ``argument_bytes``: for every arch at ``decode_32k`` and ``train_4k``, on
  both production meshes, under cascade and megatron, the port's per-rank
  arguments (params, optimizer state, batch, cache, as the dry run places
  them) are the reference's spec arithmetic to the byte: the per-device
  shapes of ``repro.distributed.sharding.param_specs``/``batch_specs``/
  ``cache_specs`` applied to ``jax.eval_shape`` of the reference's
  ``init_params``, ``init_cache`` and ``input_specs``. The reference's
  jit refuses an argument whose dim its axis does not divide
  (mamba2-370m's 50,280-row table under megatron), so the arithmetic takes
  the reference's ``filter_divisible`` of its param specs, as the port
  places them. The reference's specs read a mesh stand-in that holds only
  the production ``.shape`` and fails on any other attribute; the port's
  read rank 0's coordinates beside it (no process group is needed).
* The record has the reference's keys and collective kinds, ``trace_s``
  for ``compile_s``.
* FLOPs: the smoke dense model's decode, prefill and train steps count the
  reference's loop-corrected dot FLOPs (``repro.analysis.hlo.analyze``)
  of the same step lowered on one CPU device, exactly. Other families'
  serving steps differ by ops named in ``_named_differences``, each
  computed from the config.
* The CLI on ``qwen2-vl-2b decode_32k`` under both policies: status ok and
  ``peak_bytes < 16e9`` (the bound of the reference's own slow test,
  ``tests/test_analysis.py``), and no process group left afterwards.
* The reference's other placements: ``--dp-shard zero1|fsdp`` (with and
  without ``--full-dp``) keep the reference's argument bytes, its
  ``add_data_dim`` on the filtered param specs for the moments (and the
  params under FSDP); ``--act-policy seqpar|none`` keep them too; MoE cells
  trace under ``seqpar`` (the expert buffer E over ``model``) and with
  ``moe_ep``; FSDP holds one layer's params whole at a time; ``--full-dp``
  alone on a serving cell traces the plain cell.
* ``--act-policy fulldp`` on serving cells: the arguments are the plain
  cell's, the reference's spec arithmetic to the byte, at ``decode_32k``
  and ``prefill_32k`` on both production meshes; every family's smoke
  cells trace with each rank's rows returned by all-to-alls and no
  partial-sum all-reduce under cascade; a sweep gives ``status: ok`` on
  every cell.
"""
import dataclasses
import functools
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np
import torch.distributed as dist

_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun   # noqa: E402  (sets XLA_FLAGS for a fresh jax)
if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro.analysis import hlo as jhlo
from repro.configs import base as jbase
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.distributed import sharding as jshd
from repro.models import registry as jregistry
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

ARCHS = list(registry.ALIASES)
MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


class ShapeOnlyMesh:
    """A mesh that is its production ``.shape`` and nothing else."""

    def __init__(self, shape: dict):
        self.__dict__["shape"] = dict(shape)

    def __getattr__(self, name):
        raise AssertionError(f"the reference's spec functions read mesh.{name}")


# ---------------------------------------------------------------------------
# argument bytes
# ---------------------------------------------------------------------------

def _local_bytes(leaf, spec, mesh_shape: dict) -> int:
    size = lambda name: math.prod(mesh_shape.get(a, 1) for a in
                                  (name if isinstance(name, tuple) else (name,)))
    parts = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
    dims = [d // size(n) if n is not None else d for d, n in zip(leaf.shape, parts)]
    return math.prod(dims) * np.dtype(leaf.dtype).itemsize


def _tree_bytes(tree, specs, mesh_shape) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(l, s, mesh_shape) for l, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _reference_trees(arch: str, shape_name: str):
    cfg, model = jregistry.load(arch)
    shape = jbase.SHAPES[shape_name]
    ccfg = JCascadeConfig(mode="train" if shape.kind == "train" else "serve_fp4", qat=False)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0), ccfg))
    batch = jbase.input_specs(cfg, shape)
    cache = None
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch, shape.seq_len,
                                                        dtype=ccfg.resolved_kv_dtype))
    return cfg, params, batch, cache


def reference_argument_bytes(arch: str, shape_name: str, multi_pod: bool, policy: str,
                             dp_shard: str = "none", full_dp: bool = False) -> dict:
    """The reference's per-device argument bytes of a cell, by group
    (``build_step``'s in_specs: the moments, and under FSDP the params, on
    ``add_data_dim`` of the param specs; a train cell's batch over every
    axis under ``full_dp``)."""
    cfg, params, batch, cache = _reference_trees(arch, shape_name)
    mesh = ShapeOnlyMesh(MESHES[multi_pod])
    pspecs = jshd.filter_divisible(
        jshd.param_specs(params, policy, tied_embed=cfg.tie_embeddings), params, mesh)
    mspecs = pspecs
    train = jbase.SHAPES[shape_name].kind == "train"
    if train and dp_shard in ("zero1", "fsdp"):
        mspecs = jshd.add_data_dim(pspecs, params, mesh)
    axes = ("pod", "data", "model") if full_dp and train else ("pod", "data")
    out = {"params": _tree_bytes(params, mspecs if dp_shard == "fsdp" and train else pspecs,
                                 mesh.shape),
           "batch": _tree_bytes(batch, jshd.batch_specs(batch, batch_axes=axes, mesh=mesh),
                                mesh.shape)}
    if cache is not None:
        out["cache"] = _tree_bytes(cache, jshd.cache_specs(cache, mesh), mesh.shape)
    if jbase.SHAPES[shape_name].kind == "train":
        opt = jax.eval_shape(lambda: JAdamW().init(params))
        moments = _tree_bytes(opt.mu, mspecs, mesh.shape) + _tree_bytes(opt.nu, mspecs, mesh.shape)
        out["opt"] = moments + 4 + 4          # AdamWState.step and TrainState.step, int32
    return out


class RankZeroMesh(ShapeOnlyMesh):
    """The port's side of the arithmetic: rank 0 of a production mesh, as
    the placement reads it (``shape``, ``size``, ``coord``); it has no
    process groups, and the arguments need none."""

    def size(self, axis):
        return self.shape.get(axis, 1)

    def coord(self, axis):
        return 0


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def production_mesh(request):
    return request.param, RankZeroMesh(MESHES[request.param])


def _port_argument_bytes(arch, shape, mesh, policy, **kw) -> dict:
    cell = dryrun.build_cell(arch, shape, mesh, tp_policy=policy, **kw)
    args = cell.local_args(lambda s, dt: torch.empty(s, dtype=dt, device="meta"))
    got = {k: sum(t.numel() * t.element_size() for t in T.leaves(v)) for k, v in args.items()}
    got["opt"] = got.get("opt", 0) + got.pop("step", 0)
    return {k: v for k, v in got.items() if v}


@pytest.mark.parametrize("policy", ["cascade", "megatron"])
@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_reference_spec_arithmetic(production_mesh, arch, shape, policy):
    multi_pod, mesh = production_mesh
    want = reference_argument_bytes(arch, shape, multi_pod, policy)
    got = _port_argument_bytes(arch, shape, mesh, policy)
    assert got == want, (arch, shape, multi_pod, policy)


@pytest.mark.parametrize("kw", [dict(dp_shard="zero1"), dict(dp_shard="fsdp"),
                                dict(dp_shard="fsdp", full_dp=True)],
                         ids=["zero1", "fsdp", "fsdp-full-dp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_under_zero1_and_fsdp_are_the_reference_arithmetic(production_mesh,
                                                                          arch, kw):
    """``train_4k`` under cascade: the moments (ZeRO-1), and the params too
    (FSDP), on the reference's ``add_data_dim`` of the filtered param
    specs, to the byte; the port's data band keeps a stacked leaf's layer
    dim whole (``sharding.data_band_specs``), at the same bytes a rank."""
    multi_pod, mesh = production_mesh
    want = reference_argument_bytes(arch, "train_4k", multi_pod, "cascade", **kw)
    assert _port_argument_bytes(arch, "train_4k", mesh, "cascade", **kw) == want


@pytest.mark.parametrize("act_policy", ["seqpar", "none"])
@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_seqpar_and_none_keep_the_reference_argument_bytes(arch, shape, act_policy):
    mesh = RankZeroMesh(MESHES[False])
    want = reference_argument_bytes(arch, shape, False, "cascade")
    got = _port_argument_bytes(arch, shape, mesh, "cascade", act_policy=act_policy)
    assert got == want


def test_qwen25_32b_kv_cache_is_a_sixteenth_a_rank(production_mesh):
    """qwen2.5-32b's 8 KV heads do not divide the 16-wide model axis, so
    the reference bands the cache's time: 64 layers x 8 slots x 32,768
    rows x 8 heads x 128 x 2 (k and v) x 2 B is 68.7 GB held whole and
    4.29 GB a rank."""
    multi_pod, mesh = production_mesh
    cell = dryrun.build_cell("qwen2.5-32b", "decode_32k", mesh)
    args = cell.local_args(lambda s, dt: torch.empty(s, dtype=dt, device="meta"))
    kv = sum(args["cache"]["layers"][k].numel() * 2 for k in ("k", "v"))
    slots = 128 // (32 if multi_pod else 16)
    assert kv == 64 * slots * 32768 * 8 * 128 * 2 * 2 // 16
    if not multi_pod:
        assert kv == 4_294_967_296


# ---------------------------------------------------------------------------
# the record and its FLOPs, against the reference's lowering on one device
# ---------------------------------------------------------------------------

SMOKE_SHAPES = {"decode": ShapeConfig("t_decode", 64, 4, "decode"),
                "prefill": ShapeConfig("t_prefill", 32, 2, "prefill"),
                "train": ShapeConfig("t_train", 32, 4, "train")}


@functools.lru_cache(maxsize=None)
def reference_cell(arch: str, kind: str):
    """The reference's ``lower_cell`` of a smoke config on a 1 x 1 mesh of
    this process's CPU device: its record and its loop-corrected dot
    FLOPs. (The reference's registry is pointed at the smoke config and its
    ``SHAPES`` given the cell's shape for the call; both are put back.)"""
    s = SMOKE_SHAPES[kind]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    load, get = jregistry.load, jregistry.get_config
    jdryrun.registry.load = lambda a, smoke=False: load(a, smoke=True)
    jdryrun.registry.get_config = lambda a, smoke=False: get(a, smoke=True)
    jbase.SHAPES[s.name] = jbase.ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
    try:
        rec = jdryrun.lower_cell(arch, s.name, mesh, verbose=False, return_compiled=True)
    finally:
        jdryrun.registry.load, jdryrun.registry.get_config = load, get
        del jbase.SHAPES[s.name]
    rec["dot_flops"] = jhlo.analyze(rec.pop("_compiled").as_text())["dot_flops"]
    return rec


def port_cell(arch: str, kind: str) -> dict:
    with dryrun.fake_world(1):
        mesh = meshlib.make_mesh((1, 1), ("data", "model"))
        return dryrun.run_cell(arch, SMOKE_SHAPES[kind], mesh, verbose=False,
                               cfg=registry.get_config(arch, smoke=True))


def test_record_has_the_reference_keys():
    want = reference_cell("codeqwen1.5-7b", "decode")
    got = port_cell("codeqwen1.5-7b", "decode")
    assert set(got) == (set(want) - {"compile_s", "dot_flops"}) | {"trace_s", "microbatches"}
    assert set(got["memory"]) == set(want["memory"])
    assert set(got["collectives"]) == set(want["collectives"])
    assert all(set(v) == {"count", "bytes"} for k, v in got["collectives"].items()
               if k != "total_bytes")
    assert got["memory"]["peak_bytes"] == (got["memory"]["argument_bytes"]
                                           + got["memory"]["temp_bytes"])
    assert got["status"] == "ok" and got["flops_per_device"] > 0


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_flops_are_the_reference_loop_corrected_dot_flops(kind):
    """The smoke dense model: every dot the reference lowers is a matmul
    the port runs, loop-corrected on its side (a scanned layer's dots times
    its trip count), FlopCounterMode's count of them on the port's."""
    want = reference_cell("codeqwen1.5-7b", kind)["dot_flops"]
    assert port_cell("codeqwen1.5-7b", kind)["flops_per_device"] == want


def _named_differences(arch: str, kind: str) -> dict:
    """The port's FLOPs minus the reference's, op by op, where the two
    compute the same function differently:

    * ``moe_dispatch``: at serving sizes (no drops, T*k*E*C <= 2^22) the
      reference builds the expert buffer with a dot against a one-hot
      (T*k, E*C) selection; the port scatters with ``index_add_``;
    * ``router_rows``: the port's router multiplies rows padded to a
      multiple of ``moe.ROUTER_ROWS`` (one summation order a row, whatever
      the step's row count);
    * ``conv_decode``: the reference's decode conv is an einsum over the
      window; the port's a product and a sum;
    * ``ssd_decode``: the reference's decode y is an einsum over N; the
      port's a product and a sum (each head sums alike whatever the heads
      in the call, so a band of heads is bit-equal);
    * ``ssd_state_grads``: the backward of the chunked SSD's two
      three-operand einsums (the chunk states ``bcqh,bcqhn,bcqhp->bchpn``
      and the carried output ``bcqh,bcqhn,bchpn->bcqhp``): the reference's
      gradient of the (b, c, q, h) operand contracts N in a dot, two a layer;
      the port's einsum takes it through a product and a sum.

    The MoE family's train step has no named difference: its dense layers
    in front run outside the checkpointed regions, and a product with no
    batch dims (MLA's ``btl,lhd->bthd``, a one-batch ``bmm``) is saved, as
    the reference's ``jax.checkpoint`` leaves them.
    """
    from repro_torch.models.moe import ROUTER_ROWS
    cfg = registry.get_config(arch, smoke=True)
    s = SMOKE_SHAPES[kind]
    t = s.global_batch * (1 if kind == "decode" else s.seq_len)
    out = {}
    if cfg.n_experts:
        n_moe = cfg.n_layers - cfg.first_dense_layers
        cap = -(-t // 8) * 8
        e, k, d = cfg.n_experts, cfg.moe_top_k, cfg.d_model
        if t * k * e * cap <= 1 << 22 and kind != "train":
            out["moe_dispatch"] = -2 * (t * k) * (e * cap) * d * n_moe
        out["router_rows"] = 2 * (-t % ROUTER_ROWS) * d * e * n_moe
    if kind == "decode" and cfg.family == "ssm":
        model = registry.build_model(cfg)
        out["conv_decode"] = -2 * t * cfg.conv_width * model.conv_dim * cfg.n_layers
        out["ssd_decode"] = (-2 * t * model.n_heads * cfg.ssm_head_dim * cfg.ssm_state
                             * cfg.n_layers)
    if kind == "train" and cfg.family == "ssm":
        model = registry.build_model(cfg)
        out["ssd_state_grads"] = -2 * 2 * t * model.n_heads * cfg.ssm_state * cfg.n_layers
    if kind == "decode" and cfg.family == "hybrid":
        model = registry.build_model(cfg)
        out["conv_decode"] = -2 * t * cfg.conv_width * model.lru * model.n_rec
    return out


@pytest.mark.parametrize("arch,kind", [("mamba2-370m", "decode"), ("recurrentgemma-2b", "decode"),
                                       ("olmoe-1b-7b", "decode"), ("olmoe-1b-7b", "prefill"),
                                       ("deepseek-v2-236b", "decode"), ("qwen2-vl-2b", "decode"),
                                       ("mamba2-370m", "train"), ("deepseek-v2-236b", "train")])
def test_flops_differ_from_the_reference_by_named_ops(arch, kind):
    want = reference_cell(arch, kind)["dot_flops"]
    got = port_cell(arch, kind)["flops_per_device"]
    assert got - want == sum(_named_differences(arch, kind).values()), \
        (arch, kind, got, want, _named_differences(arch, kind))


@pytest.mark.parametrize("kind", ["decode", "train"])
@pytest.mark.parametrize("policy", ["cascade", "megatron"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_cells_trace_on_a_mesh_under_both_policies(arch, policy, kind):
    """The routed experts on a (2, 2) fake world: banded on N (cascade) or on
    E (megatron: expert parallelism inside the capacity dispatch), forward
    and, for train, the gradients; megatron's row bands all-reduce."""
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"))
        rec = dryrun.run_cell(arch, SMOKE_SHAPES[kind], mesh, tp_policy=policy, verbose=False,
                              cfg=registry.get_config(arch, smoke=True))
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert (rec["collectives"]["all-reduce"]["count"] > 0) == (policy == "megatron"
                                                              or kind == "train")


@pytest.mark.parametrize("policy", ["cascade", "megatron"])
def test_full_dp_train_cell_gathers_the_banded_params(policy):
    """``--act-policy fulldp --full-dp`` on a train cell: the batch over every
    axis (a quarter of the rows a rank on (2, 2), where cascade's is a half)
    and each model-banded param all-gathered whole once, at the step's
    start."""
    cfg = registry.get_config("codeqwen1.5-7b", smoke=True)
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"))
        dp = dryrun.run_cell("codeqwen1.5-7b", SMOKE_SHAPES["train"], mesh, tp_policy=policy,
                             act_policy="fulldp", full_dp=True, verbose=False, cfg=cfg)
        tp = dryrun.run_cell("codeqwen1.5-7b", SMOKE_SHAPES["train"], mesh, tp_policy=policy,
                             verbose=False, cfg=cfg)
        specs = dryrun.build_cell("codeqwen1.5-7b", SMOKE_SHAPES["train"], mesh,
                                  tp_policy=policy, cfg=cfg).trees["params"][1]
    n_banded = sum(any(n is not None and "model" in sharding._axis_names(n) for n in spec)
                   for _, spec in sharding._spec_leaves(specs))
    rows = SMOKE_SHAPES["train"].global_batch
    tokens = 2 * SMOKE_SHAPES["train"].seq_len * 4          # tokens and labels, int32
    assert tp["memory"]["argument_bytes"] - dp["memory"]["argument_bytes"] == \
        tokens * (rows // 2 - rows // 4)
    assert dp["full_dp"] and dp["collectives"]["all-gather"]["count"] == n_banded > 0


# ---------------------------------------------------------------------------
# the CLI and the placements not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["cascade", "megatron"])
def test_cli_traces_a_decode_cell_within_the_reference_bound(policy, tmp_path, capsys):
    out = tmp_path / "rec.json"
    rc = dryrun.main(["--arch", "qwen2-vl-2b", "--shape", "decode_32k", "--tp-policy", policy,
                      "--out", str(out)])
    assert rc == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["tp_policy"] == policy
    assert rec["memory"]["peak_bytes"] < 16e9
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert not dist.is_initialized()
    assert "0 FAILED" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [dict(act_policy="seqpar"), dict(act_policy="none"),
                                dict(dp_shard="zero1"), dict(dp_shard="fsdp")],
                         ids=["seqpar", "none", "zero1", "fsdp"])
def test_every_placement_of_the_reference_is_accepted(kw):
    args = dict(act_policy="cascade", dp_shard="none", full_dp=False)
    args.update(kw)
    assert dryrun.check_policies(**args) == (args["act_policy"], False)
    with pytest.raises(ValueError, match="unknown"):
        dryrun.check_policies(**dict(args, dp_shard="zero9"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("kw", [dict(act_policy="seqpar"), dict(moe_ep=True)],
                         ids=["seqpar", "moe_ep"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_cells_trace_under_seqpar_and_moe_ep(arch, kw, kind):
    """A (2, 2) fake world, 16 experts: under ``seqpar`` the column-banded
    expert stacks are re-banded by experts (all-to-alls) and the residual's
    rows return to each rank by all-to-alls; ``moe_ep`` runs the
    expert-parallel dispatch on cascade's bands (re-banded likewise)."""
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), n_experts=16)
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"))
        rec = dryrun.run_cell(arch, SMOKE_SHAPES[kind], mesh, verbose=False, cfg=cfg, **kw)
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert rec["collectives"]["all-to-all"]["count"] > 0
    assert rec["moe_ep"] == kw.get("moe_ep", False)


def test_fsdp_gathers_one_layer_at_a_time():
    """``--full-dp --dp-shard fsdp`` on a (2, 2) fake world: the params and
    moments a quarter a rank, each layer gathered inside its remat region,
    so the step's temp is below the ``--full-dp`` record's (which gathers
    every param whole at the start) by more than half the whole params."""
    cfg = dataclasses.replace(registry.get_config("codeqwen1.5-7b", smoke=True), n_layers=6)
    whole = sum(t.numel() * t.element_size() for t in T.leaves(
        registry.build_model(cfg).init_params(0, CascadeConfig(), device="meta")))
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"))
        run = lambda **kw: dryrun.run_cell("codeqwen1.5-7b", SMOKE_SHAPES["train"], mesh,
                                           verbose=False, cfg=cfg, full_dp=True, **kw)
        dp, fsdp = run(), run(dp_shard="fsdp")
    assert fsdp["memory"]["temp_bytes"] < dp["memory"]["temp_bytes"] - whole // 2
    assert fsdp["collectives"]["reduce-scatter"]["count"] > 0
    assert fsdp["dp_shard"] == "fsdp" and fsdp["full_dp"]


def test_full_dp_alone_on_a_serving_cell_traces_the_plain_cell():
    """The reference's ``full_dp`` changes no serving spec: the record is
    the plain cell's, but for ``full_dp: true``."""
    cfg = registry.get_config("codeqwen1.5-7b", smoke=True)
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"))
        for kind in ("decode", "prefill"):
            plain = dryrun.run_cell("codeqwen1.5-7b", SMOKE_SHAPES[kind], mesh, verbose=False,
                                    cfg=cfg)
            dp = dryrun.run_cell("codeqwen1.5-7b", SMOKE_SHAPES[kind], mesh, verbose=False,
                                 cfg=cfg, full_dp=True)
            assert dp["full_dp"] and dp["act_policy"] == "cascade"
            for key in ("memory", "collectives", "flops_per_device"):
                assert dp[key] == plain[key], (kind, key)


@pytest.mark.parametrize("kw", [dict(act_policy="fulldp"), dict(full_dp=True)],
                         ids=["act-policy", "full-dp"])
def test_fulldp_and_full_dp_imply_each_other(kw):
    """Either flag asks for full data parallelism: both are set after the
    check, and the record says so."""
    args = dict(act_policy="cascade", dp_shard="none", full_dp=False)
    args.update(kw)
    assert dryrun.check_policies(**args) == ("fulldp", True)
    cfg = registry.get_config("codeqwen1.5-7b", smoke=True)
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((1, 4), ("data", "model"))
        rec = dryrun.run_cell("codeqwen1.5-7b", SMOKE_SHAPES["train"], mesh, verbose=False,
                              cfg=cfg, **kw)
    assert (rec["act_policy"], rec["full_dp"]) == ("fulldp", True)


@pytest.mark.parametrize("arch", sorted(registry.FAMILY_SMOKE.values()))
def test_fulldp_sweep_gives_ok_on_every_serving_cell(arch):
    """``--act-policy fulldp`` over a family's smoke decode and prefill cells
    on both production meshes (``run_all``, which records a cell that raises
    as FAILED): every record ``ok``, full data parallelism recorded, the rows
    returned to each rank by all-to-alls, no partial-sum all-reduce."""
    recs = dryrun.run_all([arch], [SMOKE_SHAPES["decode"], SMOKE_SHAPES["prefill"]],
                          [False, True], act_policy="fulldp",
                          cfg=registry.get_config(arch, smoke=True), verbose=False)
    assert [r["status"] for r in recs] == ["ok"] * 4
    for rec in recs:
        assert (rec["act_policy"], rec["full_dp"]) == ("fulldp", True)
        assert rec["collectives"]["all-to-all"]["count"] > 0
        assert rec["collectives"]["all-reduce"]["count"] == 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_argument_bytes_of_fulldp_serving_cells_are_the_reference_arithmetic(production_mesh,
                                                                           shape, arch):
    """The reference's fulldp leaves a serving cell's in_specs as they are:
    the port's fulldp cell takes the plain cell's arguments, to the byte."""
    multi_pod, mesh = production_mesh
    want = reference_argument_bytes(arch, shape, multi_pod, "cascade")
    assert _port_argument_bytes(arch, shape, mesh, "cascade", act_policy="fulldp") == want


@pytest.mark.parametrize("policy", ["cascade", "megatron"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", sorted(registry.FAMILY_SMOKE.values()))
def test_fulldp_serving_cells_trace_with_the_rows_over_model(arch, kind, policy):
    """A (2, 2) fake world, 6 rows (3 a data group, padded to 4 over the
    model axis): each rank holds its rows between blocks and every block's
    output linear returns them (an all-to-all of a column band under
    cascade, a reduce-scatter of megatron's partial sums). The FLOPs are the
    plain cell's (every matmul runs on the gathered rows), and cascade
    makes no partial-sum all-reduce."""
    cfg = registry.get_config(arch, smoke=True)
    shape = ShapeConfig(f"t_{kind}6", SMOKE_SHAPES[kind].seq_len, 6, kind)
    with dryrun.fake_world(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"))
        run = lambda **kw: dryrun.run_cell(arch, shape, mesh, tp_policy=policy, verbose=False,
                                           cfg=cfg, **kw)
        plain, dp = run(), run(act_policy="fulldp")
    assert dp["status"] == "ok" and (dp["act_policy"], dp["full_dp"]) == ("fulldp", True)
    assert dp["flops_per_device"] == plain["flops_per_device"]
    assert dp["memory"]["argument_bytes"] == plain["memory"]["argument_bytes"]
    returned = "all-to-all" if policy == "cascade" else "reduce-scatter"
    assert dp["collectives"][returned]["count"] > plain["collectives"][returned]["count"] == 0
    if policy == "cascade":
        assert dp["collectives"]["all-reduce"]["count"] == 0


def test_fake_world_refuses_a_live_group_and_is_torn_down_on_error():
    with pytest.raises(RuntimeError, match="boom"):
        with dryrun.fake_world(4):
            assert dist.get_world_size() == 4
            raise RuntimeError("boom")
    assert not dist.is_initialized()
    with dryrun.fake_world(2):
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_world(2):
                pass
    assert not dist.is_initialized()
