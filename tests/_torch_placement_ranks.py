"""The per-rank half of ``tests/test_torch_placements.py``: one rank of a
two-rank gloo world, on two meshes of it, (2, 1) and (1, 2). This module
imports torch and the port only, so a rank starts without JAX.

``placement_checks(rank, inputs)`` returns plain Python and numpy results:

* ``("zero", dp_shard)``: three steps of the dry run's train cell on the
  (2, 1) mesh under ``--dp-shard`` ``none`` (the unsharded data-parallel
  step), ``zero1`` and ``fsdp``: the params and moments gathered whole after
  each, the gradient norms, and the local bytes of every data-banded leaf;
* ``("seqpar", ...)``: on the (1, 2) mesh, the dry run's prefill cell under
  ``--act-policy seqpar`` (its logits) and a loss and its gradients with
  the params on their bands under sequence parallelism, beside the
  unsharded model's; the MoE with its expert buffer E over ``model``; the
  expert-parallel dispatch on cascade's column-banded experts;
* ``("fulldp", arch, kind)``: on the (1, 2) mesh, the dry run's prefill and
  decode cells under ``--act-policy fulldp`` (each rank holds its share of
  the batch's rows between blocks) beside the unsharded model's prefill and
  decode step: the logits and the new cache, gathered whole; and the
  decode cell under the plain cascade placement.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.train.loop import cross_entropy

CCFG = CascadeConfig(mode="train", compute_dtype=torch.float32)
DENSE = registry.FAMILY_SMOKE["transformer"]
STEPS = 3
#: serving fulldp's archs -> whether decode merges attention over a banded
#: time or latent axis of the cache (recurrentgemma-2b's ring, MLA's latent)
FULLDP_ARCHS = {"codeqwen1.5-7b": False, "olmoe-1b-7b": False, "mamba2-370m": False,
                "recurrentgemma-2b": True, "deepseek-v2-236b": True}


def _as_np(tree) -> list:
    return [t.detach().numpy().copy() for t in T.leaves(tree)]


def _fill(local_args: dict, params, specs, mesh) -> None:
    """Copy this rank's bands of ``params`` into the cell's argument leaves."""
    with torch.no_grad():
        for a, b in zip(T.leaves(local_args["params"]),
                        T.leaves(sharding.shard_tree(params, specs, mesh))):
            a.copy_(b)


def zero_run(mesh, dp_shard: str, tokens: np.ndarray) -> dict:
    """``STEPS`` steps of the dry run's train cell under ``dp_shard``."""
    cfg, model = registry.load(DENSE, smoke=True)
    params = model.init_params(0, CCFG, device="cpu")
    shape = ShapeConfig("smoke_train", tokens.shape[1] - 1, tokens.shape[0], "train")
    cell = dryrun.build_cell(DENSE, shape, mesh, CCFG, "cascade", dp_shard=dp_shard, cfg=cfg)
    pspecs = cell.trees["params"][1]
    args = cell.local_args(lambda s, dt: torch.zeros(s, dtype=dt))
    _fill(args, params, pspecs, mesh)
    b0, nb = dryrun._data_rows(mesh, cell.batch_axes, tokens.shape[0])
    args["batch"] = {"tokens": torch.from_numpy(tokens[b0:b0 + nb, :-1].copy()),
                     "labels": torch.from_numpy(tokens[b0:b0 + nb, 1:].copy())}
    mspecs = cell.data_specs if cell.data_specs is not None else pspecs
    whole = {path: leaf.numel() for path, leaf in T.leaves_with_paths(params)}
    banded = {}
    for path, leaf in T.leaves_with_paths(args["params"]):
        banded[("params",) + path] = (leaf.numel(), whole[path])
    for path, leaf in T.leaves_with_paths(args["opt"].mu):
        banded[("mu",) + path] = (leaf.numel(), whole[path])
    gnorms, losses = [], []
    for _ in range(STEPS):
        with sharding.activation_policy(cell.policy(args)):
            got = cell.step(args)
        args["opt"] = args["opt"]._replace(step=args["opt"].step + 1)
        gnorms.append(float(got["gnorm"]))
        losses.append(float(got["loss"]))
    gather = lambda tree, specs: sharding.gather_tree(T.tree_map(lambda t: t.detach(), tree),
                                                      specs, mesh)
    return {"params": _as_np(gather(args["params"], pspecs)),
            "mu": _as_np(gather(args["opt"].mu, mspecs)),
            "nu": _as_np(gather(args["opt"].nu, mspecs)),
            "gnorm": gnorms, "loss": losses, "numel": banded}


def _grads(model, params, batch, policy):
    p = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    with sharding.activation_policy(policy):
        loss = cross_entropy(model.forward(p, batch, CCFG), batch["labels"])
        g = torch.autograd.grad(loss, T.leaves(p))
    return loss.item(), T.unflatten_like(p, list(g))


def seqpar_grads(mesh, arch: str, tp_policy: str, tokens: np.ndarray, over: dict) -> dict:
    """A loss and its gradients under sequence parallelism (the params on
    their ``tp_policy`` bands, the gradients gathered whole) beside the
    unsharded ones."""
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **over)
    model = registry.build_model(cfg)
    params = model.init_params(0, CCFG, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    want_loss, want = _grads(model, params, batch, None)
    specs = sharding.placed_param_specs(params, mesh, tp_policy, bool(cfg.tie_embeddings))
    local = sharding.shard_tree(params, specs, mesh)
    p = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), local)
    policy = sharding.ActivationPolicy(mesh, tp_policy, p, specs, act="seqpar")
    with sharding.activation_policy(policy):
        loss = cross_entropy(model.forward(p, batch, CCFG), batch["labels"])
        g = torch.autograd.grad(loss, T.leaves(p))
    got = sharding.gather_tree(T.unflatten_like(p, list(g)), specs, mesh)
    return {"loss": (want_loss, loss.item()),
            "grads": list(zip(_as_np(want), _as_np(got))),
            "numel": [(a.numel(), b.numel()) for a, b in zip(T.leaves(local),
                                                             T.leaves(params))]}


def seqpar_prefill(mesh, tp_policy: str, tokens: np.ndarray) -> dict:
    """The dry run's prefill cell under ``--act-policy seqpar`` (logits)
    beside the unsharded model's prefill."""
    cfg, model = registry.load(DENSE, smoke=True)
    params = model.init_params(0, CCFG, device="cpu")
    shape = ShapeConfig("smoke_prefill", tokens.shape[1], tokens.shape[0], "prefill")
    cell = dryrun.build_cell(DENSE, shape, mesh, CCFG, tp_policy, act_policy="seqpar", cfg=cfg)
    args = cell.local_args(lambda s, dt: torch.zeros(s, dtype=dt))
    _fill(args, params, cell.trees["params"][1], mesh)
    args["batch"] = {"tokens": torch.from_numpy(tokens.copy())}
    with torch.no_grad():
        want, _ = model.prefill(params, args["batch"], CCFG, max_len=shape.seq_len)
        with sharding.activation_policy(cell.policy(args)):
            got, _ = cell.step(args)
    return {"logits": (want.numpy(), got.numpy())}


def moe_ep_cascade(mesh, tokens: np.ndarray) -> dict:
    """olmoe's expert-parallel dispatch with the experts on cascade's column
    bands (re-banded by experts with all-to-alls) beside megatron's expert
    bands: the same function."""
    cfg = registry.get_config("olmoe-1b-7b", smoke=True)
    model = registry.build_model(cfg)
    params = model.init_params(0, CCFG, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens.copy())}
    out = {}
    for tp in ("cascade", "megatron"):
        specs = sharding.placed_param_specs(params, mesh, tp)
        local = sharding.shard_tree(params, specs, mesh)
        policy = sharding.ActivationPolicy(mesh, tp, local, specs, moe_ep=True)
        with torch.no_grad(), sharding.activation_policy(policy):
            out[tp] = model.forward(local, batch, CCFG).numpy()
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy().copy()


def fulldp_serving(mesh, arch: str, tokens: np.ndarray, max_len: int, device="cpu",
                   ccfg: CascadeConfig = CCFG) -> dict:
    """The dry run's prefill cell (over ``tokens[:, :-1]``) and decode cell
    (one step on the token after them, over a cache of ``max_len`` rows
    filled by the unsharded prefill) under ``--act-policy fulldp``, beside
    the unsharded prefill and decode step. Returns each kind's (want, got)
    logits and caches, the sharded caches gathered whole."""
    cfg, model = registry.load(arch, smoke=True)
    params = model.init_params(0, ccfg, device=device)
    b, s = tokens.shape[0], tokens.shape[1] - 1
    prompt = {"tokens": torch.from_numpy(tokens[:, :-1].copy()).to(device)}
    step_tok = {"tokens": torch.from_numpy(tokens[:, -1:].copy()).to(device)}
    as_np = lambda c: {"/".join(p): _np(t) for p, t in T.leaves_with_paths(c)}
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    out = {}
    with torch.no_grad():
        # prefill: the cell's cache comes out on the model bands of cache_specs
        shape = ShapeConfig("smoke_prefill", s, b, "prefill")
        cell = dryrun.build_cell(arch, shape, mesh, ccfg, act_policy="fulldp", cfg=cfg)
        args = cell.local_args(zeros)
        _fill(args, params, cell.trees["params"][1], mesh)
        args["batch"] = prompt
        want, want_cache = model.prefill(params, prompt, ccfg, max_len=s)
        with sharding.activation_policy(cell.policy(args)):
            got, got_cache = cell.step(args)
        bands = dryrun._without_axes(sharding.cache_specs(want_cache, mesh), cell.batch_axes)
        out["prefill"] = {"logits": (_np(want), _np(got)),
                          "cache": (as_np(want_cache),
                                    as_np(sharding.gather_tree(got_cache, bands, mesh)))}
        # decode, under fulldp and the plain cell's cascade placement: the
        # cell's cache args are the prefill's cache cut by cache_specs
        shape = ShapeConfig("smoke_decode", max_len, b, "decode")
        _, cache = model.prefill(params, prompt, ccfg, max_len=max_len)
        for act in ("cascade", "fulldp"):
            cell = dryrun.build_cell(arch, shape, mesh, ccfg, act_policy=act, cfg=cfg)
            args = cell.local_args(zeros)
            _fill(args, params, cell.trees["params"][1], mesh)
            cspecs = cell.trees["cache"][1]
            for a, w in zip(T.leaves(args["cache"]),
                            T.leaves(sharding.shard_tree(cache, cspecs, mesh))):
                a.copy_(w)
            args["batch"] = step_tok
            with sharding.activation_policy(cell.policy(args)):
                got = cell.step(args)
            out[act] = (_np(got), as_np(sharding.gather_tree(args["cache"], cspecs, mesh)))
        want, want_cache = model.decode_step(params, step_tok, cache, ccfg)
        out["decode"] = {"logits": (_np(want), out["fulldp"][0]),
                         "cache": (as_np(want_cache), out.pop("fulldp")[1])}
        out["cascade_cell"] = out.pop("cascade")
        out["bands"] = sorted({"/".join(p) for p, spec in sharding._spec_leaves(cspecs)
                               if any(n is not None and "model" in sharding._axis_names(n)
                                      for n in spec)})
    return out


def placement_checks(rank: int, inputs: dict) -> dict:
    rows = make_mesh((2, 1), ("data", "model"))
    cols = make_mesh((1, 2), ("data", "model"))
    out = {}
    for dp_shard in ("none", "zero1", "fsdp"):
        out[("zero", dp_shard)] = zero_run(rows, dp_shard, inputs["train"])
    for tp in ("cascade", "megatron"):
        out[("seqpar", "prefill", tp)] = seqpar_prefill(cols, tp, inputs["prefill"])
        out[("seqpar", "dense", tp)] = seqpar_grads(cols, DENSE, tp, inputs["train"], {})
    out[("seqpar", "moe16", "cascade")] = seqpar_grads(
        cols, "olmoe-1b-7b", "cascade", inputs["moe_train"], {"n_experts": 16})
    out[("seqpar", "mamba", "cascade")] = seqpar_grads(cols, "mamba2-370m", "cascade",
                                                       inputs["train"], {})
    out["moe_ep"] = moe_ep_cascade(cols, inputs["prefill"])
    for arch, tokens in inputs["fulldp"].items():
        out[("fulldp", arch)] = fulldp_serving(cols, arch, tokens, inputs["fulldp_max_len"])
    return out


def fulldp_card(rank: int, inputs: dict) -> dict:
    """One rank of a two-rank gloo world sharing the card: ``fulldp_serving``
    on the (1, 2) mesh, FP4 params, bf16, through the kernels."""
    torch.cuda.set_device(0)
    cols = make_mesh((1, 2), ("data", "model"))
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    return {arch: fulldp_serving(cols, arch, tokens, inputs["fulldp_max_len"], "cuda", ccfg)
            for arch, tokens in inputs["fulldp"].items()}
