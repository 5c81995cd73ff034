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
  expert-parallel dispatch on cascade's column-banded experts.
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
    return out
