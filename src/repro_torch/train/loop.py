"""The QAT training step (the reference's ``repro/train/loop.py``): the
loss and its gradients, microbatch accumulation, activation checkpointing
and the AdamW update, as a function (state, batch) -> (state, metrics).

Params are tensors with ``requires_grad``; the gradients reach a stacked
``(L, ...)`` leaf through each layer's view of it. Where the reference
``jit``s the step, the port runs it eagerly; the optimizer updates the
params and its moments in place (``optim.adamw``).

On a mesh (explicit SPMD, every rank the same step on its own rows and
bands) :class:`MeshGrads` is the gradient arithmetic: the mean over the
data shards, the clip's global norm over every band, and the reference's
``--dp-shard`` placements of the optimizer state:

* ``zero1`` (ZeRO-1): the moments hold a data band of each leaf
  (``sharding.data_band_specs``); the gradients are reduce-scattered over
  the data axes onto that band, AdamW updates the param's band with the
  same ops in the same order, and the updated bands are all-gathered over
  the data axes into the param;
* ``fsdp`` (ZeRO-3): the params hold the data band too; the forward
  gathers each layer's params inside its remat region
  (``sharding.ActivationPolicy.gather_layer``), whose backward
  reduce-scatters the gradients onto the band, so the update is local.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor          # () int32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy from an f32 log-softmax; the (B, S, C, V)
    codebook layout (musicgen) flattens like (B, S, V)."""
    vocab = logits.shape[-1]
    ll = F.log_softmax(logits.reshape(-1, vocab).to(torch.float32), dim=-1)
    return -ll.gather(1, labels.reshape(-1, 1).to(torch.int64)).mean()


def _as_tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class MeshGrads:
    """The gradient arithmetic of one rank's train step on ``mesh``.
    ``params`` is the whole tree (meta tensors will do), ``specs`` its
    placed model bands, ``data_specs`` (``zero1``/``fsdp``) the data bands
    of the moments and, under ``fsdp``, of the params; ``batch_axes`` the
    axes the batch rows run over (every axis under full data parallelism,
    whose step gathers the model bands whole and sums their gradients back
    onto them). Leaves are taken in the params' flatten order."""

    def __init__(self, mesh, params, specs, data_specs=None, dp_shard: str = "none",
                 batch_axes: tuple = ("pod", "data"), full_dp: bool = False):
        self.mesh, self.dp_shard, self.full_dp = mesh, dp_shard, full_dp
        self.reduce_axes = tuple(a for a in batch_axes if mesh.size(a) > 1)
        self.n_rows = 1
        for a in self.reduce_axes:
            self.n_rows *= mesh.size(a)
        self.leaves = []
        for path, _ in T.leaves_with_paths(params):
            spec = sharding._spec_at(specs, path)
            dspec = sharding._spec_at(data_specs, path) if data_specs is not None else spec
            names = lambda sp: sum((sharding._axis_names(n) for n in sp if n is not None), ())
            model = "model" in names(spec) and mesh.size("model") > 1
            data = ("pod", "data")
            ddim = next((i for i, a in enumerate(dspec) if a is not None
                         and any(n in data for n in sharding._axis_names(a))), None) \
                if dp_shard != "none" else None
            daxes = tuple(a for a in sharding._axis_names(dspec[ddim]) if a in data) \
                if ddim is not None else ()
            self.leaves.append((model, ddim, tuple(a for a in daxes if mesh.size(a) > 1)))

    def _band(self, axes) -> tuple:
        return sharding._band_index(self.mesh, axes)

    def reduce(self, grads: list) -> list:
        """The mean over the batch rows of every gradient, on its band:
        summed over the reduce axes in order (pod, data, model), by an
        all-reduce, or onto the data band by a reduce-scatter (``zero1``);
        a sum the step's gathers made already (``fsdp``'s data bands, full
        data parallelism's model bands) is not made again."""
        out = []
        for g, (model, ddim, daxes) in zip(grads, self.leaves):
            for a in self.reduce_axes:
                if (a == "model" and model and self.full_dp) or \
                        (self.dp_shard == "fsdp" and a in daxes):
                    continue
                if self.dp_shard == "zero1" and a in daxes:
                    g = collectives.reduce_scatter(g, self.mesh.group(a), ddim)
                else:
                    g = collectives.all_reduce(g, self.mesh.group(a), "sum")
            out.append(g / self.n_rows if self.n_rows > 1 else g)
        return out

    def sq(self, grads: list) -> torch.Tensor:
        """The whole gradients' sum of squares: each leaf's band squared and
        summed, the sums of the leaves banded alike all-reduced over the
        axes that band them (model-banded first, as the unsharded step adds
        them)."""
        groups: dict = {}
        for g, (model, ddim, daxes) in zip(grads, self.leaves):
            key = (("model",) if model else ()) + (daxes if ddim is not None else ())
            part = torch.sum(g.to(torch.float32) ** 2)
            groups[key] = part if key not in groups else groups[key] + part
        total = None
        for key in sorted(groups, key=lambda k: (k != ("model",), k == (), k)):
            part = groups[key]
            for a in key:
                part = collectives.all_reduce(part, self.mesh.group(a), "sum")
            total = part if total is None else total + part
        return total

    def view(self, i: int, p: torch.Tensor) -> torch.Tensor:
        """What AdamW updates of leaf ``i``: under ``zero1`` the param's
        data band (a view), else the param."""
        model, ddim, daxes = self.leaves[i]
        if self.dp_shard != "zero1" or ddim is None or not daxes:
            return p
        idx, count = self._band(daxes)
        w = p.shape[ddim] // count
        return p.narrow(ddim, idx * w, w)

    @torch.no_grad()
    def publish(self, params) -> None:
        """After a ``zero1`` update: every param's data bands all-gathered
        into the whole param."""
        if self.dp_shard != "zero1":
            return
        for i, p in enumerate(T.leaves(params)):
            model, ddim, daxes = self.leaves[i]
            if ddim is None or not daxes:
                continue
            band = self.view(i, p).clone()
            for a in reversed(daxes):
                band = collectives.all_gather(band, self.mesh.group(a), dim=ddim)
            p.copy_(band)


def make_train_step(model, ccfg: CascadeConfig, optimizer: AdamW, microbatches: int = 1,
                    remat: bool = True, remat_policy: str = "dots",
                    mesh_grads: MeshGrads | None = None):
    """``train_step(state, batch) -> (state, metrics)``, metrics ``{"loss",
    "gnorm", "lr"}`` (0-d tensors). ``microbatches`` > 1 splits the batch
    rows and averages the gradients (and the losses), as the reference's
    ``scan``; ``remat_policy``: ``dots`` | ``none`` | ``save_all``
    (``models.remat``). On a mesh, ``mesh_grads`` (:class:`MeshGrads`)
    reduces the gradients (in the params' flatten order) before the update,
    gives the clip its global sum of squares, and names the ZeRO-1 bands
    the update writes and publishes. The batch may hold numpy arrays or
    tensors."""

    def loss_and_grads(params, batch):
        flat = T.leaves(params)
        logits = model.forward(params, batch, ccfg, remat=remat, remat_policy=remat_policy)
        loss = cross_entropy(logits, batch["labels"])
        del logits
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
        return loss.detach(), grads

    def train_step(state: TrainState, batch: dict):
        flat = T.leaves(state.params)
        batch = _as_tensors(batch, flat[0].device)
        if microbatches > 1:
            rows = next(iter(batch.values())).shape[0] // microbatches
            losses, acc = [], None
            for j in range(microbatches):
                mb = {k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
                loss, grads = loss_and_grads(state.params, mb)
                losses.append(loss)
                gf = [g.to(torch.float32) for g in grads]
                acc = gf if acc is None else [a + g for a, g in zip(acc, gf)]
            loss = torch.stack(losses).mean()
            grads = [(a / microbatches).to(p.dtype) for a, p in zip(acc, flat)]
        else:
            loss, grads = loss_and_grads(state.params, batch)
        grad_sq = param_view = None
        if mesh_grads is not None:
            grads = mesh_grads.reduce(grads)
            grad_sq, param_view = mesh_grads.sq, mesh_grads.view
        params, opt, om = optimizer.update(
            T.unflatten_like(state.params, grads), state.opt, state.params, grad_sq=grad_sq,
            param_view=param_view)
        if mesh_grads is not None:
            mesh_grads.publish(params)
        return TrainState(params, opt, state.step + 1), {"loss": loss, **om}

    return train_step


def init_state(model, ccfg: CascadeConfig, optimizer: AdamW, seed: int = 0,
               device=None) -> TrainState:
    """Params from ``seed`` (``requires_grad``), zero moments, step 0, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = model.init_params(seed, ccfg, device=device)
    for p in T.leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))
