"""The QAT training step (the reference's ``repro/train/loop.py``): the
loss and its gradients, microbatch accumulation, activation checkpointing
and the AdamW update, as a function (state, batch) -> (state, metrics).

Params are tensors with ``requires_grad``; the gradients reach a stacked
``(L, ...)`` leaf through each layer's view of it. Where the reference
``jit``s the step, the port runs it eagerly; the optimizer updates the
params and its moments in place (``optim.adamw``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.core.cascade import CascadeConfig
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


def make_train_step(model, ccfg: CascadeConfig, optimizer: AdamW, microbatches: int = 1,
                    remat: bool = True, remat_policy: str = "dots", grad_reduce=None,
                    grad_sq=None):
    """``train_step(state, batch) -> (state, metrics)``, metrics ``{"loss",
    "gnorm", "lr"}`` (0-d tensors). ``microbatches`` > 1 splits the batch
    rows and averages the gradients (and the losses), as the reference's
    ``scan``; ``remat_policy``: ``dots`` | ``none`` | ``save_all``
    (``models.remat``). ``grad_reduce`` (a data-parallel mesh's gradient
    mean over its data shards) maps the list of gradients, in the params'
    flatten order, before the update; ``grad_sq`` (its global sum of
    squares over the bands, for the clip) goes to ``AdamW.update``. The
    batch may hold numpy arrays or tensors."""

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
        if grad_reduce is not None:
            grads = grad_reduce(grads)
        params, opt, om = optimizer.update(T.unflatten_like(state.params, grads), state.opt,
                                           state.params, grad_sq=grad_sq)
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
