"""Activation checkpointing of a model's layer loop: the reference's
``jax.checkpoint`` around its layer body, one checkpointed region a layer.

Policies (the reference's names):

* ``dots`` -- JAX's ``dots_with_no_batch_dims_saveable``: the outputs of
  the products with no batch dims are saved (``aten.mm`` / ``aten.addmm``:
  every projection, which ``torch.matmul`` folds to one; and an
  ``aten.bmm`` of one batch, which ``torch.einsum`` makes of a product
  whose operands share no free dim, as MLA's ``btl,lhd->bthd``),
  everything else (the norms, rotations, attention's batched products,
  the fake quantization) is recomputed in the backward;
* ``none`` -- nothing saved: the whole layer is recomputed;
* ``save_all`` -- everything saved, so no checkpoint at all.

The recomputation runs the same functions on the same inputs, so the
gradients are the uncheckpointed ones bit for bit.

A layer's params enter its region as the caller holds them; under a policy
with data bands (FSDP) the region gathers them first
(``sharding.gather_layer``), so one layer's params are whole at a time and
the backward's recomputation gathers them again.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("dots", "none", "save_all")
_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    unbatched = op in _SAVED or (op == torch.ops.aten.bmm.default and args[0].shape[0] == 1)
    return CheckpointPolicy.MUST_SAVE if unbatched else CheckpointPolicy.PREFER_RECOMPUTE


def layer_fn(fn, remat: bool, policy: str = "dots"):
    """``fn`` (one layer, its params the first argument) as it runs under
    ``remat`` and ``policy``: each call one checkpointed region
    (non-reentrant), or ``fn`` itself; the params as the installed policy
    reads them (``sharding.gather_layer``) inside it."""
    from repro_torch.distributed import sharding
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES}, got {policy!r}")
    inner = fn
    fn = lambda lp, *args: inner(sharding.gather_layer(lp), *args)
    if not remat or policy == "save_all":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)
