"""Carry a param tree across from the JAX package, leaf by leaf.

``params_from_numpy`` takes the reference's param tree as nested dicts
(and lists: the MoE family's ``dense_layers``) of numpy arrays -- e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side -- and returns the
port's tree of tensors with the same keys:
uint8 codes stay uint8, f32 scales and biases stay f32, and every other
leaf (the embedding included) keeps its dtype. bfloat16 arrays (numpy's
``ml_dtypes`` extension type) become torch bfloat16 exactly.

One tree changes shape: Griffin's. The reference stacks its (R, R, A)
groups under ``groups`` (``{"b0", "b1", "b2"}``, each leaf with a leading
``n_groups`` axis) beside a ``tail`` list of R blocks; the port's
``GriffinLM`` holds one ``layers`` list in order, so the groups are
unstacked into it, group by group, and the tail follows as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # bf16 -> f32 -> bf16 is exact
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _unstack_groups(tree: dict) -> dict:
    """Griffin's ``groups``/``tail`` -> one ``layers`` list, in layer order."""
    groups = tree["groups"]
    blocks = sorted(groups, key=lambda name: int(name[1:]))           # b0, b1, b2, ...

    def take(node, g):
        if isinstance(node, dict):
            return {k: take(v, g) for k, v in node.items()}
        return np.asarray(node)[g]

    n_groups = np.asarray(groups[blocks[0]]["ln"]["scale"]).shape[0]
    layers = [take(groups[name], g) for g in range(n_groups) for name in blocks]
    out = {k: v for k, v in tree.items() if k not in ("groups", "tail")}
    out["layers"] = layers + list(tree["tail"])
    return out


def params_from_numpy(tree, device=None):
    device = resolve_device(device)
    if isinstance(tree, dict) and "groups" in tree and "tail" in tree:
        tree = _unstack_groups(tree)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return _tensor(node, device)

    return conv(tree)
