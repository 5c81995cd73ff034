"""Carry a param tree across from the JAX package, leaf by leaf.

``params_from_numpy`` takes the reference's param tree as nested dicts
(and lists: the MoE family's ``dense_layers``) of numpy arrays -- e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side -- and returns the
port's tree of tensors with the same keys:
uint8 codes stay uint8, f32 scales and biases stay f32, and every other
leaf (the embedding included) keeps its dtype. bfloat16 arrays (numpy's
``ml_dtypes`` extension type) become torch bfloat16 exactly.
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


def params_from_numpy(tree, device=None):
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return _tensor(node, device)

    return conv(tree)
