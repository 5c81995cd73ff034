"""Top-K weight sparsification (paper Section 10.13), in PyTorch.

ZettaLith exploits 90-95% weight sparsity after Top-K sparsification to cut
power (zero weights still take a cycle). Magnitude Top-K per output column,
the paper's per-column dataflow, after the JAX package's
``core/sparsity.py``.

Ties: like the reference, the mask keeps every weight whose magnitude is
at least the ``keep``-th largest, found by a sort, not by a top-k's indices
(where ``torch.topk`` and ``lax.top_k`` would break ties differently). A
weight tied with that threshold is kept with all its equals, so a column may
keep more than ``keep`` weights; the mask is a function of the values alone
and equals the reference's on ties too.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk_sparsify(w: torch.Tensor, density: float,
                  per_column: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``density`` fraction of weights by magnitude.

    Returns (sparsified weights, boolean keep-mask). ``per_column=True``
    ranks within each output column (axis 0 = contraction dim), the CASCADE
    column granularity."""
    if density >= 1.0:
        return w, torch.ones_like(w, dtype=torch.bool)
    k_dim = w.shape[0]
    keep = max(1, int(round(density * k_dim)))
    mag = w.abs()
    if per_column:
        thresh = torch.sort(mag, dim=0).values[k_dim - keep]     # keep-th largest per column
        mask = mag >= thresh[None, :]
    else:
        flat = mag.reshape(-1)
        keep_n = max(1, int(round(density * flat.shape[0])))
        thresh = torch.sort(flat).values[flat.shape[0] - keep_n]
        mask = mag >= thresh
    return torch.where(mask, w, torch.zeros_like(w)), mask


def sparsity_stats(w: torch.Tensor) -> dict:
    """Zero count, sparsity and the activity factor, in f32 as the reference
    computes them."""
    total = w.numel()
    zeros = int((w == 0).sum())
    s = torch.tensor(zeros, dtype=torch.float32) / total
    return {
        "total": total,
        "zeros": zeros,
        "sparsity": float(s),
        # paper Table 5: zero weights toggle fewer nodes, so the activity
        # factor drops from 0.10 to 0.04 for them; the average at sparsity s
        "activity_factor": float(0.10 * (1 - s) + 0.04 * s),
    }
