"""Error-feedback int8 gradient compression (the reference's
``repro/optim/grad_compression.py``): ``g + residual`` to int8 codes under
one absmax scale, the rounding error carried to the next step. The codes,
the scale and the residual are the reference's bit for bit (both round
half to even).

Not ported yet: ``allreduce_compressed``, which sums the codes across the
data-parallel devices inside a ``shard_map`` (``psum``/``pmax``); it waits
for the multi-device slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + residual -> (int8 codes, f32 scale, new residual)."""
    gf = g.to(torch.float32) + residual
    scale = gf.abs().amax() / torch.full((), 127.0, device=gf.device) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_residuals(grads_like: Any) -> Any:
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                      grads_like)
