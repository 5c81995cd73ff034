"""Error-feedback int8 gradient compression (the reference's
``repro/optim/grad_compression.py``): ``g + residual`` to int8 codes under
one absmax scale, the rounding error carried to the next step. The codes,
the scale and the residual are the reference's bit for bit (both round
half to even).

``allreduce_compressed`` sums the codes across the ranks of a process
group, in the reference's order of operations: a MAX of the ranks' scales
(the shared scale), the codes under it, an int32 SUM of the codes, then
``summed * scale / n``. Its collectives go through
``distributed/collectives.py`` (one MAX and one SUM a leaf), where the
reference's ``pmax``/``psum`` run inside a ``shard_map``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.distributed import collectives


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


def compressed_sum(g: torch.Tensor, residual: torch.Tensor, group
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf over the ranks of ``group``: (the int32 SUM of the ranks'
    int8 codes, the shared scale -- the MAX of the ranks' --, this rank's
    new f32 residual)."""
    gf = g.to(torch.float32) + residual
    scale = gf.abs().amax() / torch.full((), 127.0, device=gf.device) + 1e-12
    scale = collectives.all_reduce(scale, group, "max")
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    new_r = gf - q * scale                                      # error feedback
    return collectives.all_reduce(q.to(torch.int32), group, "sum"), scale, new_r


def allreduce_compressed(grads: Any, residuals: Any, group) -> Tuple[Any, Any]:
    """The int8-compressed mean of ``grads`` over the ranks of ``group``:
    returns (mean gradients in each leaf's dtype, new f32 residuals). The
    codes are summed in int32 (no overflow below 2^23 ranks) under the MAX
    of the ranks' scales, so the wire format stays one byte a weight."""
    n = dist.get_world_size(group)

    def one(g, r):
        summed, scale, new_r = compressed_sum(g, r, group)
        return (summed.to(torch.float32) * scale / n).to(g.dtype), new_r

    out = [one(g, r) for g, r in zip(T.leaves(grads), T.leaves(residuals))]
    return (T.unflatten_like(grads, [o[0] for o in out]),
            T.unflatten_like(grads, [o[1] for o in out]))


def init_residuals(grads_like: Any) -> Any:
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                      grads_like)
