"""Expert-parallel MoE dispatch (the reference's ``repro/models/
moe_shardmap.py``, a ``shard_map`` there; explicit SPMD here).

Under a (data, model) mesh the tokens of a data shard are whole on every
model rank, and the experts are banded over ``model`` (E / m experts a
rank). So no token moves: each model rank routes every token (the router
is replicated), keeps the assignments to ITS experts, runs them (through
the grouped FP4 kernel under ``use_kernel``), and the combine is ONE
all-reduce SUM of the gate-weighted (T, d) outputs over ``model``. That
all-reduce is a partial sum by design: this is a training and lowering
surface, not the serving engine's path (the engine's MoE runs the
cascade-banded experts and gathers).

Capacity semantics are the reference's: each local expert keeps at most
``cap`` assignments, in token order; ``cap`` is computed from the data
shard's own token count.

Under cascade's spec the expert stacks are banded on their columns; the
dispatch re-bands them by experts first (``cascade.experts_by_e``, one
all-to-all a leaf, the resharding the reference's ``shard_map`` asks of
GSPMD for its ``P("model", ...)`` expert specs).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.models import layers as L
from repro_torch.models.moe import route


def ep_capacity(t_local: int, cfg: ArchConfig) -> int:
    """The reference's per-expert capacity for ``t_local`` tokens a shard."""
    return max(8, -(-math.ceil(cfg.moe_capacity_factor * t_local * cfg.moe_top_k
                               / cfg.n_experts) // 8) * 8)


def local_moe(xf: torch.Tensor, params: dict, cfg: ArchConfig, ccfg: CascadeConfig,
              rank: int, cap: int) -> torch.Tensor:
    """One model rank's share: xf (T, d) the shard's tokens; the expert
    leaves of ``params`` this rank's ``e_loc`` experts, which are experts
    ``rank * e_loc`` on of the global ones. Returns the (T, d) f32 partial
    output of the tokens' assignments to these experts."""
    t, d = xf.shape
    k = cfg.moe_top_k
    e_loc = params["wg"].get("codes", params["wg"].get("w")).shape[-3]
    gates, idx = route(params, xf, cfg)                       # global expert ids
    local_id = idx.reshape(-1) - rank * e_loc
    mine = (local_id >= 0) & (local_id < e_loc)
    local_id = torch.where(mine, local_id, torch.zeros_like(local_id))
    onehot = ((local_id[:, None] == torch.arange(e_loc, device=xf.device))
              & mine[:, None]).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1, local_id[:, None])[:, 0]
    keep = mine & (pos < cap)
    dst = torch.where(keep, local_id * cap + pos, torch.full_like(local_id, e_loc * cap))
    rows = onehot.sum(dim=0).clamp_(max=cap).to(torch.int32)

    xk = xf[:, None].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros((e_loc * cap + 1, d)).index_add_(0, dst, xk)[:-1].reshape(e_loc, cap, d)
    gate, up = cascade.expert_linear_pair_apply(params["wg"], params["wu"], buf, ccfg, rows)
    h = (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(buf.dtype)
    out = cascade.expert_linear_apply(params["wd"], h, ccfg, rows).reshape(e_loc * cap, d)

    got = torch.where(keep[:, None], out[torch.clamp(dst, max=e_loc * cap - 1)],
                      torch.zeros((), dtype=out.dtype, device=out.device))
    w = (got.to(torch.float32) * gates.reshape(-1)[:, None]).reshape(t, k, d)
    y = w[:, 0]
    for j in range(1, k):
        y = y + w[:, j]
    return y


def moe_ffn_apply_ep(params: dict, x: torch.Tensor, cfg: ArchConfig, ccfg: CascadeConfig,
                     mesh, model_axis: str = "model") -> torch.Tensor:
    """Expert-parallel MoE FFN. x (B, S, d): this data shard's tokens,
    whole on every model rank; the expert leaves of ``params``: this rank's
    band of the experts (E / m of them, ``E`` over ``model`` as megatron's
    spec places them), the router and the shared experts whole. Returns
    (B, S, d) in x's dtype, equal on every model rank."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    cap = ep_capacity(b * s, cfg)
    # a column-banded stack (cascade's spec) is re-banded by experts first
    params = dict(params, **{n: cascade.experts_by_e(params[n]) for n in ("wg", "wu", "wd")})
    with sharding.activation_policy(None):       # the local experts run as they are
        y = local_moe(xf, params, cfg, ccfg, mesh.coord(model_axis), cap)
    y = collectives.all_reduce(y, mesh.group(model_axis), "sum")
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], xf, "swiglu", ccfg).to(torch.float32)
    return y.reshape(b, s, d).to(x.dtype)
