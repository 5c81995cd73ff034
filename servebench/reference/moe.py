"""The plain reference of the routed-expert family (olmoe-1b-7b):
``common.forward`` with the OLMoE feed-forward as the port computes it. Each
token's router logits ``x @ router`` (f32) go through a softmax over the
experts; its top ``moe_top_k`` experts each apply a SwiGLU of their own, and
the outputs are summed weighted by the softmax probabilities (renormalised
over the chosen experts only where ``moe_renorm`` says so; OLMoE does not).
No capacity and no dropped token: serving routes drop-free."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from servebench.reference import common


def ffn(lw: dict, x: torch.Tensor, cfg: dict, rnd) -> torch.Tensor:
    m = lw["moe"]
    probs = torch.softmax(rnd(x) @ m["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg["moe_top_k"], dim=-1)
    if cfg["moe_renorm"]:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x[tok]
        one = lambda name: {"w": m[name]["w"][e]}
        h = F.silu(common.linear(one("wg"), h, rnd)) * common.linear(one("wu"), h, rnd)
        y.index_add_(0, tok, common.linear(one("wd"), h, rnd) * gates[tok, slot][:, None])
    return y


def forward(weights, cfg, seqs, rows, precision="f32", q_block=256):
    return common.forward(weights, cfg, seqs, rows, ffn, precision, q_block)
