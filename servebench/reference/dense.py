"""The plain reference of the dense transformer family (codeqwen1.5-7b):
``common.forward`` with a SwiGLU feed-forward, ``w_down(silu(x w_gate) *
(x w_up))``, in float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from servebench.reference import common


def ffn(lw: dict, x: torch.Tensor, cfg: dict, rnd) -> torch.Tensor:
    m = lw["mlp"]
    h = F.silu(common.linear(m["w_gate"], x, rnd)) * common.linear(m["w_up"], x, rnd)
    return common.linear(m["w_down"], h, rnd)


def forward(weights, cfg, seqs, rows, precision="f32", q_block=256):
    return common.forward(weights, cfg, seqs, rows, ffn, precision, q_block)
