"""The routed-expert family (olmoe-1b-7b): the dense family's attention, then
a router and ``moe_top_k`` of ``n_experts`` SwiGLU experts a token, the
experts on the grouped FP4 matmul kernel."""
import math

import torch

from servebench import flops
from servebench.families import dense

KERNELS = dense.KERNELS + ("cascade_matmul_grouped",)


def _router(v: torch.Tensor, meta, parent) -> torch.Tensor:
    return v / math.sqrt(meta.shape[-2])          # N(0, 1/d_model), f32


#: weight leaves beyond the common ones (``weights.py``): name -> (kind, a
#: flat draw of n values, what makes a leaf's cut of it its values)
LEAVES = {"router": ("router",
                     lambda gen, n, device: torch.randn((n,), generator=gen, device=device),
                     _router)}


def dense_linears(cfg: dict) -> list:
    """The FP4 linears one token passes through in a layer on the dense
    matmul kernel: attention only (the experts are grouped)."""
    return flops.attn_linears(cfg)


def token_params(cfg: dict) -> int:
    """Matmul parameters one token passes through, the head left out: the
    attention, the router and ``moe_top_k`` experts in every layer."""
    d, e, f = cfg["d_model"], cfg["n_experts"], cfg["moe_d_ff"]
    per_layer = sum(k * n for k, n, _ in dense_linears(cfg)) + d * e + cfg["moe_top_k"] * 3 * d * f
    return cfg["n_layers"] * per_layer


def experts_routed(cfg: dict, tokens: int) -> float:
    """Expected distinct experts ``tokens`` rows reach under uniform
    routing, ``moe_top_k`` distinct experts a row."""
    e, k = cfg["n_experts"], cfg["moe_top_k"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def grouped_matmul_cost(cfg: dict, tokens: int) -> list:
    """(FLOPs, bytes) of each layer's two grouped launches (gate and up
    together, then down) over ``tokens`` rows: the routed experts' codes
    and scales once, each routed row in and out (bf16)."""
    d, f, k = cfg["d_model"], cfg["moe_d_ff"], cfg["moe_top_k"]
    rows = tokens * k
    e = experts_routed(cfg, tokens)
    bf16, f32 = flops.BF16, flops.F32
    pair = (2 * 2 * rows * d * f, e * 2 * ((d // 2) * f + f32 * f) + bf16 * rows * (d + 2 * f))
    down = (2 * rows * f * d, e * ((f // 2) * d + f32 * d) + bf16 * rows * (f + d))
    return [pair, down] * cfg["n_layers"]
