"""The benchmark's yardstick for work: operations and bytes from the
configuration's shapes, and the chips' published peaks.

Model FLOPs count every matrix product a token needs: 2 x the matmul
parameters it passes through (for routed experts, only the ``moe_top_k``
it is routed to, and the router), plus causal attention over its context
(4 x heads x head_dim x context a layer: the scores and the weighted sum),
plus the head where logits are taken. Kernel costs count each input byte
read once and each output byte written once, at the rows the inputs need.
What differs by model family (which linears run on the dense kernel, the
experts' work) is in ``servebench/families/<family>.py``.
"""
from __future__ import annotations

from servebench import families

#: published dense peaks by ``torch.cuda.get_device_name()``: bf16 FLOP/s
#: (tensor cores, no sparsity) and HBM bytes/s (NVIDIA's H100 SXM data
#: sheet, at its 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}

BF16 = 2
F32 = 4


def attn_linears(cfg: dict) -> list:
    """(K, N, bias) of a layer's attention projections: q, k, v, o."""
    d, h, hk, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    b = bool(cfg.get("qkv_bias", False))
    return [(d, h * hd, b), (d, hk * hd, b), (d, hk * hd, b), (h * hd, d, False)]


def mlp_linears(cfg: dict) -> list:
    """(K, N, bias) of a dense layer's SwiGLU: gate, up, down."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return [(d, f, False), (d, f, False), (f, d, False)]


def dense_linears(cfg: dict) -> list:
    """The FP4 linears (K, N, bias) one token passes through in a layer on
    the dense matmul kernel, by its family."""
    return families.load(cfg["family"]).dense_linears(cfg)


def token_params(cfg: dict) -> int:
    """Matmul parameters one token passes through in every layer, the head
    left out, by its family."""
    return families.load(cfg["family"]).token_params(cfg)


def token_flops(cfg: dict, context: int) -> int:
    """FLOPs of one token at ``context`` keys (itself included), no head."""
    attn = 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * context
    return 2 * token_params(cfg) + attn


def head_flops(cfg: dict) -> int:
    return 2 * cfg["d_model"] * cfg["vocab"]


def chunk_flops(cfg: dict, p0: int, n: int) -> int:
    """An admission chunk: prompt rows p0 .. p0 + n - 1, the head on its
    last row."""
    keys = n * p0 + n * (n + 1) // 2                 # sum of the rows' contexts
    attn = 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * keys
    return 2 * token_params(cfg) * n + attn + head_flops(cfg)


def decode_flops(cfg: dict, contexts) -> int:
    """A decode step: one token a live slot, at its context, and the head."""
    return sum(token_flops(cfg, c) + head_flops(cfg) for c in contexts)


def fp4_linear_cost(m: int, k: int, n: int, bias: bool) -> tuple:
    """(FLOPs, bytes) of an FP4 matmul of m rows: the packed codes and the
    column scales read once, x in and y out in bf16."""
    return 2 * m * k * n, (k // 2) * n + F32 * n + BF16 * m * (k + n) + (F32 * n if bias else 0)


def cascade_matmul_costs(cfg: dict, m: int, head_rows: int) -> list:
    """(FLOPs, bytes) of each dense FP4 matmul launch of a step: every
    layer's over m rows, and the head over ``head_rows`` rows."""
    out = [fp4_linear_cost(m, k, n, b) for k, n, b in dense_linears(cfg)] * cfg["n_layers"]
    return out + [fp4_linear_cost(head_rows, cfg["d_model"], cfg["vocab"], False)]


def bound_s(costs, peaks: dict) -> float:
    """The least time of a list of launches: each at the larger of its
    operations at the bf16 peak and its bytes at the HBM bandwidth."""
    return sum(max(f / peaks["bf16_flops"], b / peaks["hbm_bytes"]) for f, b in costs)


def decode_attention_cost(cfg: dict, contexts) -> list:
    """(FLOPs, bytes) of each layer's decode attention over the live slots:
    every live key and value read once (bf16), q in (bf16), out (f32)."""
    h, hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = sum(4 * h * hd * c for c in contexts)
    nbytes = sum(2 * BF16 * hk * hd * c + BF16 * h * hd + F32 * h * hd for c in contexts)
    return [(flops, nbytes)] * cfg["n_layers"]

