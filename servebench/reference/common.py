"""The plain reference's shared parts: plain PyTorch in float32.

It reads the benchmark's weights (packed E2M1 codes and their scales, the
embedding, norms and routers) and works out everything else again: the
codes are decoded through its own table of the 16 E2M1 values, one layer at
a time, and every product, norm, rotation and softmax runs in float32 over
the whole sequence, with no kernel, no cache and no batching across
sequences. It follows the port's layer equations (``models/layers.py``):
RMSNorm with eps 1e-6, rotate-half RoPE over the whole head, causal softmax
attention at 1/sqrt(head_dim), a SwiGLU or routed-expert FFN, a final norm
and an untied head.

``precision="fp8"`` is the control: the same forward with every matmul
input and every query, key and value rounded to float8 e4m3 (one scale a
row, its absmax at 448), the step below the bfloat16 the configurations
serve in.
"""
from __future__ import annotations

import math
from typing import Callable, List

import torch

#: the 16 E2M1 values by code: sign bit 3, exponent bits 2-1, mantissa bit 0
E2M1 = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
        -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
FP8_MAX = 448.0


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Packed codes (..., K/2, N) (low nibble: the even row) and scales
    (..., G, N) -> the f32 weight (..., K, N)."""
    table = torch.tensor(E2M1, dtype=torch.float32, device=codes.device)
    pair = torch.stack([codes & 0xF, codes >> 4], dim=-2)            # (..., K/2, 2, N)
    k = 2 * codes.shape[-2]
    vals = table[pair.long()].reshape(*codes.shape[:-2], k, codes.shape[-1])
    g = scale.shape[-2]
    vals = vals.reshape(*codes.shape[:-2], g, k // g, codes.shape[-1]) * scale[..., :, None, :]
    return vals.reshape(*codes.shape[:-2], k, codes.shape[-1])


def rounder(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Identity for ``f32``; for ``fp8``, each row rounded to e4m3 under its
    own absmax scale."""
    if precision == "f32":
        return lambda x: x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")

    def fp8(x: torch.Tensor) -> torch.Tensor:
        s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return fp8


def decode_tree(tree):
    """A layer's weights with every packed linear ``{"codes", "scale"[,
    "b"]}`` decoded to ``{"w"[, "b"]}`` (f32), the rest as they are."""
    if not isinstance(tree, dict):
        return tree
    if "codes" in tree:
        out = {"w": decode(tree["codes"], tree["scale"])}
        if "b" in tree:
            out["b"] = tree["b"]
        return out
    return {k: decode_tree(v) for k, v in tree.items()}


def linear(p: dict, x: torch.Tensor, rnd) -> torch.Tensor:
    y = rnd(x) @ p["w"]
    return y + p["b"] if "b" in p else y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1: the first and second halves of
    each head rotated together (rotate-half)."""
    s, _, d = x.shape
    inv = 1.0 / torch.pow(float(theta), torch.arange(0, d, 2, dtype=torch.float32,
                                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv   # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(lw: dict, x: torch.Tensor, cfg: dict, rnd, q_block: int) -> torch.Tensor:
    """Causal self-attention of one sequence x (S, d): queries in blocks of
    ``q_block`` rows, each over the keys up to its last row."""
    s = x.shape[0]
    h, hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rnd(rope(linear(lw["wq"], x, rnd).reshape(s, h, hd), cfg["rope_theta"]))
    k = rnd(rope(linear(lw["wk"], x, rnd).reshape(s, hk, hd), cfg["rope_theta"]))
    v = rnd(linear(lw["wv"], x, rnd).reshape(s, hk, hd))
    g = h // hk
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)                  # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    for i0 in range(0, s, q_block):
        i1 = min(s, i0 + q_block)
        scores = (q[:, i0:i1] @ k[:, :i1].transpose(1, 2)) / math.sqrt(hd)   # (H, n, i1)
        rows = torch.arange(i0, i1, device=x.device)[:, None]
        cols = torch.arange(i1, device=x.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out[:, i0:i1] = torch.softmax(scores, dim=-1) @ v[:, :i1]
    return linear(lw["wo"], out.transpose(0, 1).reshape(s, h * hd), rnd)


def layer_weights(tree, i: int) -> dict:
    """Layer i's views of a stacked (L, ...) tree."""
    if isinstance(tree, dict):
        return {k: layer_weights(v, i) for k, v in tree.items()}
    return tree[i]


def forward(weights: dict, cfg: dict, seqs: List[torch.Tensor], rows: List[torch.Tensor],
            ffn: Callable, precision: str = "f32", q_block: int = 256) -> List[torch.Tensor]:
    """Logits (len(rows[i]), V) f32 at the given rows of each token
    sequence, layer by layer over all sequences at once. ``ffn(lw, x, cfg,
    rnd)`` is the family's feed-forward on the layer's normed rows."""
    rnd = rounder(precision)
    table = weights["embed"]["table"]
    xs = [table[s.long()].to(torch.float32) for s in seqs]
    sizes = [x.shape[0] for x in xs]
    n_layers = cfg["n_layers"]
    for i in range(n_layers):
        lw = decode_tree(layer_weights(weights["layers"], i))
        xs = [x + attention(lw["attn"], rmsnorm(x, lw["ln1"]["scale"]), cfg, rnd, q_block)
              for x in xs]
        x = torch.cat(xs)
        x = x + ffn(lw, rmsnorm(x, lw["ln2"]["scale"]), cfg, rnd)
        xs = list(torch.split(x, sizes))
    head = decode(weights["lm_head"]["codes"], weights["lm_head"]["scale"])
    return [rnd(rmsnorm(x[r.long()], weights["final_norm"]["scale"])) @ head
            for x, r in zip(xs, rows)]
