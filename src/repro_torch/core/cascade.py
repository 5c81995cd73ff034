"""CascadeLinear: the paper's FP4 linear layer as plain functions on tensors.

A linear layer's params are a dict in one of these formats:

* ``train`` / ``bf16`` -- ``{"w": (d_in, d_out)[, "b"]}`` dense weights in
  the compute dtype;
* ``serve_fp4`` -- ``{"codes": (ceil(d_in/2), d_out) uint8, "scale": (G,
  d_out) f32[, "b"]}``: packed FP4 E2M1 codes + per-(group, column) scales,
  4 bits per weight in device memory. ``use_kernel`` sends the matmul to the
  CUDA kernel (``kernels.ops.cascade_matmul``); otherwise the weight is
  dequantized and multiplied in plain PyTorch.

Not ported yet: QAT fake-quant, the bit-accurate FP8 ``precision_sim``
path, expert (MoE) linears and the mesh sharding hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import quant


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Behavior of every CascadeLinear in a model."""
    mode: str = "train"            # train | serve_fp4 | bf16
    group_size: int = 0            # 0 => per-output-column scales
    use_kernel: bool = False       # CUDA FP4 kernel vs dequant + matmul
    compute_dtype: Any = torch.bfloat16
    kv_dtype: Any = None           # KV cache dtype; None = follow compute_dtype

    @property
    def resolved_kv_dtype(self):
        """Storage dtype for KV caches (stacked slot grids included)."""
        return self.kv_dtype if self.kv_dtype is not None else self.compute_dtype


def linear_init(gen: torch.Generator, d_in: int, d_out: int, cfg: CascadeConfig,
                use_bias: bool = False, scale: Optional[float] = None,
                device=None) -> dict:
    """Params for one linear layer in the configured format. In ``serve_fp4``
    mode the matrix is quantized as soon as it is drawn, so a full-width
    model never holds its dense f32 weights all at once."""
    scale = scale if scale is not None else 1.0 / (d_in ** 0.5)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device) * scale
    bias = torch.zeros((d_out,), dtype=torch.float32, device=device) if use_bias else None
    return linear_from_dense(w, cfg, bias=bias)


def linear_from_dense(w: torch.Tensor, cfg: CascadeConfig,
                      bias: Optional[torch.Tensor] = None) -> dict:
    """Convert a dense (d_in, d_out) weight into the configured param format."""
    if cfg.mode == "serve_fp4":
        packed, scales = quant.quantize_weight(w, cfg.group_size)
        p = {"codes": packed, "scale": scales}
    else:
        p = {"w": w.to(cfg.compute_dtype)}
    if bias is not None:
        p["b"] = bias.to(torch.float32)
    return p


def linear_apply(params: dict, x: torch.Tensor, cfg: CascadeConfig) -> torch.Tensor:
    """y = x @ W (+ b) under the configured format; f32 accumulation, output
    in the compute dtype."""
    cd = cfg.compute_dtype
    b = params.get("b")
    if cfg.mode == "serve_fp4":
        if cfg.use_kernel:
            # activations enter the matmul in the compute dtype, as on the
            # plain path (Mamba-2's gated norm hands over f32 after extend)
            from repro_torch.kernels import ops
            return ops.cascade_matmul(x.to(cd), params["codes"], params["scale"], b,
                                      out_dtype=cd)
        w = quant.dequantize_weight(params["codes"], params["scale"], cd)
    else:
        w = params["w"].to(cd)
    out = torch.matmul(x.to(cd).to(torch.float32), w.to(torch.float32))
    if b is not None:
        out = out + b
    return out.to(cd)


def tree_to_serve_fp4(params, cfg: CascadeConfig):
    """Convert a dense param tree into the FP4 serving format: every
    ``{"w"[, "b"]}`` linear dict becomes ``{"codes", "scale"[, "b"]}``.
    Stacked layers (L, K, N) are quantized matrix by matrix. Embeddings and
    norms stay dense."""
    def quantize(w: torch.Tensor):
        if w.dim() == 2:
            return quant.quantize_weight(w.to(torch.float32), cfg.group_size)
        parts = [quantize(wi) for wi in w]
        return (torch.stack([c for c, _ in parts]), torch.stack([s for _, s in parts]))

    def conv(d):
        if isinstance(d, dict) and isinstance(d.get("w"), torch.Tensor):
            codes, scale = quantize(d["w"])
            out = {"codes": codes, "scale": scale}
            if "b" in d:
                out["b"] = d["b"]
            return out
        if isinstance(d, dict):
            return {k: conv(v) for k, v in d.items()}
        return d

    return conv(params)


def num_weight_bytes(params) -> int:
    """Device bytes of the weight payload: every tensor leaf at its storage
    dtype (a serve_fp4 tree counts one byte per packed code pair plus its
    scales)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return sum(num_weight_bytes(v) for v in params.values())
