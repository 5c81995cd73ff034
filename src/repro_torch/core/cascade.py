"""CascadeLinear: the paper's FP4 linear layer as plain functions on tensors.

A linear layer's params are a dict in one of these formats:

* ``train`` / ``bf16`` -- ``{"w": (d_in, d_out)[, "b"]}`` dense weights in
  the compute dtype; in ``train`` mode with ``qat`` the forward multiplies
  the FP4 fake-quantized weight (paper Section 4), whose gradient is the
  straight-through identity; ``use_kernel`` sends the fake quantization to
  its CUDA kernel (``kernels.ops.fake_quant_fp4``);
* ``serve_fp4`` -- ``{"codes": (ceil(d_in/2), d_out) uint8, "scale": (G,
  d_out) f32[, "b"]}``: packed FP4 E2M1 codes + per-(group, column) scales,
  4 bits per weight in device memory. ``use_kernel`` sends the matmul to the
  CUDA kernel (``kernels.ops.cascade_matmul``); otherwise the weight is
  dequantized and multiplied in plain PyTorch.

``precision_sim`` (``serve_fp4`` only) runs the paper's bit-accurate
dataflow instead: FP4 activations under one absmax scale over all of x (so
the rows of a batch share it, as in the reference), the weights re-rounded
onto the FP4 grid per column, FP5 products summed down each column in FP8
(``quant.cascade_matmul_exact``; its CUDA kernel,
``kernels.ops.cascade_matmul_exact``, under ``use_kernel``), then both
scales and the bias.

Expert linears (the MoE family) carry a leading expert axis on every leaf,
``(E, ...)``; with ``use_kernel`` all E matmuls go through one grouped
launch (``kernels.ops.cascade_matmul_grouped``), two expert linears over
the same input (gate and up) through one launch for the pair
(:func:`expert_linear_pair_apply`), and QAT fake-quantizes the whole stack
in one launch, each expert with its own scales.

Under a mesh (an installed ``distributed.sharding.ActivationPolicy``) a
linear whose leaves are banded over ``model`` runs on its band, through the
same route as without one: a column band (cascade; megatron's column
modules) computes this rank's output columns and all-gathers them (or,
asked, leaves them to a consumer that works on its columns); a row band
(megatron's row modules) multiplies the matching band of the input's
features and all-reduces the f32 partial sums, then adds the bias. An
expert stack banded on N (cascade) gathers its columns; one banded on E
(megatron's expert parallelism) runs this rank's experts on their rows of
the buffer and gathers the experts. Under autograd a whole input that
feeds a band has its gradient summed over the model ranks
(``ActivationPolicy.band_input``), so a step on a mesh computes the
unsharded gradients. Under sequence parallelism (and serving ``fulldp``) a
block's output linear (:func:`out_apply`, inside ``sharding.rows_out``)
returns this rank's rows of the sequence (of the batch): a column band's
output by one all-to-all, a row band's partial sums by one reduce-scatter;
and under sequence parallelism a column-banded expert stack is
re-banded by experts (:func:`experts_by_e`, one all-to-all a leaf) so the
(E, C, d) buffer runs E over ``model``, as the reference's
``constrain_expert_buffer`` places it.

On the ``meta`` device :func:`linear_init` and :func:`expert_linear_init`
return :func:`linear_abstract`'s leaves without drawing or quantizing
anything (a full-width tree's shapes in a fraction of a second).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import quant
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Behavior of every CascadeLinear in a model."""
    mode: str = "train"            # train | serve_fp4 | bf16
    qat: bool = False              # fake-quant weights during training
    group_size: int = 0            # 0 => per-output-column scales
    use_kernel: bool = False       # CUDA kernels vs their plain versions
    precision_sim: bool = False    # bit-accurate FP8-accumulation path
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
    if _is_meta(device):
        return linear_abstract(d_in, d_out, cfg, use_bias)
    scale = scale if scale is not None else 1.0 / (d_in ** 0.5)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device) * scale
    bias = torch.zeros((d_out,), dtype=torch.float32, device=device) if use_bias else None
    return linear_from_dense(w, cfg, bias=bias)


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


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


def linear_abstract(d_in: int, d_out: int, cfg: CascadeConfig, use_bias: bool = False) -> dict:
    """The params :func:`linear_init` makes, as shape-and-dtype leaves on the
    ``meta`` device (no storage)."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    if cfg.mode == "serve_fp4":
        g = (d_in // cfg.group_size) if cfg.group_size > 0 else 1
        p = {"codes": meta((-(-d_in // 2), d_out), torch.uint8),
             "scale": meta((g, d_out), torch.float32)}
    else:
        p = {"w": meta((d_in, d_out), cfg.compute_dtype)}
    if use_bias:
        p["b"] = meta((d_out,), torch.float32)
    return p


def _fake_quant(w: torch.Tensor, cfg: CascadeConfig, experts: bool = False) -> torch.Tensor:
    """QAT's FP4 fake quantization, on the kernel route under ``use_kernel``."""
    if cfg.use_kernel:
        from repro_torch.kernels import ops
        return ops.fake_quant_fp4(w, cfg.group_size, experts=experts)
    return quant.fake_quant_fp4(w, cfg.group_size, experts)


def _precision_sim(params: dict, x: torch.Tensor, cfg: CascadeConfig) -> torch.Tensor:
    """The bit-accurate CASCADE path: FP4 activations (one scale over all of
    x), FP4 weights re-normalized per column, FP5 products, FP8 column sums;
    the scales applied at the column's end, then the bias."""
    w = quant.dequantize_weight(params["codes"], params["scale"], torch.float32)
    xs = x.abs().amax() / quant.FP4_MAX
    x4 = quant.fp4_decode(quant.fp4_encode(x / xs))
    ws = w.abs().amax(dim=0, keepdim=True) / quant.FP4_MAX
    ws = torch.where(ws > 0, ws, torch.ones_like(ws))
    w4 = quant.fp4_decode(quant.fp4_encode(w / ws))
    if cfg.use_kernel:
        from repro_torch.kernels import ops
        out = ops.cascade_matmul_exact(x4, w4)
    else:
        out = quant.cascade_matmul_exact(x4, w4)
    out = out * (xs * ws)
    b = params.get("b")
    if b is not None:
        out = out + b
    return out.to(cfg.compute_dtype)


def _linear_local(params: dict, x: torch.Tensor, cfg: CascadeConfig,
                  out_dtype=None) -> torch.Tensor:
    """y = x @ W (+ b) on the leaves as they are; f32 accumulation, output
    in ``out_dtype`` (default: the compute dtype)."""
    cd = cfg.compute_dtype
    od = cd if out_dtype is None else out_dtype
    b = params.get("b")
    if cfg.mode == "serve_fp4":
        if cfg.precision_sim:
            return _precision_sim(params, x, cfg).to(od)
        if cfg.use_kernel:
            # activations enter the matmul in the compute dtype, as on the
            # plain path (Mamba-2's gated norm hands over f32 after extend)
            from repro_torch.kernels import ops
            return ops.cascade_matmul(x.to(cd), params["codes"], params["scale"], b,
                                      out_dtype=od)
        w = quant.dequantize_weight(params["codes"], params["scale"], cd)
    else:
        w = params["w"]
        if cfg.qat and cfg.mode == "train":
            w = _fake_quant(w, cfg)
        w = w.to(cd)
    out = torch.matmul(x.to(cd).to(torch.float32), w.to(torch.float32))
    if b is not None:
        out = out + b
    return out.to(od)


def _policy_band(params: dict):
    """(policy, banded dim from the end) of a linear's weight under the
    installed mesh policy, or (None, None)."""
    pol = sharding.get_activation_policy()
    if pol is None:
        return None, None
    return pol, pol.band(params.get("codes", params.get("w")))


def banded(params: dict) -> Optional[int]:
    """The dim (-1: columns, -2: rows, -3: experts) on which a linear's
    weight is banded over ``model`` under the installed mesh policy, or
    None."""
    return _policy_band(params)[1]


def gather_columns(y: torch.Tensor) -> torch.Tensor:
    """Every model rank's columns of ``y`` (a column-banded linear's output
    left unjoined), joined."""
    return sharding.get_activation_policy().gather_model(y, -1)


def _row_band(pol, params: dict, x: torch.Tensor, cfg: CascadeConfig,
              rows: bool = False) -> torch.Tensor:
    """Megatron's row-parallel linear: this rank's rows of W times the
    matching features of x (x whole, or already this rank's band of them:
    the output of column-banded linears, unjoined), the f32 partial sums
    all-reduced (``rows``: reduce-scattered onto this rank's rows of the
    sequence), then the (replicated) bias."""
    fp4 = "codes" in params
    kb = params["codes"].shape[-2] * 2 if fp4 else params["w"].shape[-2]
    r = pol.model_rank
    local = {"codes": params["codes"], "scale": params["scale"]} if fp4 else {"w": params["w"]}
    if fp4 and params["scale"].shape[-2] > 1:                 # K-grouped scales: their band
        g = params["scale"].shape[-2] // pol.model_size
        local["scale"] = params["scale"][..., r * g:(r + 1) * g, :]
    xs = x if x.shape[-1] == kb else pol.band_input(x)[..., r * kb:(r + 1) * kb]  # or its band
    part = _linear_local(local, xs, cfg, out_dtype=torch.float32)
    if rows:
        out = C.reduce_scatter(pol.pad_rows(part), pol.mesh.group(pol.model_axis),
                               dim=pol.rows_dim)
    else:
        out = pol.sum_model(part)
    if params.get("b") is not None:
        out = out + params["b"]
    return out.to(cfg.compute_dtype)


def linear_apply(params: dict, x: torch.Tensor, cfg: CascadeConfig,
                 gather: bool = True) -> torch.Tensor:
    """y = x @ W (+ b) under the configured format; f32 accumulation, output
    in the compute dtype. Under a mesh policy a banded weight runs on its
    band (see the module docstring); ``gather=False`` leaves a column
    band's output as this rank's columns, for a consumer that works on
    them (an elementwise gate, attention on the rank's heads)."""
    pol, band = _policy_band(params)
    if band == -1:
        y = _linear_local(params, pol.band_input(x), cfg)
        return pol.gather_model(y, -1) if gather else y
    if band == -2:
        return _row_band(pol, params, x, cfg)
    return _linear_local(params, x, cfg)


def out_apply(params: dict, x: torch.Tensor, cfg: CascadeConfig) -> torch.Tensor:
    """A block's output linear: :func:`linear_apply`, but inside
    ``sharding.rows_out`` it hands back this rank's rows of x (B, S, K):
    (B, S/m, N) under sequence parallelism, (B/m, S, N) under serving
    ``fulldp`` (``ActivationPolicy.rows_dim``; the rows padded to a multiple
    of m): a column band's output by one all-to-all over ``model`` (no
    gather of the whole), a row band's f32 partial sums by one
    reduce-scatter, a whole weight's output by taking the rows."""
    if not sharding.rows_out_active():
        return linear_apply(params, x, cfg)
    pol, band = _policy_band(params)
    if band == -1:
        y = _linear_local(params, pol.band_input(x), cfg)
        return C.all_to_all(pol.pad_rows(y), pol.mesh.group(pol.model_axis),
                            split_dim=pol.rows_dim, cat_dim=-1)
    if band == -2:
        return _row_band(pol, params, x, cfg, rows=True)
    return pol.take_rows(_linear_local(params, x, cfg))


def experts_by_e(params: dict) -> dict:
    """An expert stack's leaves banded by experts over ``model``: a stack
    column-banded there (cascade) is re-banded by one all-to-all a leaf
    (this rank's E/m experts, every column); under autograd the gradients
    go back to the column bands. Leaves of any other band come back as
    they are."""
    pol, band = _policy_band(params)
    if band != -1:
        return params
    group = pol.mesh.group(pol.model_axis)
    out = {}
    for name, t in params.items():
        if pol.band(t) == -1:
            t = C.all_to_all(t, group, split_dim=-3, cat_dim=-1)
            pol._note_band(t, -3)
        out[name] = t
    return out


def _by_experts(pol, params: dict) -> bool:
    """Sequence parallelism's E-over-``model`` expert buffer: a column-banded
    stack of a multiple of 16 experts (the reference's rule) that the model
    axis divides."""
    e = params.get("codes", params.get("w")).shape[-3]
    return pol.act == "seqpar" and e % 16 == 0 and e % pol.model_size == 0


def expert_linear_init(gen: torch.Generator, n_experts: int, d_in: int, d_out: int,
                       cfg: CascadeConfig, device=None) -> dict:
    """Params of E expert linears, every leaf stacked (E, ...). Each expert
    is quantized as soon as it is drawn (``serve_fp4``), so a full-width
    model never holds its f32 experts."""
    if _is_meta(device):
        one = linear_abstract(d_in, d_out, cfg)
        return {k: torch.empty((n_experts,) + tuple(v.shape), dtype=v.dtype, device="meta")
                for k, v in one.items()}
    experts = [linear_init(gen, d_in, d_out, cfg, device=device) for _ in range(n_experts)]
    return {k: torch.stack([p[k] for p in experts]) for k in experts[0]}


def _expert_local(params: dict, x: torch.Tensor, cfg: CascadeConfig,
                  rows: torch.Tensor | None) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.mode == "serve_fp4":
        if cfg.use_kernel:
            from repro_torch.kernels import ops
            return ops.cascade_matmul_grouped(x.to(cd), params["codes"], params["scale"], rows,
                                              out_dtype=cd)
        w = quant.dequantize_stack(params["codes"], params["scale"], cd)
    else:
        w = params["w"]
        if cfg.qat and cfg.mode == "train":
            w = _fake_quant(w, cfg, experts=True)
        w = w.to(cd)
    return torch.matmul(x.to(cd).to(torch.float32), w.to(torch.float32)).to(cd)


def _expert_rows(pol, params: dict, x: torch.Tensor, rows):
    """This rank's experts' rows of the (E, C, d) buffer and of ``rows``,
    under megatron's expert parallelism (E banded over ``model``)."""
    el = params.get("codes", params.get("w")).shape[-3]
    e0 = pol.model_rank * el
    return pol.band_input(x)[e0:e0 + el], (None if rows is None else rows[e0:e0 + el])


def expert_linear_apply(params: dict, x: torch.Tensor, cfg: CascadeConfig,
                        rows: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, d_in) -> (E, C, d_out), expert e with its own weight; f32
    accumulation, output in the compute dtype. ``rows`` (E,) int32, the
    routed rows of each expert (the rest of its C rows are zero inputs),
    lets the grouped kernel skip what is not routed; None means all C.
    Under a mesh policy a banded stack runs on its band."""
    pol, band = _policy_band(params)
    if band == -1 and _by_experts(pol, params):
        params, band = experts_by_e(params), -3
    if band == -1:
        return pol.gather_model(_expert_local(params, pol.band_input(x), cfg, rows), -1)
    if band == -3:
        xs, rs = _expert_rows(pol, params, x, rows)
        return pol.gather_model(_expert_local(params, xs, cfg, rs), 0)
    return _expert_local(params, x, cfg, rows)


def expert_linear_pair_apply(first: dict, second: dict, x: torch.Tensor, cfg: CascadeConfig,
                             rows: torch.Tensor | None = None) -> tuple:
    """:func:`expert_linear_apply` of two expert linears of one shape over
    the same x (the MoE layer's gate and up): in ``serve_fp4`` with
    ``use_kernel``, one grouped launch for both; otherwise two calls. Each
    output has the bits its own call gives it."""
    if not (cfg.mode == "serve_fp4" and cfg.use_kernel):
        return (expert_linear_apply(first, x, cfg, rows),
                expert_linear_apply(second, x, cfg, rows))
    from repro_torch.kernels import ops
    pol, band = _policy_band(first)
    if band == -1 and _by_experts(pol, first):
        first, second, band = experts_by_e(first), experts_by_e(second), -3
    if band == -3:
        xs, rs = _expert_rows(pol, first, x, rows)
    else:
        xs, rs = (x, rows) if band is None else (pol.band_input(x), rows)
    pair = ops.cascade_matmul_grouped_pair(
        xs.to(cfg.compute_dtype), (first["codes"], first["scale"]),
        (second["codes"], second["scale"]), rs, out_dtype=cfg.compute_dtype)
    if band is None:
        return pair
    return tuple(pol.gather_model(y, -1 if band == -1 else 0) for y in pair)


def linear_weight(params: dict, cfg: CascadeConfig) -> torch.Tensor:
    """Dense (d_in, d_out) weight of a linear in the compute dtype (MLA's
    absorbed decode reads the raw matrix). Under a mesh policy a banded
    weight's bands are all-gathered into the whole matrix."""
    if cfg.mode == "serve_fp4":
        w = quant.dequantize_weight(params["codes"], params["scale"], cfg.compute_dtype)
    else:
        w = params["w"].to(cfg.compute_dtype)
    pol, band = _policy_band(params)
    return w if band is None else pol.gather_model(w, band)


def tree_to_serve_fp4(params, cfg: CascadeConfig):
    """Convert a dense param tree into the FP4 serving format: every
    ``{"w"[, "b"]}`` linear dict becomes ``{"codes", "scale"[, "b"]}``.
    Stacked layers (L, K, N) and stacked experts (L, E, K, N) are quantized
    matrix by matrix. Embeddings, norms and routers stay dense."""
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
        if isinstance(d, list):
            return [conv(v) for v in d]
        return d

    return conv(params)


def num_weight_bytes(params) -> int:
    """Device bytes of the weight payload: every tensor leaf at its storage
    dtype (a serve_fp4 tree counts one byte per packed code pair plus its
    scales)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return sum(num_weight_bytes(v)
               for v in (params.values() if isinstance(params, dict) else params))
