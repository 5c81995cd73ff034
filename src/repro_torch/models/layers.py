"""Shared neural-net layers of the dense transformer family, in PyTorch.

Functional style, as in the JAX package: ``*_init(gen, ...) -> params`` and
``*_apply(params, x, ...)`` on plain dicts of tensors. Every dense
projection goes through :mod:`repro_torch.core.cascade`.

Caches are updated IN PLACE: a decode or extend step writes its K/V rows
into the cache tensors it is given (views of the engine's stacked cache)
and advances their ``pos`` in place, where the JAX package returns new
arrays. Not ported yet: the windowed ring buffer, M-RoPE, explicit
position inputs and the paged pool (ROADMAP Queue 1 items 4 and 8).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.kernels.norm import add_norm_plain, gated_norm_plain, norm_plain

#: the masked-logit value of the reference (not -inf: a row with no live
#: key then averages uniformly instead of producing NaN)
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, norm_type: str = "rmsnorm", device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(params: dict, x: torch.Tensor, norm_type: str = "rmsnorm",
               eps: float = 1e-6, *, use_kernel: bool = False) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in f32, out in x's dtype.

    ``use_kernel`` sends it to ``ops.norm`` (the CUDA kernel on the card: one
    launch, one fixed order of each row's sum). Without it (as on the
    ``fused=False`` serving path) the norm runs as eager PyTorch ops, whose
    reduction on the card sums a row in an order set by the number of rows,
    so a row may round otherwise in a call over B * s rows (a verify pass)
    than over B rows (a decode step)."""
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.norm(x, params["scale"], params.get("bias"), norm_type=norm_type, eps=eps)
    return norm_plain(x, params["scale"], params.get("bias"), norm_type, eps)


def add_norm_apply(params: dict, x: torch.Tensor, r: torch.Tensor, norm_type: str = "rmsnorm",
                   eps: float = 1e-6, *, use_kernel: bool = False):
    """The residual add and the norm after it: ``(norm_apply(x + r), x + r)``,
    the second the new residual stream. ``use_kernel`` sends it to
    ``ops.add_norm`` (one launch of the norm kernel on the card); without
    it, the eager add and :func:`norm_apply`'s plain route."""
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.add_norm(x, r, params["scale"], params.get("bias"), norm_type=norm_type,
                            eps=eps)
    return add_norm_plain(x, r, params["scale"], params.get("bias"), norm_type, eps)


def gated_norm_apply(params: dict, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-6, *,
                     use_kernel: bool = False) -> torch.Tensor:
    """Mamba-2's gated RMSNorm: ``norm_apply((y * silu(z.f32)).to(y.dtype))``.
    ``use_kernel`` sends it to ``ops.gated_norm`` (one launch of the norm
    kernel on the card, z read in place through its row stride); without
    it, the eager gate and :func:`norm_apply`'s plain route."""
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.gated_norm(y, z, params["scale"], eps=eps)
    return gated_norm_plain(y, z, params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# RoPE (incl. partial rotary)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0, device=None) -> torch.Tensor:
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    # a Python-scalar base: no host-to-device copy (which would sync the stream)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S). Rotates the first
    2*len(inv_freq) channels, passes the rest through (partial rotary)."""
    rot2 = inv_freq.shape[0]
    ang = positions[..., None].to(torch.float32) * inv_freq       # (B, S, r/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., : 2 * rot2], x[..., 2 * rot2:]
    x1, x2 = x_rot[..., :rot2], x_rot[..., rot2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# per-slot cache primitives (continuous batching)
# ---------------------------------------------------------------------------

def update_rows(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """In place, write ``new[i]`` into ``buf[i]`` from row ``idx[i]`` on.

    buf: (B, T, ...); new: (B, s, ...); idx: (B,). The start is clamped
    into [0, T - s] exactly as the reference's ``dynamic_update_slice``
    clamps it, so an idle slot whose position has run past T rewrites its
    last rows instead of writing outside the cache.
    """
    b, s = new.shape[:2]
    t = buf.shape[1]
    start = idx.to(torch.int64).clamp(0, t - s)
    rows = start[:, None] + torch.arange(s, device=buf.device)
    buf[torch.arange(b, device=buf.device)[:, None], rows] = new.to(buf.dtype)


# ---------------------------------------------------------------------------
# attention (GQA / MHA), full-seq and cached paths
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    q_chunk: int = 0             # chunked attention for long prefill (0 = off)


def attn_init(gen: torch.Generator, cfg: AttnConfig, ccfg: CascadeConfig, device=None) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lin = lambda din, dout, bias: cascade.linear_init(gen, din, dout, ccfg, use_bias=bias,
                                                      device=device)
    return {
        "wq": lin(d, h * hd, cfg.qkv_bias),
        "wk": lin(d, hk * hd, cfg.qkv_bias),
        "wv": lin(d, hk * hd, cfg.qkv_bias),
        "wo": lin(h * hd, d, False),
    }


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,H,D), k/v: (B,T,Hkv,D), mask: (S, T) bool or None."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    qf = q.to(torch.float32).reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qf, k.to(torch.float32)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return o.reshape(b, s, h, dv)


def _chunked_causal_sdpa(q, k, v, scale, q_chunk):
    """Causal attention over query chunks of ``q_chunk`` rows: memory
    O(q_chunk * T) instead of O(S * T), for long prefill."""
    b, s, h, d = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    cols = torch.arange(t, device=q.device)
    outs = []
    for i in range(s // q_chunk):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk].to(torch.float32)
        qi = qi.reshape(b, q_chunk, hkv, h // hkv, d)
        logits = torch.einsum("bshgd,bthd->bhgst", qi, kf) * scale
        rows = i * q_chunk + torch.arange(q_chunk, device=q.device)
        m = rows[:, None] >= cols[None, :]
        logits = logits.masked_fill(~m, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhgst,bthd->bshgd", p, vf).reshape(b, q_chunk, h, vf.shape[-1]))
    return torch.cat(outs, dim=1)


def attn_apply(
    params: dict,
    x: torch.Tensor,
    cfg: AttnConfig,
    ccfg: CascadeConfig,
    cache: dict | None = None,
    mode: str = "full",
    max_len: int | None = None,
    n_valid=None,
    kv_len: int | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Attention with four modes:

    * ``full``    -- causal self-attention, no cache.
    * ``prefill`` -- as ``full``, and also returns a decode-ready KV cache.
    * ``decode``  -- one new token (s == 1) against the cache.
    * ``extend``  -- append s tokens at each row's position (chunked prefill
                     into an existing cache). Only the first ``n_valid``
                     chunk tokens are real; the pad K/V lands above the
                     valid region (mask-invalid, overwritten later).

    In ``decode``/``extend`` the cache dict ``{"k", "v": (B, T, Hkv, D),
    "pos": (B,)}`` is updated in place and returned. With
    ``ccfg.use_kernel`` decode attention goes through ``ops.decode_attention``
    (given each row's position, not a mask) and every multi-token attention
    (extend, full, prefill) through ``ops.flash_attention``. ``kv_len``, a
    host-side bound on the keys any row of an extend chunk sees (the largest
    row position plus s), hands the kernel only that prefix of the cache, so
    its launch plan (the split over the keys) follows the live keys and not
    the allocated length.
    """
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    q = cascade.linear_apply(params["wq"], x, ccfg).reshape(b, s, h, hd)
    k = cascade.linear_apply(params["wk"], x, ccfg).reshape(b, s, hk, hd)
    v = cascade.linear_apply(params["wv"], x, ccfg).reshape(b, s, hk, hd)

    steps = torch.arange(s, dtype=torch.int32, device=dev)
    if cache is not None:
        positions = cache["pos"][:, None] + steps[None, :]
    else:
        positions = steps[None, :].expand(b, s)

    inv = rope_freqs(hd, cfg.rope_theta, cfg.rope_fraction, device=dev)
    q = apply_rope(q, positions, inv)
    k = apply_rope(k, positions, inv)

    scale = 1.0 / (hd ** 0.5)

    if mode in ("decode", "extend"):
        if cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        if mode == "decode" and s != 1:
            raise ValueError("decode takes one token per row")
        pos = cache["pos"]                               # (B,) next write index
        update_rows(cache["k"], k, pos)
        update_rows(cache["v"], v, pos)
        att_k, att_v = cache["k"], cache["v"]
        if ccfg.use_kernel and mode == "extend":
            # the chunk's queries sit at each row's position: the causal
            # mask offset by pos is the ``valid`` mask of the plain path
            from repro_torch.kernels import ops
            live = att_k.shape[1] if kv_len is None else min(int(kv_len), att_k.shape[1])
            o = ops.flash_attention(q.transpose(1, 2), att_k[:, :live].transpose(1, 2),
                                    att_v[:, :live].transpose(1, 2), scale=scale,
                                    q_offset=pos).transpose(1, 2)
        elif ccfg.use_kernel:
            # key t is live iff t <= pos: the kernel reads no cache row past
            # the slot's position, and no mask is built
            from repro_torch.kernels import ops
            o = ops.decode_attention(q[:, 0], att_k, att_v, q_pos=pos,
                                     scale=scale).reshape(b, s, h, hd)
        else:
            t = att_k.shape[1]
            rows = pos[:, None] + steps[None, :]             # (B, s)
            valid = torch.arange(t, device=dev)[None, None, :] <= rows[:, :, None]  # (B, s, T)
            qd = q.to(torch.float32).reshape(b, s, hk, h // hk, hd)
            logits = torch.einsum("bshgd,bthd->bhgst", qd,
                                  att_k.to(torch.float32)) * scale
            logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
            p = torch.softmax(logits, dim=-1)
            o = torch.einsum("bhgst,bthd->bshgd", p,
                             att_v.to(torch.float32)).reshape(b, s, h, hd)
        nv = s if n_valid is None else n_valid
        cache["pos"].add_(nv if isinstance(nv, torch.Tensor) else int(nv))
        new_cache = cache
    else:
        if ccfg.use_kernel:
            from repro_torch.kernels import ops
            o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    scale=scale).transpose(1, 2)
        elif cfg.q_chunk > 0 and s > cfg.q_chunk:
            o = _chunked_causal_sdpa(q, k, v, scale, cfg.q_chunk)
        else:
            r = torch.arange(s, device=dev)
            o = _sdpa(q, k, v, r[:, None] >= r[None, :], scale)
        new_cache = None
        if mode == "prefill":
            new_cache = _build_cache_from_prefill(k, v, s, max_len=max_len,
                                                  dtype=ccfg.resolved_kv_dtype)

    out = cascade.linear_apply(params["wo"], o.to(x.dtype).reshape(b, s, h * hd), ccfg)
    return out, new_cache


def _build_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, s: int,
                              max_len: int | None = None, dtype=None) -> dict:
    """Decode-ready cache from prefill K/V (positions 0..s-1, every row at s)."""
    b = k.shape[0]
    if dtype is not None:
        k, v = k.to(dtype), v.to(dtype)
    t = max_len if max_len is not None else s
    pad = (0, 0, 0, 0, 0, t - s)
    return {"k": F.pad(k, pad), "v": F.pad(v, pad),
            "pos": torch.full((b,), s, dtype=torch.int32, device=k.device)}


def attn_cache_init(batch: int, max_len: int, cfg: AttnConfig, dtype=torch.bfloat16,
                    device=None) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str, ccfg: CascadeConfig,
             device=None) -> dict:
    lin = lambda din, dout: cascade.linear_init(gen, din, dout, ccfg, device=device)
    if kind in ("swiglu", "geglu"):
        return {"w_gate": lin(d, d_ff), "w_up": lin(d, d_ff), "w_down": lin(d_ff, d)}
    # relu2 (nemotron squared-ReLU) / gelu (musicgen)
    return {"w_up": lin(d, d_ff), "w_down": lin(d_ff, d)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def mlp_apply(params: dict, x: torch.Tensor, kind: str, ccfg: CascadeConfig) -> torch.Tensor:
    lin = lambda name, a: cascade.linear_apply(params[name], a, ccfg)
    if kind == "swiglu":
        hid = F.silu(lin("w_gate", x)) * lin("w_up", x)
    elif kind == "geglu":
        hid = _gelu(lin("w_gate", x)) * lin("w_up", x)
    elif kind == "relu2":
        hid = torch.square(F.relu(lin("w_up", x)))
    elif kind == "gelu":
        hid = _gelu(lin("w_up", x))
    else:
        raise ValueError(kind)
    return lin("w_down", hid)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16,
               device=None) -> dict:
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device) * 0.02
    return {"table": table.to(dtype)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def tied_head(params: dict, x: torch.Tensor, compute_dtype,
              per_token: bool = False) -> torch.Tensor:
    """Logits through the embedding table (tied embeddings): x and the table
    rounded to the compute dtype, products summed in f32, f32 out, as the
    reference's ``preferred_element_type=float32`` dot. A plain matmul: the
    reference computes it outside any kernel. It upcasts the whole table on
    every call. ``per_token`` (x: (B, S, d)) runs one (B, 1, d) matmul per
    token, the shape of a decode step: cuBLAS picks its f32 kernel by M,
    and one matmul over all B * S rows rounds otherwise than decode does."""
    w = params["table"].to(compute_dtype).to(torch.float32).T
    xf = x.to(compute_dtype).to(torch.float32)
    if per_token:
        return torch.cat([torch.matmul(xf[:, j:j + 1].contiguous(), w)
                          for j in range(xf.shape[1])], dim=1)
    return torch.matmul(xf, w)


def sinusoidal_positions(s: int, d: int, offset=0, device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None] + offset
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(torch.bfloat16)
