"""Shared neural-net layers of the dense transformer family, in PyTorch.

Functional style, as in the JAX package: ``*_init(gen, ...) -> params`` and
``*_apply(params, x, ...)`` on plain dicts of tensors. Every dense
projection goes through :mod:`repro_torch.core.cascade`.

Caches are updated IN PLACE: a decode or extend step writes its K/V rows
into the cache tensors it is given (views of the engine's stacked cache)
and advances their ``pos`` in place, where the JAX package returns new
arrays. A paged cache (``attn_cache_init_paged``) is written and read
through a block table (``cache_utils.paged_*``). A windowed config
(``AttnConfig.window`` > 0, Griffin's local attention) keeps a ring buffer
of ``window`` rows: position p lives in row p % window and ``slot_pos``
records the position each row holds (-1: empty). Qwen2-VL's M-RoPE
(``AttnConfig.mrope_sections``) rotates by explicit ``(3, B, S)`` (t, h, w)
positions the caller passes (``attn_apply(positions=...)``); they set the
rotary angle only, never the cache row a token is written to or the mask.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.norm import add_norm_plain, gated_norm_plain, norm_plain
from repro_torch.models import cache_utils
from repro_torch.models.cache_utils import as_bytes

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
# RoPE (incl. partial rotary and Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0, device=None) -> torch.Tensor:
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    # a Python-scalar base: no host-to-device copy (which would sync the stream)
    return 1.0 / torch.pow(float(theta), exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2*r channels of x (B, S, H, D) by the (B, S, r)
    angles, pass the rest through (partial rotary; r = 0 passes all)."""
    rot2 = ang.shape[-1]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., : 2 * rot2], x[..., 2 * rot2:]
    x1, x2 = x_rot[..., :rot2], x_rot[..., rot2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S). Rotates the first
    2*len(inv_freq) channels, passes the rest through (partial rotary)."""
    return _rotate(x, positions[..., None].to(torch.float32) * inv_freq)     # (B, S, r/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191). positions: (3, B, S),
    the (t, h, w) streams; the ``inv_freq`` bands are split into
    ``sections`` (half-dim units), band i rotated by stream ``i % 3``."""
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE takes (3, B, S) positions, got {tuple(positions.shape)}")
    ang_all = positions[..., None].to(torch.float32) * inv_freq      # (3, B, S, r/2)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i % 3, :, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------------------
# per-slot cache primitives (continuous batching)
# ---------------------------------------------------------------------------

def pos_slots(slot_pos: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """Normalize a ring-buffer slot-position table to per-row shape (B, T)."""
    slot_pos = slot_pos.to(torch.int32)
    if slot_pos.dim() == 1:
        slot_pos = slot_pos.expand(b, t)
    return slot_pos


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
    as_bytes(buf)[torch.arange(b, device=buf.device)[:, None], rows] = as_bytes(new.to(buf.dtype))


def write_band_row(buf: torch.Tensor, new: torch.Tensor, row: torch.Tensor,
                   offset: int) -> None:
    """Write ``new`` (B, ...) at whole-cache row ``row[b]`` into ``buf``
    (B, Tb, ...), this rank's band of the cache's rows ``[offset, offset +
    Tb)``, in place: a row outside the band is the band-holder's to write,
    and the buffer keeps what it held there (a select, not a branch, so
    nothing syncs)."""
    b, tb = buf.shape[:2]
    bi = torch.arange(b, device=buf.device)
    local = row.to(torch.int64) - offset
    mine = (local >= 0) & (local < tb)
    at = local.clamp(0, tb - 1)
    raw = as_bytes(buf)
    cur = raw[bi, at]
    raw[bi, at] = torch.where(mine.reshape((b,) + (1,) * (cur.dim() - 1)),
                              as_bytes(new.to(buf.dtype)), cur)


def band_softmax(logits: torch.Tensor, live: torch.Tensor) -> tuple:
    """Softmax over the last axis among its ``live`` entries, and their
    log-sum-exp: (p, lse), p = 0 and lse = -inf where none is live (a band
    of a cache's time axis with no live key: its weight in a merge is 0)."""
    x = torch.where(live, logits, torch.full((), float("-inf"), device=logits.device))
    lse = torch.logsumexp(x, dim=-1)
    p = torch.exp(x - torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))[..., None])
    return p, lse


def time_band_attend(pol, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ccfg: CascadeConfig, scale: float, q_pos=None, mask=None) -> torch.Tensor:
    """Decode attention of q (B, 1, H, D) over the whole of a cache's time
    axis, from this rank's band k/v (B, Tb, Hkv, D) (``q_pos`` and
    ``mask`` in the band's rows): its (out, lse) through decode attention
    (the kernel under ``use_kernel``), joined with the other model ranks'
    (``ActivationPolicy.join_time_bands``). Returns (B, 1, H, D) f32."""
    b, _, h, hd = q.shape
    if ccfg.use_kernel:
        from repro_torch.kernels import ops
        o, lse = ops.decode_attention(q[:, 0], k, v, mask, scale=scale, q_pos=q_pos,
                                      return_lse=True)
    else:
        o, lse = decode_attention_plain(q[:, 0], k, v, mask, scale, q_pos, return_lse=True)
    return pol.join_time_bands(o, lse).reshape(b, 1, h, hd)


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
    window: int = 0              # 0 = full causal; > 0 = local attention window
    mrope_sections: tuple = ()   # Qwen2-VL M-RoPE bands (half-dim units); () = plain RoPE
    # the logits' scale; None (and, as in the reference, 0.0) = 1/sqrt(head_dim)
    softmax_scale: float | None = None
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


def _chunked_causal_sdpa(q, k, v, scale, q_chunk, window: int = 0):
    """Causal (with ``window`` > 0 also windowed) attention over query
    chunks of ``q_chunk`` rows: memory O(q_chunk * T) instead of O(S * T),
    for long prefill."""
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
        if window > 0:
            m &= (rows[:, None] - cols[None, :]) < window
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
    positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Attention with four modes:

    * ``full``    -- causal self-attention, no cache.
    * ``prefill`` -- as ``full``, and also returns a decode-ready KV cache.
    * ``decode``  -- one new token (s == 1) against the cache.
    * ``extend``  -- append s tokens at each row's position (chunked prefill
                     into an existing cache). Only the first ``n_valid``
                     chunk tokens are real; the pad K/V lands above the
                     valid region (mask-invalid, overwritten later).

    With ``cfg.window`` > 0 attention is local (key j visible to query i iff
    ``i - window < j <= i``) and the cache a ring buffer (``_ring_attend``):
    decode writes row ``pos % T`` and masks by ``slot_pos``; extend attends
    over [ring, chunk] first, then writes only the valid chunk rows, so a
    pad row never clobbers an in-window entry.

    In ``decode``/``extend`` the cache dict ``{"k", "v": (B, T, Hkv, D),
    "pos": (B,)}`` is updated in place and returned. A paged cache
    ``{"k", "v": (P, ps, Hkv, D), "pos": (B,), "block_table": (B, nb)}``
    takes the new K/V through the block table and attends over the dense
    ``(B, nb*ps, Hkv, D)`` view gathered from the slots' pages, by the same
    routes, so its output equals the dense branch's bit for bit. With
    ``ccfg.use_kernel`` decode attention goes through ``ops.decode_attention``
    (given each row's position, not a mask) and every multi-token attention
    (extend, full, prefill) through ``ops.flash_attention``. ``kv_len``, a
    host-side bound on the keys any row of an extend chunk sees (the largest
    row position plus s), hands the kernel only that prefix of the cache, so
    its launch plan (the split over the keys) follows the live keys and not
    the allocated length.

    ``positions`` sets the rotary angles only: (B, S), or (3, B, S) under
    M-RoPE, where a token's rotary position is not its cache row. Without
    them each token rotates by its row (the cache's ``pos`` plus its index
    in the chunk); an M-RoPE config then raises ``ValueError`` (the
    reference's extend and verify pass none, and fail there too). The mask,
    decode attention's ``q_pos`` and flash attention's ``q_offset`` always
    read the cache rows.

    Under a mesh policy whose cache holds this rank's band of the KV heads
    (``ActivationPolicy.cache_band("k")`` is the heads' dim: a mesh engine
    places them over ``model`` where they divide), q/k/v stay this rank's
    columns of the column-banded projections, which are its heads (q head h
    reads KV head h // G, so a band of KV heads serves the matching band of
    q heads), the rank attends on them, and their output is joined before
    ``wo`` (cascade) or handed to a row-banded ``wo`` as it is (megatron).
    Where the cache holds a band of its time axis instead (the dry run's
    ``cache_specs`` placement, where the heads do not divide), decode writes
    the new row on the rank whose band holds it and attends through
    :func:`time_band_attend`; extend and the paged cache raise there.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    dev = x.device
    # the cache's model band: the KV heads (q/k/v stay this rank's heads)
    # or the time axis
    pol = sharding.get_activation_policy()
    kv_band = pol.cache_band("k") if cache is not None and pol is not None else None
    heads_banded = kv_band == -2
    time_banded = kv_band == -3
    lin = lambda name: cascade.linear_apply(params[name], x, ccfg, gather=not heads_banded)
    q = lin("wq").reshape(b, s, -1, hd)
    k = lin("wk").reshape(b, s, -1, hd)
    v = lin("wv").reshape(b, s, -1, hd)
    h = q.shape[2]

    steps = torch.arange(s, dtype=torch.int32, device=dev)
    if cfg.mrope_sections and positions is None:
        raise ValueError(
            "an M-RoPE config (mrope_sections) needs explicit (3, B, S) positions; "
            "prefill_extend and spec_verify pass none, as the reference's do")
    if positions is None:
        if cache is not None:
            positions = cache["pos"][:, None] + steps[None, :]
        else:
            positions = steps[None, :].expand(b, s)

    inv = rope_freqs(hd, cfg.rope_theta, cfg.rope_fraction, device=dev)
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, inv, cfg.mrope_sections)
        k = apply_mrope(k, positions, inv, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)

    scale = cfg.softmax_scale or 1.0 / (hd ** 0.5)

    if mode in ("decode", "extend"):
        if cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        if mode == "decode" and s != 1:
            raise ValueError("decode takes one token per row")
        pos = cache["pos"]                               # (B,) next write index
        bt = cache.get("block_table")
        if time_banded and (mode != "decode" or bt is not None):
            raise ValueError(
                "a k/v cache banded over its time axis (the dry run's cache_specs placement) "
                "runs decode only: extend, the speculative verify pass and the paged cache "
                "need its rows whole")
        if cfg.window > 0:
            if bt is not None:
                raise ValueError("paged attention requires full attention")
            o = _ring_attend(q, k, v, cache, cfg, ccfg, mode, scale, n_valid,
                             pol if time_banded else None)
        elif time_banded:
            # this rank holds rows [off, off + Tb) of the cache's T = Tb * m
            tb = cache["k"].shape[1]
            off = pol.model_rank * tb
            row = pos.to(torch.int64).clamp(0, tb * pol.model_size - 1)
            write_band_row(cache["k"], k[:, 0], row, off)
            write_band_row(cache["v"], v[:, 0], row, off)
            o = time_band_attend(pol, q, cache["k"], cache["v"], ccfg, scale, q_pos=pos - off)
        else:
            if bt is not None:
                # scatter through the block table, then gather the slots' pages
                # back into the dense view: rows backed by the trash page sit
                # above pos, where every route gives them weight exactly 0. An
                # extend on the kernel route gathers only the blocks covering
                # kv_len; decode gathers all nb*ps rows, the dense cache's T, so
                # decode attention's split (chosen from T) is the dense one's
                ps = cache["k"].shape[1]
                phys = cache_utils.paged_phys_rows(bt, pos[:, None] + steps[None, :], ps)
                cache_utils.paged_update_rows(cache["k"], k, phys)
                cache_utils.paged_update_rows(cache["v"], v, phys)
                nb = bt.shape[1]
                if ccfg.use_kernel and mode == "extend" and kv_len is not None:
                    nb = min(nb, -(-int(kv_len) // ps))
                att_k = cache_utils.paged_gather(cache["k"], bt[:, :nb], ps)
                att_v = cache_utils.paged_gather(cache["v"], bt[:, :nb], ps)
            else:
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
                o = _masked_attention(q, att_k, att_v, valid, scale)
        nv = s if n_valid is None else n_valid
        cache["pos"].add_(nv if isinstance(nv, torch.Tensor) else int(nv))
        new_cache = cache
    else:
        if ccfg.use_kernel:
            from repro_torch.kernels import ops
            o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    scale=scale, window=cfg.window).transpose(1, 2)
        elif cfg.q_chunk > 0 and s > cfg.q_chunk:
            o = _chunked_causal_sdpa(q, k, v, scale, cfg.q_chunk, cfg.window)
        else:
            r = torch.arange(s, device=dev)
            m = r[:, None] >= r[None, :]
            if cfg.window > 0:
                m &= (r[:, None] - r[None, :]) < cfg.window
            o = _sdpa(q, k, v, m, scale)
        new_cache = None
        if mode == "prefill":
            new_cache = _build_cache_from_prefill(k, v, s, max_len=max_len,
                                                  dtype=ccfg.resolved_kv_dtype,
                                                  window=cfg.window)

    o = o.to(x.dtype).reshape(b, s, h * hd)
    if heads_banded and cascade.banded(params["wo"]) != -2:
        o = cascade.gather_columns(o)          # wo wants every head (cascade)
    return cascade.out_apply(params["wo"], o, ccfg), new_cache


def _masked_attention(q, k, v, valid, scale):
    """Plain attention of q (B, s, H, D) over k/v (B, T, Hkv, D) under a
    (B, s, T) validity mask, in f32 (the reference's extend/decode einsums)."""
    b, s, h, hd = q.shape
    hk = k.shape[2]
    qd = q.to(torch.float32).reshape(b, s, hk, h // hk, hd)
    logits = torch.einsum("bshgd,bthd->bhgst", qd, k.to(torch.float32)) * scale
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32)).reshape(b, s, h, hd)


def _ring_attend(q, k, v, cache: dict, cfg: AttnConfig, ccfg: CascadeConfig, mode: str,
                 scale: float, n_valid, band_pol=None) -> torch.Tensor:
    """Local attention on a ring-buffer cache ``{"k", "v": (B, T, Hkv, D),
    "slot_pos": (B, T), "pos": (B,)}``, updated in place but ``pos`` (the
    caller advances it). Returns the (B, s, H, D) output.

    Decode writes the token at row ``pos % T`` and records its position in
    ``slot_pos``; key t is live iff ``0 <= slot_pos[t] <= pos`` and within
    the window (decode attention takes that (B, T) mask). Extend attends over
    [ring, chunk] FIRST, keys at positions ``concat(slot_pos, rows)`` (flash
    attention takes them as ``k_pos`` with the window), and only then writes
    the valid chunk rows at ``rows % T``: a chunk may overwrite ring entries
    that its earlier tokens still attend to, and s <= T keeps the chunk's
    own writes apart. The reference drops pad writes with an out-of-bounds
    index; here only the first ``n_valid`` rows are written.

    ``band_pol`` (decode on a ring banded over its time axis): k/v hold this
    rank's band of the ring's rows, ``slot_pos`` the whole ring (the
    reference's ``cache_specs`` keeps it replicated), every rank records the
    token's position, the rank whose band holds its row writes it, and the
    bands' attentions are joined (``time_band_attend``).
    """
    b, s, h, hd = q.shape
    dev = q.device
    slot_pos = cache["slot_pos"]
    t = slot_pos.shape[1]                  # the ring's rows (k/v may hold a band of them)
    w = cfg.window
    pos = cache["pos"]
    bi = torch.arange(b, device=dev)
    if mode == "decode":
        idx = pos.to(torch.int64) % t
        if band_pol is None:
            update_rows(cache["k"], k, idx)
            update_rows(cache["v"], v, idx)
        else:
            off = band_pol.model_rank * cache["k"].shape[1]
            write_band_row(cache["k"], k[:, 0], idx, off)
            write_band_row(cache["v"], v[:, 0], idx, off)
        slot_pos[bi, idx] = pos.to(slot_pos.dtype)
        p = pos[:, None]
        valid = (slot_pos >= 0) & (slot_pos <= p) & (p - slot_pos < w)          # (B, T)
        if band_pol is not None:
            tb = cache["k"].shape[1]
            return time_band_attend(band_pol, q, cache["k"], cache["v"], ccfg, scale,
                                    mask=valid[:, off:off + tb])
        if ccfg.use_kernel:
            from repro_torch.kernels import ops
            return ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                                        scale=scale).reshape(b, 1, h, hd)
        return _masked_attention(q, cache["k"], cache["v"], valid[:, None], scale)
    if s > t:
        raise ValueError(f"a {s}-token chunk does not fit inside the {t}-row ring buffer")
    rows = pos.to(torch.int64)[:, None] + torch.arange(s, device=dev)              # (B, s)
    key_pos = torch.cat([slot_pos.to(torch.int32), rows.to(torch.int32)], dim=1)   # (B, T+s)
    if ccfg.use_kernel:
        from repro_torch.kernels import ops
        cat = lambda buf, new: torch.cat([as_bytes(buf), as_bytes(new.to(buf.dtype))],
                                         dim=1).view(buf.dtype)
        att_k, att_v = cat(cache["k"], k), cat(cache["v"], v)
        o = ops.flash_attention(q.transpose(1, 2), att_k.transpose(1, 2), att_v.transpose(1, 2),
                                scale=scale, q_offset=pos, k_pos=key_pos,
                                window=w).transpose(1, 2)
    else:
        att_k = torch.cat([cache["k"].to(torch.float32), k.to(torch.float32)], dim=1)
        att_v = torch.cat([cache["v"].to(torch.float32), v.to(torch.float32)], dim=1)
        kp, r = key_pos[:, None, :], rows[:, :, None]
        o = _masked_attention(q, att_k, att_v, (kp >= 0) & (kp <= r) & (r - kp < w), scale)
    n = s if n_valid is None else max(0, min(int(n_valid), s))
    widx = rows[:, :n] % t                                                         # (B, n)
    for name, new in (("k", k), ("v", v), ("slot_pos", rows)):
        as_bytes(cache[name])[bi[:, None], widx] = as_bytes(new[:, :n].to(cache[name].dtype))
    return o


def _build_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, s: int,
                              max_len: int | None = None, dtype=None, window: int = 0) -> dict:
    """Decode-ready cache from prefill K/V (positions 0..s-1, every row at
    s). With a window the cache is the ring: it holds the full window
    whatever ``max_len`` is (the last ``window`` positions, or the prompt
    padded with empty rows), rolled so position p sits at row p % window."""
    b = k.shape[0]
    # padded and rolled in the compute dtype, then cast (the same codes: a
    # float8 cache's pads and rolls need no float8 kernels)
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    pos = torch.full((b,), s, dtype=torch.int32, device=k.device)
    if window > 0:
        t = window
        if s >= t:
            k_last, v_last = k[:, s - t:], v[:, s - t:]
            pos_last = torch.arange(s - t, s, dtype=torch.int32, device=k.device)
        else:
            pad = (0, 0, 0, 0, 0, t - s)
            k_last, v_last = F.pad(k, pad), F.pad(v, pad)
            pos_last = torch.cat([torch.arange(s, dtype=torch.int32, device=k.device),
                                  torch.full((t - s,), -1, dtype=torch.int32, device=k.device)])
        shift = s % t if s >= t else 0
        return {"k": cast(torch.roll(k_last, shift, dims=1)),
                "v": cast(torch.roll(v_last, shift, dims=1)),
                "slot_pos": torch.roll(pos_last, shift).expand(b, t).contiguous(), "pos": pos}
    t = max_len if max_len is not None else s
    pad = (0, 0, 0, 0, 0, t - s)
    return {"k": cast(F.pad(k, pad)), "v": cast(F.pad(v, pad)), "pos": pos}


def attn_cache_init(batch: int, max_len: int, cfg: AttnConfig, dtype=torch.bfloat16,
                    device=None) -> dict:
    """Zero K/V of ``max_len`` rows and ``pos`` 0; a windowed config's ring
    holds the full window whatever ``max_len`` is (a shorter ring would cut
    attention short for prompts past ``max_len``), every row empty
    (``slot_pos`` -1)."""
    if cfg.window > 0:
        shape = (batch, cfg.window, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((batch, cfg.window), -1, dtype=torch.int32, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def attn_cache_init_paged(batch: int, num_pages: int, page_size: int, cfg: AttnConfig,
                          dtype=torch.bfloat16, device=None) -> dict:
    """A paged attention cache: K/V in a pool of ``num_pages`` pages of
    ``page_size`` rows shared by the slots, and per-slot ``pos``. The (B, nb)
    block table is not a leaf: the engine owns it and passes it in with the
    batch on every step."""
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
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


def seq_layers(x: torch.Tensor, mode: str) -> tuple:
    """(x, seq) for a layer loop over the (B, S, d) embeddings ``x``: where
    the installed policy holds this rank's rows between blocks
    (``sharding.holds_rows``: sequence parallelism's rows of the sequence,
    serving fulldp's rows of the batch) those rows and True, else x and
    False."""
    seq = sharding.holds_rows(x, mode)
    return (sharding.get_activation_policy().take_rows(x) if seq else x), seq


def seq_norms(lp: dict, seq: bool, names: tuple) -> dict:
    """A block's params with its norms' (``names``) as norms over this
    rank's rows read them (``seq``): under autograd each rank's gradient of
    a norm's scale is its rows' part, so it is summed over the model ranks
    (``ActivationPolicy.band_input``)."""
    if not seq:
        return lp
    pol = sharding.get_activation_policy()
    return dict(lp, **{n: {k: pol.band_input(v) for k, v in lp[n].items()} for n in names})


def seq_whole(seq: bool, *xs):
    """The tensors ``xs`` (this rank's rows when ``seq``) whole again."""
    if not seq:
        return xs
    pol = sharding.get_activation_policy()
    return tuple(None if t is None else pol.gather_rows(t) for t in xs)


def mlp_apply(params: dict, x: torch.Tensor, kind: str, ccfg: CascadeConfig) -> torch.Tensor:
    """The MLP. Under a mesh policy whose bands split the hidden width (w_up
    column-banded), the elementwise gate runs on this rank's hidden columns,
    which are joined before a w_down that wants them whole (cascade) and
    handed as they are to a row-banded one (megatron)."""
    banded = cascade.banded(params["w_up"]) == -1
    lin = lambda name, a: cascade.linear_apply(params[name], a, ccfg, gather=not banded)
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
    if banded and cascade.banded(params["w_down"]) != -2:
        hid = cascade.gather_columns(hid)
    return cascade.out_apply(params["w_down"], hid, ccfg)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16,
               device=None) -> dict:
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device) * 0.02
    return {"table": table.to(dtype)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows of ``tokens``. Under a mesh policy a table banded
    on d (cascade) gathers its columns; one banded on the vocabulary
    (megatron) looks up the ids in its band, zero rows for the others, and
    all-reduces (each row then sums one nonzero band: exact)."""
    table = params["table"]
    pol = sharding.get_activation_policy()
    band = pol.band(table) if pol is not None else None
    if band == -1:
        return pol.gather_model(table[tokens], -1)
    if band == -2:
        vb = table.shape[0]
        local = tokens.to(torch.int64) - pol.model_rank * vb
        mine = (local >= 0) & (local < vb)
        rows = table[local.clamp(0, vb - 1)].to(torch.float32) * mine[..., None]
        return pol.sum_model(rows).to(table.dtype)
    return table[tokens]


def tied_head(params: dict, x: torch.Tensor, compute_dtype,
              per_token: bool = False) -> torch.Tensor:
    """Logits through the embedding table (tied embeddings): x and the table
    rounded to the compute dtype, products summed in f32, f32 out, as the
    reference's ``preferred_element_type=float32`` dot. A plain matmul: the
    reference computes it outside any kernel. It upcasts the whole table on
    every call. ``per_token`` (x: (B, S, d)) runs one (B, 1, d) matmul per
    token, the shape of a decode step: cuBLAS picks its f32 kernel by M,
    and one matmul over all B * S rows rounds otherwise than decode does.
    Under a mesh policy that bands the table on the vocabulary (megatron),
    each rank computes the logits of its band of the vocabulary and they
    are all-gathered, so every rank samples from the whole vocabulary."""
    pol = sharding.get_activation_policy()
    table = params["table"]
    vocab_banded = pol is not None and pol.band(table) == -2
    if vocab_banded:
        x = pol.band_input(x)
    w = table.to(compute_dtype).to(torch.float32).T
    xf = x.to(compute_dtype).to(torch.float32)
    if per_token:
        logits = torch.cat([torch.matmul(xf[:, j:j + 1].contiguous(), w)
                            for j in range(xf.shape[1])], dim=1)
    else:
        logits = torch.matmul(xf, w)
    if vocab_banded:
        logits = pol.gather_model(logits, -1)
    return logits


def sinusoidal_positions(s: int, d: int, offset=0, device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None] + offset
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(torch.bfloat16)
