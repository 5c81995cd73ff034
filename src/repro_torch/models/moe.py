"""Mixture-of-Experts LMs, in PyTorch: DeepSeek-V2 (MLA, shared and routed
experts, top-6) and OLMoE (MHA, 64 routed experts, top-8).

Routing is the reference's capacity dispatch: each token's top-k experts
get a row of an (E, C, d) buffer, built with a scatter-add and read back
with a gather. Serving dispatches drop-free (capacity t rounded up to 8),
so a token's output depends on that token alone; ``forward`` keeps the
capacity-factor drops. With ``use_kernel`` the expert matmuls take two
grouped launches over all E experts a layer: gate and up together
(``kernels.ops.cascade_matmul_grouped_pair``), then down
(``kernels.ops.cascade_matmul_grouped``), each handed the routed rows of
each expert on the device, so an expert no token chose reads none of its
weights. The combine sums each token's k expert outputs in f32 in top-k
order, one elementwise add at a time, so a row's bits do not depend on how
many rows the step has.

MLA (multi-head latent attention, arXiv:2405.04434): the KV cache holds a
512-wide latent and a 64-wide RoPE key a token. Decode and extend use the
weight-absorption identity (scores = (q W_k) . c_kv), so attention runs in
latent space; prefill expands the latents to per-head keys and values. MLA
attention runs in plain PyTorch in f32, as the reference computes it with
einsums and no kernel: neither CUDA attention kernel takes its widths
(``flash_attention`` takes D up to 128 and MLA's q . k is 128 + 64 = 192
wide; ``decode_attention`` takes D up to 256 and the absorbed latents are
512 + 64 = 576 wide). Its projections go through the FP4 matmul and its
``q_norm``/``kv_norm`` through the norm kernel, as every other one does.

``MoELM`` is ``TransformerLM`` with these layers: the param tree is the
reference's (``dense_layers`` a list of the first dense-MLP layers,
``layers`` the MoE layers stacked ``(L, ...)``), and the cache ONE stack of
all ``n_layers`` attention caches, dense layers first (``{"layers": {"k",
"v", "pos"}}``, or MLA's ``{"layers": {"c_kv", "k_rope", "pos"}}``), so the
engine and ``cache_utils`` address it as the dense transformer's. The
reference keeps ``{"dense_layers": [...], "layers": ...}``; a layer's cache
depends only on its attention, which dense and MoE layers share. Under a
mesh policy installed with ``moe_ep`` (``distributed.sharding.
ActivationPolicy``) the routed experts take the expert-parallel dispatch
of ``models/moe_shardmap.py`` (experts banded over ``model``, capacity
semantics, one all-reduce to combine), as the reference's ``_moe_ffn``
does; otherwise the capacity dispatch above, on whatever bands the policy
gives the expert stacks (``core/cascade.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.distributed import sharding
from repro_torch.models import cache_utils
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerLM
from repro_torch.trace import span

#: the router's f32 product runs over a whole number of blocks of this many
#: rows, so a decode step (8 rows), an admission chunk (32) and a verify
#: pass (40) multiply at one M: on the card a row's logits then take one
#: summation order, and a token routes alike in all three
ROUTER_ROWS = 64


# ---------------------------------------------------------------------------
# routed-expert FFN
# ---------------------------------------------------------------------------

def moe_ffn_init(gen: torch.Generator, cfg: ArchConfig, ccfg: CascadeConfig,
                 device=None) -> dict:
    d, e, dff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": torch.randn((d, e), generator=gen, dtype=torch.float32, device=device) * 0.02,
        "wg": cascade.expert_linear_init(gen, e, d, dff, ccfg, device=device),
        "wu": cascade.expert_linear_init(gen, e, d, dff, ccfg, device=device),
        "wd": cascade.expert_linear_init(gen, e, dff, d, ccfg, device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, cfg.n_shared_experts * dff, "swiglu", ccfg,
                                 device=device)
    return p


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = math.ceil(cfg.moe_capacity_factor * n_tokens * cfg.moe_top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def router_logits(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, E) f32 logits, multiplied over rows padded to a
    multiple of ``ROUTER_ROWS``."""
    t = xf.shape[0]
    xp = F.pad(xf.to(torch.float32), (0, 0, 0, -t % ROUTER_ROWS))
    return torch.matmul(xp, router)[:t]


def route(params: dict, xf: torch.Tensor, cfg: ArchConfig):
    """Softmax over the router logits, then the top-k experts of each token
    in descending order, ties to the lower expert index (``lax.top_k``'s
    order; a stable sort keeps it). Returns gates (T, k) f32, idx (T, k)."""
    probs = torch.softmax(router_logits(xf, params["router"]), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    if cfg.moe_renorm:
        gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return gates, idx


def dispatch(idx: torch.Tensor, e: int, cap: int):
    """Buffer rows of the T*k assignments (token-major): ``dst`` (T*k,) is
    expert * cap + the assignment's place among that expert's, or e * cap
    (a trash row) past capacity; ``keep`` (T*k,) bool; ``rows`` (E,) int32,
    each expert's routed rows (at most cap). Integer work, no host sync."""
    flat_e = idx.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=idx.device)).to(torch.int32)
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1, flat_e[:, None])[:, 0]
    keep = pos_in_e < cap
    dst = torch.where(keep, flat_e * cap + pos_in_e, e * cap)
    rows = torch.sum(onehot, dim=0).clamp_(max=cap).to(torch.int32)
    return dst, keep, rows


def moe_ffn_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, ccfg: CascadeConfig,
                  no_drop: bool = False) -> torch.Tensor:
    """Capacity-dispatched routed experts (and the shared ones). ``no_drop``
    (serving) sizes the buffer so no token is dropped: top-k experts are
    distinct per token, so an expert takes at most t rows."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.moe_top_k, cfg.n_experts
    cap = (-(-t // 8) * 8) if no_drop else _capacity(t, cfg)
    xf = x.reshape(t, d)
    with span("moe.route"):
        gates, idx = route(params, xf, cfg)
    with span("moe.dispatch"):
        dst, keep, rows = dispatch(idx, e, cap)
        xk = xf[:, None].expand(t, k, d).reshape(t * k, d)              # token-major
        buf = xf.new_zeros((e * cap + 1, d)).index_add_(0, dst, xk)[:-1].reshape(e, cap, d)
    gate, up = cascade.expert_linear_pair_apply(params["wg"], params["wu"], buf, ccfg, rows)
    h = F.silu(gate.to(torch.float32))
    h = (h * up.to(torch.float32)).to(buf.dtype)
    out = cascade.expert_linear_apply(params["wd"], h, ccfg, rows).reshape(e * cap, d)  # (E*C, d)
    shared = L.mlp_apply(params["shared"], xf, "swiglu", ccfg) if "shared" in params else None

    with span("moe.combine"):
        got = torch.where(keep[:, None], out[torch.clamp(dst, max=e * cap - 1)],
                          torch.zeros((), dtype=out.dtype, device=out.device))
        w = (got.to(torch.float32) * gates.reshape(-1)[:, None]).reshape(t, k, d)
        y = w[:, 0]
        for j in range(1, k):                   # in top-k order, as the reference sums
            y = y + w[:, j]
        if shared is not None:
            y = y + shared.to(torch.float32)
        return y.reshape(b, s, d).to(x.dtype)


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ArchConfig, ccfg: CascadeConfig, device=None) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    lin = lambda din, dout: cascade.linear_init(gen, din, dout, ccfg, device=device)
    return {
        "wq_a": lin(d, cfg.q_lora),
        "q_norm": L.norm_init(cfg.q_lora, device=device),
        "wq_b": lin(cfg.q_lora, h * qk),
        "wkv_a": lin(d, cfg.kv_lora + cfg.qk_rope_dim),
        "kv_norm": L.norm_init(cfg.kv_lora, device=device),
        "wkv_b": lin(cfg.kv_lora, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
        "wo": lin(h * cfg.v_head_dim, d),
    }


def _mla_qkr(params: dict, x: torch.Tensor, cfg: ArchConfig, ccfg: CascadeConfig,
             positions: torch.Tensor):
    """The q and latent-kv projections and RoPE: q_nope, q_rope, c_kv, k_rope."""
    b, s, _ = x.shape
    uk = ccfg.use_kernel
    q_a = cascade.linear_apply(params["wq_a"], x, ccfg)
    q = cascade.linear_apply(params["wq_b"], L.norm_apply(params["q_norm"], q_a, use_kernel=uk),
                             ccfg).reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    kv = cascade.linear_apply(params["wkv_a"], x, ccfg)
    c_kv = L.norm_apply(params["kv_norm"], kv[..., :cfg.kv_lora], use_kernel=uk)
    k_rope = kv[..., cfg.kv_lora:][:, :, None, :]                         # (b, s, 1, rope)
    inv = L.rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device=x.device)
    return (q_nope, L.apply_rope(q_rope, positions, inv), c_kv,
            L.apply_rope(k_rope, positions, inv)[:, :, 0, :])


def mla_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, ccfg: CascadeConfig,
              cache: dict | None = None, mode: str = "full", max_len: int | None = None,
              n_valid=None):
    """MLA in the modes of ``layers.attn_apply``. In ``decode``/``extend`` the
    latent cache ``{"c_kv": (B, T, kv_lora), "k_rope": (B, T, rope), "pos":
    (B,)}`` is updated in place (a paged one, ``(P, ps, ...)`` pools beside
    ``block_table``, through the table) and attention runs over all T rows,
    rows past each position masked: the paged view has the dense cache's T,
    so both give the same bits. Under a policy whose cache holds a band of
    the latent rows (``c_kv``/``k_rope`` over ``model``: the dry run's
    ``cache_specs`` placement), decode writes the new row on the rank whose
    band holds it, each rank scores its rows and the bands' latent contexts
    are joined by their log-sum-exps (``ActivationPolicy.join_time_bands``,
    f32), before ``w_v``; extend and the paged cache raise there."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dev = x.device
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    if cache is not None:
        positions = cache["pos"][:, None] + steps[None, :]
    else:
        positions = steps[None, :].expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, ccfg, positions)

    wkv_b = cascade.linear_weight(params["wkv_b"], ccfg).reshape(
        cfg.kv_lora, h, cfg.qk_nope_dim + cfg.v_head_dim)
    w_k = wkv_b[..., :cfg.qk_nope_dim].to(torch.float32)                 # (lora, H, nope)
    w_v = wkv_b[..., cfg.qk_nope_dim:].to(torch.float32)                 # (lora, H, v)

    if mode in ("decode", "extend"):
        if cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        if mode == "decode" and s != 1:
            raise ValueError("decode takes one token per row")
        pos = cache["pos"]
        bt = cache.get("block_table")
        pol = sharding.get_activation_policy()
        band = pol.cache_band("c_kv") if pol is not None else None
        if band is not None and (mode != "decode" or bt is not None):
            raise ValueError(
                "an MLA latent cache banded over its rows (the dry run's cache_specs "
                "placement) runs decode only: extend, the speculative verify pass and the "
                "paged cache need its rows whole")
        off = 0
        if band is not None:
            tb = cache["c_kv"].shape[1]
            off = pol.model_rank * tb
            row = pos.to(torch.int64).clamp(0, tb * pol.model_size - 1)
            L.write_band_row(cache["c_kv"], c_kv[:, 0], row, off)
            L.write_band_row(cache["k_rope"], k_rope[:, 0], row, off)
            ckv, krp = cache["c_kv"], cache["k_rope"]
        elif bt is not None:
            ps = cache["c_kv"].shape[1]
            phys = cache_utils.paged_phys_rows(bt, pos[:, None] + steps[None, :], ps)
            cache_utils.paged_update_rows(cache["c_kv"], c_kv, phys)
            cache_utils.paged_update_rows(cache["k_rope"], k_rope, phys)
            ckv = cache_utils.paged_gather(cache["c_kv"], bt, ps)
            krp = cache_utils.paged_gather(cache["k_rope"], bt, ps)
        else:
            L.update_rows(cache["c_kv"], c_kv, pos)
            L.update_rows(cache["k_rope"], k_rope, pos)
            ckv, krp = cache["c_kv"], cache["k_rope"]
        t = ckv.shape[1]
        ckv, krp = ckv.to(torch.float32), krp.to(torch.float32)
        rows = pos[:, None] + steps[None, :]                              # (B, s)
        # weight absorption: stay in latent space
        q_lat = torch.einsum("bshd,lhd->bshl", q_nope.to(torch.float32), w_k)
        scores = (torch.einsum("bshl,btl->bhst", q_lat, ckv)
                  + torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32), krp)) * scale
        valid = torch.arange(off, off + t, device=dev)[None, None, :] <= rows[:, :, None]
        if band is None:
            p = torch.softmax(scores.masked_fill(~valid[:, None], L.NEG_INF), dim=-1)
            ctx = torch.einsum("bhst,btl->bshl", p, ckv)
        else:
            p, lse = L.band_softmax(scores, valid[:, None])                # lse (B, H, s)
            ctx = pol.join_time_bands(torch.einsum("bhst,btl->bshl", p, ckv),
                                      lse.transpose(1, 2))
        o = torch.einsum("bshl,lhd->bshd", ctx, w_v)                      # (b, s, H, v)
        nv = s if n_valid is None else n_valid
        cache["pos"].add_(nv if isinstance(nv, torch.Tensor) else int(nv))
        new_cache = cache
    else:
        # expand the latents to per-head keys and values (prefill, full)
        cf = c_kv.to(torch.float32)
        k_nope = torch.einsum("btl,lhd->bthd", cf, w_k)
        v = torch.einsum("btl,lhd->bthd", cf, w_v)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].to(torch.float32)
                            .expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        cd = ccfg.compute_dtype
        if cfg.q_chunk > 0 and s > cfg.q_chunk:
            o = L._chunked_causal_sdpa(q_full.to(cd), k_full.to(cd), v.to(cd), scale,
                                       cfg.q_chunk)
        else:
            r = torch.arange(s, device=dev)
            o = L._sdpa(q_full.to(cd), k_full.to(cd), v.to(cd), r[:, None] >= r[None, :], scale)
        new_cache = None
        if mode == "prefill":
            pad = (0, 0, 0, (max_len if max_len is not None else s) - s)
            kvd = ccfg.resolved_kv_dtype
            new_cache = {"c_kv": F.pad(c_kv, pad).to(kvd), "k_rope": F.pad(k_rope, pad).to(kvd),
                         "pos": torch.full((b,), s, dtype=torch.int32, device=dev)}

    out = cascade.out_apply(params["wo"], o.to(x.dtype).reshape(b, s, h * cfg.v_head_dim),
                               ccfg)
    return out, new_cache


def mla_cache_init(batch: int, max_len: int, cfg: ArchConfig, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_cache_init_paged(batch: int, num_pages: int, page_size: int, cfg: ArchConfig,
                         dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c_kv": torch.zeros((num_pages, page_size, cfg.kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros((num_pages, page_size, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MoE LM (DeepSeek-V2 / OLMoE)
# ---------------------------------------------------------------------------

class MoELM(TransformerLM):
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.use_mla = cfg.kv_lora > 0
        if not self.use_mla:
            self.attn_cfg = L.AttnConfig(
                d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk)

    # ------------------------------------------------------------------ init
    def _layer_init(self, gen: torch.Generator, ccfg: CascadeConfig, device,
                    moe: bool = True) -> dict:
        cfg = self.cfg
        attn = (mla_init(gen, cfg, ccfg, device=device) if self.use_mla
                else L.attn_init(gen, self.attn_cfg, ccfg, device=device))
        p = {"ln1": L.norm_init(cfg.d_model, cfg.norm_type, device=device), "attn": attn,
             "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=device)}
        if moe:
            p["moe"] = moe_ffn_init(gen, cfg, ccfg, device=device)
        else:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.dense_d_ff or cfg.d_ff, "swiglu", ccfg,
                                  device=device)
        return p

    def init_params(self, seed: int, ccfg: CascadeConfig, device=None,
                    place=None) -> dict:
        """Random params from ``seed`` in the reference's tree; in
        ``serve_fp4`` mode every matrix (every expert) is quantized as it
        is drawn.
        ``place`` (``distributed.sharding.param_placer``) takes each
        fragment of the tree (a layer, the embedding, the head) as soon as
        it is drawn and keeps this rank's bands of it, so a mesh rank never
        holds more than one whole fragment beside its bands."""
        cfg = self.cfg
        device = resolve_device(device)
        gen = seeded_generator(device, seed)
        place = place or (lambda fragment: fragment)
        nd = cfg.first_dense_layers
        params = {
            "dense_layers": [place(self._layer_init(gen, ccfg, device, moe=False))
                             for _ in range(nd)],
            "layers": cache_utils.stack_layers(
                [place(self._layer_init(gen, ccfg, device)) for _ in range(cfg.n_layers - nd)]),
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
        }
        params.update(place({"embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                                   dtype=ccfg.compute_dtype, device=device)}))
        params.update(place({"lm_head": cascade.linear_init(gen, cfg.d_model, cfg.vocab, ccfg,
                                                            device=device)}))
        return params

    # --------------------------------------------------------------- layers
    def _remat_layer(self, params: dict, i: int) -> bool:
        """The MoE layers only: the reference's ``jax.checkpoint`` wraps its
        scan over them and leaves the dense layers in front as they are."""
        return i >= len(params["dense_layers"])

    def _layer_list(self, params: dict) -> list:
        return list(params["dense_layers"]) + cache_utils.unstack_layers(params["layers"])

    def _block(self, lp: dict, x: torch.Tensor, ccfg: CascadeConfig, cache, mode: str,
               max_len: int | None = None, n_valid=None, kv_len: int | None = None,
               pending: torch.Tensor | None = None, seq: bool = False):
        """``TransformerLM._block`` with MLA or MHA attention and the routed
        experts (``moe`` layers, drop-free but in ``full`` mode) or a dense
        SwiGLU MLP. ``seq`` as there; the routed experts' output (whole:
        the combine gathers the expert buffer) is cut to the rank's rows."""
        cfg = self.cfg
        lp = L.seq_norms(lp, seq, ("ln1", "ln2"))
        uk = ccfg.use_kernel
        if pending is None:
            u = L.norm_apply(lp["ln1"], x, cfg.norm_type, use_kernel=uk)
        else:
            u, x = L.add_norm_apply(lp["ln1"], x, pending, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        with sharding.rows_out(seq):
            if self.use_mla:
                h, new_cache = mla_apply(lp["attn"], u, cfg, ccfg, cache, mode, max_len, n_valid)
            else:
                h, new_cache = L.attn_apply(lp["attn"], u, self.attn_cfg, ccfg, cache=cache,
                                            mode=mode, max_len=max_len, n_valid=n_valid,
                                            kv_len=kv_len)
        u, x = L.add_norm_apply(lp["ln2"], x, h, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        if "moe" in lp:
            out = self._moe_ffn(lp["moe"], u, ccfg, no_drop=mode != "full")
            if seq:
                out = sharding.get_activation_policy().take_rows(out)
        else:
            with sharding.rows_out(seq):
                out = L.mlp_apply(lp["mlp"], u, "swiglu", ccfg)
        return x, out, new_cache

    def _moe_ffn(self, lp_moe: dict, u: torch.Tensor, ccfg: CascadeConfig,
                 no_drop: bool = False) -> torch.Tensor:
        """The expert-parallel dispatch under a policy installed with
        ``moe_ep`` (a training and lowering surface: it keeps capacity
        drops), else :func:`moe_ffn_apply`."""
        pol = sharding.get_activation_policy()
        if pol is not None and pol.moe_ep:
            from repro_torch.models.moe_shardmap import moe_ffn_apply_ep
            return moe_ffn_apply_ep(lp_moe, u, self.cfg, ccfg, pol.mesh, pol.model_axis)
        return moe_ffn_apply(lp_moe, u, self.cfg, ccfg, no_drop=no_drop)

    # --------------------------------------------------------------- caches
    @property
    def paged_attention(self) -> bool:
        """MLA's latent cache pages as MHA's does: no MoE config is windowed."""
        return True

    def _attn_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        if self.use_mla:
            return mla_cache_init(batch, max_len, self.cfg, dtype, device=device)
        return L.attn_cache_init(batch, max_len, self.attn_cfg, dtype, device=device)

    def _attn_cache_paged(self, batch: int, num_pages: int, page_size: int, dtype,
                          device) -> dict:
        if self.use_mla:
            return mla_cache_init_paged(batch, num_pages, page_size, self.cfg, dtype,
                                        device=device)
        return L.attn_cache_init_paged(batch, num_pages, page_size, self.attn_cfg, dtype,
                                       device=device)
