"""Analytic parameter & FLOP accounting per architecture config.

Pure Python over ``configs.base``: the JAX package's ``core/flops.py``,
function for function, so both packages count alike. MODEL_FLOPS = 6·N·D
(dense train) or 6·N_active·D (MoE), plus attention terms; a decode step
is 2·N_active per token plus the cache attention; ``weight_bytes`` is the
resident weight payload a step streams (FP4: half a byte a parameter).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig


def param_count(cfg: ArchConfig) -> dict:
    """Analytic parameter counts by component; 'total' and 'active'
    (= dense-equivalent params touched per token, for MoE)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.resolved_head_dim
    h, hk = cfg.n_heads, cfg.n_kv_heads
    counts = {"embed": 0 if cfg.input_embeds else V * d}
    head_width = V * max(1, cfg.n_codebooks)
    counts["lm_head"] = 0 if (cfg.tie_embeddings and not cfg.input_embeds) else d * head_width

    per_layer_attn = 0
    per_layer_mixer = 0
    if cfg.family == "ssm":
        di = cfg.d_inner or 2 * d
        nheads = di // cfg.ssm_head_dim
        conv_dim = di + 2 * cfg.ssm_groups * cfg.ssm_state
        d_in_proj = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + nheads
        per_layer_mixer = d * d_in_proj + cfg.conv_width * conv_dim + 3 * nheads + di * d
        counts["mixer"] = L * per_layer_mixer
        counts["mlp"] = 0
    elif cfg.family == "hybrid":
        lru = cfg.lru_width or d
        r_mix = d * lru * 2 + cfg.conv_width * lru + 2 * lru * lru + lru + lru * d
        a_mix = d * (h + 2 * hk) * hd + h * hd * d
        pat = cfg.block_pattern or ("R", "R", "A")
        n_groups = L // len(pat)
        n_r = n_groups * pat.count("R") + (L - n_groups * len(pat))
        n_a = n_groups * pat.count("A")
        counts["mixer"] = n_r * r_mix + n_a * a_mix
        glu = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
        counts["mlp"] = L * glu * d * cfg.d_ff if cfg.mlp_kind in ("swiglu", "geglu") \
            else L * 2 * d * cfg.d_ff
    elif cfg.family == "moe":
        if cfg.kv_lora:  # MLA
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            per_layer_attn = (d * cfg.q_lora + cfg.q_lora * h * qk
                              + d * (cfg.kv_lora + cfg.qk_rope_dim)
                              + cfg.kv_lora * h * (cfg.qk_nope_dim + cfg.v_head_dim)
                              + h * cfg.v_head_dim * d)
        else:
            per_layer_attn = d * (h + 2 * hk) * hd + h * hd * d
        counts["attn"] = L * per_layer_attn
        expert = 3 * d * cfg.moe_d_ff
        n_moe_layers = L - cfg.first_dense_layers
        counts["experts"] = n_moe_layers * cfg.n_experts * expert
        counts["shared_experts"] = n_moe_layers * cfg.n_shared_experts * expert
        counts["router"] = n_moe_layers * d * cfg.n_experts
        counts["mlp"] = cfg.first_dense_layers * 3 * d * (cfg.dense_d_ff or cfg.d_ff)
    else:  # dense transformer families (incl. audio/vlm backbones)
        per_layer_attn = d * (h + 2 * hk) * hd + h * hd * d
        counts["attn"] = L * per_layer_attn
        glu = cfg.mlp_kind in ("swiglu", "geglu")
        counts["mlp"] = L * (3 if glu else 2) * d * cfg.d_ff

    total = sum(counts.values())
    active = total
    if cfg.family == "moe":
        n_moe_layers = L - cfg.first_dense_layers
        active = (total - counts["experts"]
                  + n_moe_layers * cfg.moe_top_k * 3 * d * cfg.moe_d_ff)
    counts["total"] = total
    counts["active"] = active
    return counts


def step_flops(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Analytic FLOPs for the cell's step (whole program, all devices).

    train:   6 * N_active * tokens  (fwd 2x + bwd 4x)  + attention terms
    prefill: 2 * N_active * tokens                     + attention terms
    decode:  2 * N_active * batch (one token each)     + cache attention
    Attention term (causal): 2 * 2 * h*hd * S^2/2 per layer per sequence =
    fwd QK^T + PV; trained adds the 2x backward factor.
    """
    pc = param_count(cfg)
    n_active = pc["active"] - pc.get("embed", 0)  # lookups are not matmul FLOPs
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h = cfg.n_heads

    if shape.kind == "train":
        tokens = b * s
        core = 6 * n_active * tokens
        attn = 0
        if cfg.family not in ("ssm",):
            w = cfg.window if cfg.window else s
            eff = min(w, s)
            # per layer: QK^T + PV = 2 * 2 * s * eff/2 * (h*hd), x3 for bwd
            n_attn = _n_attn_layers(cfg)
            attn = 3 * n_attn * b * (2 * 2 * s * (eff / 2) * h * hd)
        return {"core": core, "attn": attn, "total": core + attn, "tokens": tokens}

    if shape.kind == "prefill":
        tokens = b * s
        core = 2 * n_active * tokens
        attn = 0
        if cfg.family not in ("ssm",):
            w = cfg.window if cfg.window else s
            eff = min(w, s)
            n_attn = _n_attn_layers(cfg)
            attn = n_attn * b * (2 * 2 * s * (eff / 2) * h * hd)
        return {"core": core, "attn": attn, "total": core + attn, "tokens": tokens}

    # decode: 1 token per sequence against a cache of s
    tokens = b
    core = 2 * n_active * tokens
    attn = 0
    if cfg.family == "moe" and cfg.kv_lora:
        # MLA absorbed decode: scores+ctx over latent, per layer:
        lat = cfg.kv_lora + cfg.qk_rope_dim
        attn = cfg.n_layers * b * (2 * h * s * lat * 2
                                   + 2 * h * (cfg.qk_nope_dim * cfg.kv_lora) * 2)
    elif cfg.family == "ssm":
        attn = 0  # state update counted in core projections approx
    else:
        w = cfg.window if cfg.window else s
        eff = min(w, s)
        n_attn = _n_attn_layers(cfg)
        attn = n_attn * b * (2 * 2 * eff * cfg.n_kv_heads * (h // cfg.n_kv_heads) * hd)
    return {"core": core, "attn": attn, "total": core + attn, "tokens": tokens}


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("R", "R", "A")
        return (cfg.n_layers // len(pat)) * pat.count("A")
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def weight_bytes(cfg: ArchConfig, fp4: bool = True) -> int:
    """HBM bytes of resident weights (FP4 packed: 0.5 B/param + scales ~
    1/column; bf16 otherwise) — the quantity the paper's Table 10 streams."""
    pc = param_count(cfg)
    per = 0.5 if fp4 else 2.0
    return int(pc["total"] * per)
