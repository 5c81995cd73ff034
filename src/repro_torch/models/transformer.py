"""Generic decoder-only transformer LM (the dense GQA/MHA family), in PyTorch.

The param tree is the JAX package's, leaf for leaf: layer params are
stacked ``(L, ...)`` under ``layers`` (``layers/attn/wq/{codes,scale,b}``,
``layers/mlp/w_down/...``, ``layers/ln1/scale``, ...), beside ``embed``,
``final_norm`` and ``lm_head``. Where the reference scans over the stack,
this module runs a Python loop over layer views. Caches are updated in
place (see ``layers.attn_apply``).

Not ported yet: the paged cache (and its speculative rewind), M-RoPE and
windowed attention, sinusoidal positions, multi-codebook heads and
stub-embedding inputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.models import cache_utils
from repro_torch.models import layers as L


class TransformerLM:
    def __init__(self, cfg: ArchConfig):
        if (cfg.window or cfg.mrope_sections or cfg.n_codebooks or cfg.input_embeds
                or cfg.rope_fraction == 0.0):
            raise NotImplementedError(
                f"{cfg.name}: windowed attention, M-RoPE, sinusoidal positions, "
                "multi-codebook heads and stub-embedding inputs are not ported "
                "yet (ROADMAP Queue 1 items 4-5)")
        self.cfg = cfg
        self.attn_cfg = L.AttnConfig(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias,
            rope_theta=cfg.rope_theta,
            rope_fraction=cfg.rope_fraction,
            q_chunk=cfg.q_chunk,
        )

    # ------------------------------------------------------------------ init
    def _layer_init(self, gen: torch.Generator, ccfg: CascadeConfig, device) -> dict:
        cfg = self.cfg
        return {
            "ln1": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "attn": L.attn_init(gen, self.attn_cfg, ccfg, device=device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, ccfg, device=device),
        }

    def init_params(self, seed: int, ccfg: CascadeConfig, device=None) -> dict:
        """Random params from ``seed``. In ``serve_fp4`` mode every matrix is
        quantized as it is drawn (full width never holds a dense f32 tree)."""
        cfg = self.cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = {
            "layers": cache_utils.stack_layers(
                [self._layer_init(gen, ccfg, device) for _ in range(cfg.n_layers)]),
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=ccfg.compute_dtype,
                                  device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = cascade.linear_init(gen, cfg.d_model, cfg.vocab, ccfg,
                                                    device=device)
        return params

    # --------------------------------------------------------------- forward
    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        return L.embed_apply(params["embed"], batch["tokens"])

    def _head(self, params: dict, x: torch.Tensor, pending: torch.Tensor,
              ccfg: CascadeConfig) -> torch.Tensor:
        """Logits of the rows of ``x + pending`` (the last layer's MLP output
        is added inside the final norm)."""
        cfg = self.cfg
        x, _ = L.add_norm_apply(params["final_norm"], x, pending, cfg.norm_type,
                                use_kernel=ccfg.use_kernel)
        if cfg.tie_embeddings:
            logits = L.tied_head(params["embed"], x, ccfg.compute_dtype)
        else:
            logits = cascade.linear_apply(params["lm_head"], x, ccfg)
        return logits.to(torch.float32)

    def _block(self, lp: dict, x: torch.Tensor, ccfg: CascadeConfig, cache, mode: str,
               max_len: int | None = None, n_valid=None, kv_len: int | None = None,
               pending: torch.Tensor | None = None):
        """One layer. ``pending``: the previous layer's MLP output, not yet
        added to the residual stream ``x``; the add runs inside ln1 (one
        add-norm), as this layer's attention output's runs inside ln2.
        Returns (x, this layer's MLP output, still to be added, new cache)."""
        cfg = self.cfg
        uk = ccfg.use_kernel
        if pending is None:
            u = L.norm_apply(lp["ln1"], x, cfg.norm_type, use_kernel=uk)
        else:
            u, x = L.add_norm_apply(lp["ln1"], x, pending, cfg.norm_type, use_kernel=uk)
        h, new_cache = L.attn_apply(lp["attn"], u, self.attn_cfg, ccfg, cache=cache, mode=mode,
                                    max_len=max_len, n_valid=n_valid, kv_len=kv_len)
        u, x = L.add_norm_apply(lp["ln2"], x, h, cfg.norm_type, use_kernel=uk)
        return x, L.mlp_apply(lp["mlp"], u, cfg.mlp_kind, ccfg), new_cache

    def _layers(self, params: dict, x: torch.Tensor, ccfg: CascadeConfig, mode: str,
                cache=None, **kw):
        """Run every layer: (x, the last layer's MLP output still to be added,
        the per-layer caches)."""
        pending, caches = None, []
        for i in range(self.cfg.n_layers):
            c = cache_utils.layer_view(cache["layers"], i) if cache is not None else None
            x, pending, nc = self._block(cache_utils.layer_view(params["layers"], i), x, ccfg, c,
                                         mode, pending=pending, **kw)
            caches.append(nc)
        return x, pending, caches

    def forward(self, params: dict, batch: dict, ccfg: CascadeConfig) -> torch.Tensor:
        """Full-sequence forward (no cache): logits (B, S, V) f32."""
        x, pending, _ = self._layers(params, self._embed(params, batch), ccfg, "full")
        return self._head(params, x, pending, ccfg)

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        cfg = self.cfg
        device = resolve_device(device)
        one = L.attn_cache_init(batch, max_len, self.attn_cfg, dtype, device=device)
        return {"layers": {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
                           for k, v in one.items()}}

    def prefill(self, params: dict, batch: dict, ccfg: CascadeConfig,
                max_len: int | None = None):
        """Prompt forward that also builds the cache: logits of the last
        position (B, 1, V) and ``{"layers": {k, v, pos}}`` stacked (L, ...)."""
        x, pending, caches = self._layers(params, self._embed(params, batch), ccfg, "prefill",
                                          max_len=max_len)
        return (self._head(params, x[:, -1:], pending[:, -1:], ccfg),
                {"layers": cache_utils.stack_layers(caches)})

    def decode_step(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig):
        """One token per row against ``cache`` (updated in place)."""
        x, pending, _ = self._layers(params, self._embed(params, batch), ccfg, "decode", cache)
        return self._head(params, x, pending, ccfg), cache

    def prefill_extend(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                       n_valid=None, all_logits: bool = False, kv_len: int | None = None):
        """Append a (possibly right-padded) token chunk to ``cache`` (in place).

        Only the first ``n_valid`` chunk tokens are real. Returns logits of
        the last valid token (B, 1, V), or of every chunk position (B, S, V)
        with ``all_logits``, and the cache. ``kv_len``: a host-side bound on
        the keys any row sees (its position plus the chunk length; see
        ``layers.attn_apply``), None for the whole cache.
        """
        nv = batch["tokens"].shape[1] if n_valid is None else n_valid
        x, pending, _ = self._layers(params, self._embed(params, batch), ccfg, "extend", cache,
                                     n_valid=nv, kv_len=kv_len)
        if not all_logits:
            x, pending = (cache_utils.take_last_valid(t, nv) for t in (x, pending))
        return self._head(params, x, pending, ccfg), cache

    # --------------------------------------------------- speculative decode
    def spec_verify(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                    ckpt: dict | None = None, kv_len: int | None = None):
        """Score a (B, 1+K) draft chunk in ONE extend pass: per-position
        logits (B, 1+K, V), the cache advanced in place, and a rewind
        checkpoint (a copy of the K/V rows the chunk overwrites, and
        ``pos``). A checkpoint from an earlier call of the same shapes may be
        passed as ``ckpt`` to be filled again; ``kv_len`` as in
        :meth:`prefill_extend`."""
        s = batch["tokens"].shape[1]
        snap = cache_utils.seq_rows_snapshot(cache["layers"], s,
                                             out=None if ckpt is None else ckpt["layers"])
        logits, cache = self.prefill_extend(params, batch, cache, ccfg, all_logits=True,
                                            kv_len=kv_len)
        return logits, cache, {"layers": snap}

    def spec_rewind(self, cache: dict, ckpt: dict, keep: torch.Tensor) -> dict:
        """Per-slot rewind after a verify pass, in place: the first
        ``keep[b]`` chunk tokens stay committed, the rejected rows are
        restored and ``pos`` rewinds to ``pos0 + keep[b]``."""
        cache_utils.seq_rows_restore(cache["layers"], ckpt["layers"], keep)
        return cache

    # ----------------------------------------- continuous batching cache API
    def write_cache(self, cache: dict, sub: dict, i: int) -> dict:
        return cache_utils.write_cache(cache, sub, i)
