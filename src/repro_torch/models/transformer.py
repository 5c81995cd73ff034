"""Generic decoder-only transformer LM (the dense GQA/MHA family), in PyTorch.

The param tree is the JAX package's, leaf for leaf: layer params are
stacked ``(L, ...)`` under ``layers`` (``layers/attn/wq/{codes,scale,b}``,
``layers/mlp/w_down/...``, ``layers/ln1/scale``, ...), beside ``embed``,
``final_norm`` and ``lm_head``. Where the reference scans over the stack,
this module runs a Python loop over layer views. Caches are updated in
place (see ``layers.attn_apply``). Besides the dense cache, a paged one
(``init_paged_cache``): a page pool per layer, read and written through a
block table the caller passes in the batch (``batch["block_table"]``).

A windowed config (local attention) keeps ring-buffer caches
(``layers.attn_apply``); its context is then not bounded by the cache, and
it has no page layout.

The modality-stub backbones run here too. With ``input_embeds`` (the stub
frontends of qwen2-vl-2b and musicgen-large) the batch carries
``inputs_embeds`` (B, S, d) instead of ``tokens``; the tree then has no
``embed`` leaf and its head is untied, ``vocab * max(1, n_codebooks)``
wide. A multi-codebook head (musicgen) gives (B, S, n_codebooks, vocab)
logits. ``rope_fraction == 0`` (musicgen) adds sinusoidal positions at
``batch["pos_offset"]`` (default 0) to the embeddings. Qwen2-VL's M-RoPE
reads ``batch["positions"]`` (3, B, S) in ``forward``, ``prefill`` and
``decode_step``; ``prefill_extend`` and ``spec_verify`` pass no positions,
as the reference's do, so an M-RoPE config raises ``ValueError`` there.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.distributed import sharding
from repro_torch.models import cache_utils
from repro_torch.models import layers as L
from repro_torch.models import remat as R


class TransformerLM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.attn_cfg = L.AttnConfig(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias,
            rope_theta=cfg.rope_theta,
            rope_fraction=cfg.rope_fraction,
            window=cfg.window,
            mrope_sections=cfg.mrope_sections,
            q_chunk=cfg.q_chunk,
        )
        # a windowed config holds O(window) ring state: the serving context
        # is not bounded by the cache
        self.unbounded_context = self.attn_cfg.window > 0

    # ------------------------------------------------------------------ init
    def _layer_init(self, gen: torch.Generator, ccfg: CascadeConfig, device) -> dict:
        cfg = self.cfg
        return {
            "ln1": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "attn": L.attn_init(gen, self.attn_cfg, ccfg, device=device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, ccfg, device=device),
        }

    def init_params(self, seed: int, ccfg: CascadeConfig, device=None,
                    place=None) -> dict:
        """Random params from ``seed``. In ``serve_fp4`` mode every matrix is
        quantized as it is drawn (full width never holds a dense f32 tree).
        A stub-embedding config has no ``embed`` leaf and an untied head of
        ``vocab`` columns per codebook.
        ``place`` (``distributed.sharding.param_placer``) takes each
        fragment of the tree (a layer, the embedding, the head) as soon as
        it is drawn and keeps this rank's bands of it, so a mesh rank never
        holds more than one whole fragment beside its bands."""
        cfg = self.cfg
        device = resolve_device(device)
        gen = seeded_generator(device, seed)
        place = place or (lambda fragment: fragment)
        params = {
            "layers": cache_utils.stack_layers(
                [place(self._layer_init(gen, ccfg, device)) for _ in range(cfg.n_layers)]),
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
        }
        if not cfg.input_embeds:
            params.update(place({"embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                                       dtype=ccfg.compute_dtype,
                                                       device=device)}))
        if not self._tied:
            params.update(place({"lm_head": cascade.linear_init(
                gen, cfg.d_model, cfg.vocab * max(1, cfg.n_codebooks), ccfg, device=device)}))
        return params

    @property
    def _tied(self) -> bool:
        return self.cfg.tie_embeddings and not self.cfg.input_embeds

    # --------------------------------------------------------------- forward
    def _embed(self, params: dict, batch: dict, ccfg: CascadeConfig) -> torch.Tensor:
        """The token embeddings, or the stub frontend's ``inputs_embeds`` in
        the compute dtype; plus, for a config without RoPE (musicgen), the
        sinusoid of positions ``pos_offset`` on (one offset for every row)."""
        cfg = self.cfg
        if cfg.input_embeds:
            x = batch["inputs_embeds"].to(ccfg.compute_dtype)
        else:
            x = L.embed_apply(params["embed"], batch["tokens"])
        if cfg.rope_fraction == 0.0:
            pe = L.sinusoidal_positions(x.shape[1], cfg.d_model, batch.get("pos_offset", 0),
                                        device=x.device)
            x = x + pe[None].to(x.dtype)
        return x

    def _head(self, params: dict, x: torch.Tensor, pending: torch.Tensor,
              ccfg: CascadeConfig) -> torch.Tensor:
        """Logits of the rows of ``x + pending`` (the last layer's MLP output
        is added inside the final norm): (B, S, V), or (B, S, n_codebooks, V)
        from a multi-codebook head."""
        cfg = self.cfg
        x, _ = L.add_norm_apply(params["final_norm"], x, pending, cfg.norm_type,
                                use_kernel=ccfg.use_kernel)
        if self._tied:
            logits = L.tied_head(params["embed"], x, ccfg.compute_dtype)
        else:
            logits = cascade.linear_apply(params["lm_head"], x, ccfg)
        if cfg.n_codebooks:
            logits = logits.reshape(*logits.shape[:2], cfg.n_codebooks, cfg.vocab)
        return logits.to(torch.float32)

    def _block(self, lp: dict, x: torch.Tensor, ccfg: CascadeConfig, cache, mode: str,
               max_len: int | None = None, n_valid=None, kv_len: int | None = None,
               pending: torch.Tensor | None = None, positions: torch.Tensor | None = None,
               seq: bool = False):
        """One layer. ``pending``: the previous layer's MLP output, not yet
        added to the residual stream ``x``; the add runs inside ln1 (one
        add-norm), as this layer's attention output's runs inside ln2.
        ``positions``: the rotary positions (see ``layers.attn_apply``).
        ``seq``: x and pending are this rank's rows (sequence parallelism);
        the norms run on them, the rows are gathered before attention and
        the MLP, and their output linears return the rank's rows.
        Returns (x, this layer's MLP output, still to be added, new cache)."""
        cfg = self.cfg
        lp = L.seq_norms(lp, seq, ("ln1", "ln2"))
        uk = ccfg.use_kernel
        if pending is None:
            u = L.norm_apply(lp["ln1"], x, cfg.norm_type, use_kernel=uk)
        else:
            u, x = L.add_norm_apply(lp["ln1"], x, pending, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        with sharding.rows_out(seq):
            h, new_cache = L.attn_apply(lp["attn"], u, self.attn_cfg, ccfg, positions=positions,
                                        cache=cache, mode=mode, max_len=max_len,
                                        n_valid=n_valid, kv_len=kv_len)
        u, x = L.add_norm_apply(lp["ln2"], x, h, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        with sharding.rows_out(seq):
            return x, L.mlp_apply(lp["mlp"], u, cfg.mlp_kind, ccfg), new_cache

    def _layers(self, params: dict, x: torch.Tensor, ccfg: CascadeConfig, mode: str,
                cache=None, block_table: torch.Tensor | None = None, remat: bool = False,
                remat_policy: str = "dots", **kw):
        """Run every layer: (x, the last layer's MLP output still to be added,
        the per-layer caches). ``block_table``: a paged cache's (B, nb) page
        ids, handed to every layer's attention. ``remat``: each layer one
        checkpointed region under ``remat_policy`` (``models.remat``); the
        un-added MLP output (``pending``) passes from region to region."""
        def block(lp, x, c, pending, seq):
            return self._block(lp, x, ccfg, c, mode, pending=pending, seq=seq, **kw)

        body = R.layer_fn(block, remat, remat_policy)
        plain = R.layer_fn(block, False)
        x, seq = L.seq_layers(x, mode)
        pending, caches = None, []
        for i, lp in enumerate(self._layer_list(params)):
            c = cache_utils.layer_view(cache["layers"], i) if cache is not None else None
            if block_table is not None:
                c = dict(c, block_table=block_table)
            run = body if self._remat_layer(params, i) else plain
            x, pending, nc = run(lp, x, c, pending, seq)
            caches.append(nc)
        x, pending = L.seq_whole(seq, x, pending)
        return x, pending, caches

    def _remat_layer(self, params: dict, i: int) -> bool:
        """Whether layer ``i`` is a checkpointed region under ``remat``: all are."""
        return True

    def _layer_list(self, params: dict) -> list:
        """Every layer's params, in order (``cache_utils.unstack_layers``)."""
        return cache_utils.unstack_layers(params["layers"])

    @staticmethod
    def _positions(batch: dict) -> dict:
        """The batch's explicit rotary positions as a ``_block`` keyword, if
        it has any (only dense-family blocks take them)."""
        return {"positions": batch["positions"]} if "positions" in batch else {}

    def forward(self, params: dict, batch: dict, ccfg: CascadeConfig, remat: bool = False,
                remat_policy: str = "dots") -> torch.Tensor:
        """Full-sequence forward (no cache; the training forward): logits (B, S,
        V) f32, each layer checkpointed under ``remat`` (see :meth:`_layers`)."""
        x, pending, _ = self._layers(params, self._embed(params, batch, ccfg), ccfg, "full",
                                     remat=remat, remat_policy=remat_policy,
                                     **self._positions(batch))
        return self._head(params, x, pending, ccfg)

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        one = self._attn_cache(batch, max_len, dtype, resolve_device(device))
        return {"layers": {k: v[None].repeat((self.cfg.n_layers,) + (1,) * v.dim())
                           for k, v in one.items()}}

    def _attn_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        return L.attn_cache_init(batch, max_len, self.attn_cfg, dtype, device=device)

    # ------------------------------------------------------- paged cache API
    @property
    def paged_attention(self) -> bool:
        """Full attention pages; a ring buffer does not (its cache runs
        dense, as in the reference), nor does a multi-codebook model (it is
        served slot-wise)."""
        return self.attn_cfg.window == 0 and not self.cfg.n_codebooks

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         dtype=torch.bfloat16, device=None) -> dict:
        """``{"layers": {"k", "v": (L, P, ps, Hkv, D), "pos": (L, B)}}``."""
        one = self._attn_cache_paged(batch, num_pages, page_size, dtype, resolve_device(device))
        return {"layers": {k: v[None].repeat((self.cfg.n_layers,) + (1,) * v.dim())
                           for k, v in one.items()}}

    def _attn_cache_paged(self, batch: int, num_pages: int, page_size: int, dtype,
                          device) -> dict:
        return L.attn_cache_init_paged(batch, num_pages, page_size, self.attn_cfg, dtype,
                                       device=device)

    def paged_copy_page(self, cache: dict, src: int, dst: int) -> dict:
        """Copy physical page ``src`` to ``dst`` in every layer's pools, in
        place: the device half of the prefix cache's copy-on-write (a
        partly matched shared page is cloned before a new stream writes
        into it)."""
        for name, buf in cache["layers"].items():
            if name != "pos":
                buf[:, dst].copy_(buf[:, src])
        return cache

    def prefill(self, params: dict, batch: dict, ccfg: CascadeConfig,
                max_len: int | None = None):
        """Prompt forward that also builds the cache: logits of the last
        position (B, 1, V) and ``{"layers": {k, v, pos}}`` stacked (L, ...)."""
        x, pending, caches = self._layers(params, self._embed(params, batch, ccfg), ccfg,
                                          "prefill", max_len=max_len, **self._positions(batch))
        return (self._head(params, x[:, -1:], pending[:, -1:], ccfg),
                {"layers": cache_utils.stack_layers(caches)})

    def decode_step(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig):
        """One token per row against ``cache`` (updated in place; a paged
        cache through ``batch["block_table"]``)."""
        x, pending, _ = self._layers(params, self._embed(params, batch, ccfg), ccfg, "decode",
                                     cache, block_table=batch.get("block_table"),
                                     **self._positions(batch))
        return self._head(params, x, pending, ccfg), cache

    def prefill_extend(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                       n_valid=None, all_logits: bool = False, kv_len: int | None = None):
        """Append a (possibly right-padded) token chunk to ``cache`` (in place).

        Only the first ``n_valid`` chunk tokens are real. Returns logits of
        the last valid token (B, 1, V), or of every chunk position (B, S, V)
        with ``all_logits``, and the cache. ``kv_len``: a host-side bound on
        the keys any row sees (its position plus the chunk length; see
        ``layers.attn_apply``), None for the whole cache. A paged cache is
        written through ``batch["block_table"]``.
        """
        x = self._embed(params, batch, ccfg)
        nv = x.shape[1] if n_valid is None else n_valid
        x, pending, _ = self._layers(params, x, ccfg, "extend", cache,
                                     block_table=batch.get("block_table"), n_valid=nv,
                                     kv_len=kv_len)
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
        :meth:`prefill_extend`. A paged checkpoint copies the rows through
        ``batch["block_table"]`` and carries that table."""
        s = batch["tokens"].shape[1]
        out = None if ckpt is None else ckpt["layers"]
        bt = batch.get("block_table")
        if bt is None:
            snap = cache_utils.seq_rows_snapshot(cache["layers"], s, out=out)
        else:
            snap = cache_utils.paged_rows_snapshot(cache["layers"], bt, s, out=out)
        logits, cache = self.prefill_extend(params, batch, cache, ccfg, all_logits=True,
                                            kv_len=kv_len)
        return logits, cache, ({"layers": snap} if bt is None
                               else {"layers": snap, "block_table": bt})

    def spec_rewind(self, cache: dict, ckpt: dict, keep: torch.Tensor) -> dict:
        """Per-slot rewind after a verify pass, in place: the first
        ``keep[b]`` chunk tokens stay committed, the rejected rows are
        restored (a paged cache's through the table its checkpoint carries)
        and ``pos`` rewinds to ``pos0 + keep[b]``."""
        bt = ckpt.get("block_table")
        if bt is None:
            cache_utils.seq_rows_restore(cache["layers"], ckpt["layers"], keep)
        else:
            cache_utils.paged_rows_restore(cache["layers"], ckpt["layers"], bt, keep)
        return cache

    # ----------------------------------------- continuous batching cache API
    def write_cache(self, cache: dict, sub: dict, i: int) -> dict:
        return cache_utils.write_cache(cache, sub, i)

    def cache_pspecs(self, cache: dict, mesh, data_axis: str = "data"):
        """Mesh placement of a stacked cache: each leaf's probed slot axis
        over ``data_axis`` (``cache_utils.slot_pspecs``)."""
        return cache_utils.model_cache_pspecs(self, cache, mesh, data_axis)
