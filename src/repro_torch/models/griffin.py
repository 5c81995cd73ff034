"""RecurrentGemma / Griffin (arXiv:2402.19427), in PyTorch: RG-LRU blocks
and local-attention blocks, pattern (R, R, A) repeating.

The reference (``src/repro/models/griffin.py``) scans ``n_groups`` stacked
(R, R, A) groups and a trailing list of R blocks; this module holds ONE
list of ``n_layers`` layer dicts under ``params["layers"]``, in order
(group 0's R, R, A, group 1's, ..., then the tail), beside ``embed``,
``final_norm`` and ``lm_head`` (``convert.params_from_numpy`` unstacks the
reference's groups into it). The cache keeps the R blocks' state stacked
under ``layers`` and the A blocks' ring buffers under ``attn``:
``{"layers": {"conv": (Lr, B, w-1, lru), "h": (Lr, B, lru) f32}, "attn":
{"k", "v": (La, B, window, Hkv, D), "slot_pos": (La, B, window), "pos":
(La, B)}}``, updated in place.

The RG-LRU recurrence ``h_t = a_t * h_{t-1} + g_t`` (gates, ``softplus``,
``exp`` and the sqrt(1 - a^2) input scale in f32, as in the reference):

* decode takes one step;
* extend (admission chunks, the verify pass) steps through the chunk in
  order with decode's two operations, ``a * h`` then ``+ g`` (no fused
  multiply-add), so on the card a verify pass's per-token states equal the
  decode steps' bit for bit (with ``use_kernel`` its conv runs decode's
  arithmetic too). The reference runs an associative scan there, which
  sums in another order: the port is held to it at an f32 tolerance;
* full-length ``forward``/``prefill`` run a log-depth (Hillis-Steele) scan
  in plain PyTorch, the reference's combine in another association.

No RG-LRU kernel: the reference computes the recurrence outside Pallas, so
it runs as plain PyTorch ops; its projections go through the FP4 matmul,
its norms through the norm kernel (the residual adds folded in, as in
``TransformerLM``), local attention through flash attention (extend,
prefill) and decode attention (decode). ``unbounded_context`` is set for a
windowed config: the ring holds O(window) and the recurrence O(1) state, so
the engine bounds no prompt by ``max_len``.

Under a mesh policy (``distributed/sharding.py``) every projection of the
recurrent blocks (``wa``, ``wx``, ``w_gate``, ``w_in``, ``w_out``) runs on
its column band and gathers it (``core/cascade.py``), so the RG-LRU and the
conv run on whole activations and, in a mesh engine, their state stays
whole on every model rank; local attention runs on the rank's KV heads
where they divide the axis (``layers.attn_apply``; recurrentgemma-2b's one
KV head does not, so the engine keeps its rings whole). Under the dry
run's ``cache_specs`` placement the ``h`` and ``conv`` leaves hold a band
of the channels and the rings a band of their rows: decode runs the conv
and the RG-LRU on the rank's channels (the gates from ``wa``/``wx``/
``w_gate`` left as the rank's columns), gathers the conv output (which
``wa``/``wx`` contract whole) and hands the gated band to ``w_out``
(gathered first unless megatron row-bands it), bit-equal to the unsharded
step; the rings take ``layers.attn_apply``'s time band. Extend raises on
such a cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.distributed import sharding
from repro_torch.models import cache_utils
from repro_torch.models import layers as L
from repro_torch.models import remat as R
from repro_torch.models.ssm import (_causal_conv, _conv_decode, _conv_extend, _conv_steps,
                                    conv_decode_banded, conv_prefill_state)

_C = 8.0  # RG-LRU gate sharpness constant (Griffin paper)


def _columns(params: dict, x: torch.Tensor, ccfg: CascadeConfig, c0: int,
             width: int) -> torch.Tensor:
    """Columns ``[c0, c0 + width)`` of a linear's output: the whole output
    when that is all of it, the rank's column band left unjoined where the
    mesh policy bands it so, else a slice of the whole output."""
    if cascade.banded(params) == -1:
        y = cascade.linear_apply(params, x, ccfg, gather=False)
        if y.shape[-1] == width:
            return y
        y = cascade.gather_columns(y)
    else:
        y = cascade.linear_apply(params, x, ccfg)
    return y if c0 == 0 and y.shape[-1] == width else y[..., c0:c0 + width]


def _log_depth_scan(a: torch.Tensor, g: torch.Tensor):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + g_t`` from h = 0 along axis
    1, in log2(S) doubling steps: returns (prod of a up to t, h_t)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        a_prev, g_prev = a[:, :-shift], g[:, :-shift]
        g = torch.cat([g[:, :shift], g_prev * a[:, shift:] + g[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a_prev * a[:, shift:]], dim=1)
        shift *= 2
    return a, g


class GriffinLM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.lru = cfg.lru_width or cfg.d_model
        self.attn_cfg = L.AttnConfig(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
            window=cfg.window,
            q_chunk=cfg.q_chunk,
        )
        pat = cfg.block_pattern or ("R", "R", "A")
        self.group = pat
        self.n_groups = cfg.n_layers // len(pat)
        self.n_tail = cfg.n_layers - self.n_groups * len(pat)   # trailing R blocks
        #: each layer's kind, in order
        self.kinds = list(pat) * self.n_groups + ["R"] * self.n_tail
        # windowed attention and O(1) recurrent state: the serving context
        # is not bounded by the cache
        self.unbounded_context = self.attn_cfg.window > 0

    @property
    def n_rec(self) -> int:
        return self.kinds.count("R")

    @property
    def n_attn(self) -> int:
        return self.kinds.count("A")

    # ------------------------------------------------------------------ init
    def _rblock_init(self, gen: torch.Generator, ccfg: CascadeConfig, device) -> dict:
        cfg, lru = self.cfg, self.lru
        lin = lambda din, dout, bias=False: cascade.linear_init(gen, din, dout, ccfg,
                                                                use_bias=bias, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "ln": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "w_in": lin(cfg.d_model, lru),
            "w_gate": lin(cfg.d_model, lru),
            "conv_w": torch.randn((cfg.conv_width, lru), generator=gen, **f32) * 0.1,
            "conv_b": torch.zeros((lru,), **f32),
            "wa": lin(lru, lru, True),
            "wx": lin(lru, lru, True),
            "lam": torch.linspace(2.0, 5.0, lru, **f32),            # softplus^-1(a) init
            "w_out": lin(lru, cfg.d_model),
            "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, ccfg, device=device),
        }

    def _ablock_init(self, gen: torch.Generator, ccfg: CascadeConfig, device) -> dict:
        cfg = self.cfg
        return {
            "ln": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "attn": L.attn_init(gen, self.attn_cfg, ccfg, device=device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, ccfg, device=device),
        }

    def init_params(self, seed: int, ccfg: CascadeConfig, device=None,
                    place=None) -> dict:
        """Random params from ``seed`` in the port's tree; in ``serve_fp4``
        mode every matrix is quantized as it is drawn.
        ``place`` (``distributed.sharding.param_placer``) takes each
        fragment of the tree (a layer, the embedding, the head) as soon as
        it is drawn and keeps this rank's bands of it, so a mesh rank never
        holds more than one whole fragment beside its bands."""
        cfg = self.cfg
        device = resolve_device(device)
        gen = seeded_generator(device, seed)
        place = place or (lambda fragment: fragment)
        params = {
            "layers": [place(self._rblock_init(gen, ccfg, device) if kind == "R"
                             else self._ablock_init(gen, ccfg, device)) for kind in self.kinds],
            "final_norm": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
        }
        params.update(place({"embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                                   dtype=ccfg.compute_dtype, device=device)}))
        params.update(place({"lm_head": cascade.linear_init(gen, cfg.d_model, cfg.vocab, ccfg,
                                                            device=device)}))
        return params

    # --------------------------------------------------------------- RG-LRU
    def _rglru(self, lp: dict, y: torch.Tensor, ccfg: CascadeConfig, h0=None,
               mode: str = "full", n_valid=None, cols: tuple | None = None):
        """y: (b, s, lru) post-conv input. Returns (out in y's dtype, h_last
        (b, lru) f32, h_all): ``h_all`` is the f32 state after every step
        (b, s, lru) in extend mode (the rewind checkpoints), else None. In
        extend mode only the first ``n_valid`` steps are real: pad steps are
        the identity (a = 1, input 0), so the carried state lands on the
        ``n_valid`` boundary. ``cols`` (c0, width): decode on that band of
        the channels (``h0`` the band of the state; y whole, which ``wa``
        and ``wx`` contract); out and h are the band's."""
        c0, cw = cols if cols is not None else (0, y.shape[-1])
        r = torch.sigmoid(_columns(lp["wa"], y, ccfg, c0, cw).to(torch.float32))
        i = torch.sigmoid(_columns(lp["wx"], y, ccfg, c0, cw).to(torch.float32))
        if cols is not None:
            y = y[..., c0:c0 + cw]
        log_a = -_C * r * F.softplus(lp["lam"][c0:c0 + cw])          # (b, s, lru) <= 0
        s = y.shape[1]
        if mode == "extend" and n_valid is not None:
            nv = n_valid.reshape(-1, 1, 1) if isinstance(n_valid, torch.Tensor) else n_valid
            m = torch.arange(s, device=y.device)[None, :, None] < nv
            log_a = torch.where(m, log_a, 0.0)                      # pad: a = exp(0) = 1
        a = torch.exp(log_a)
        gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
                 * (i * y.to(torch.float32)))
        if mode == "extend" and n_valid is not None:
            gated = torch.where(m, gated, 0.0)                      # pad: zero input
        if mode == "decode":
            h = a[:, 0] * h0
            h = h + gated[:, 0]
            return h[:, None].to(y.dtype), h, None
        if mode == "extend":
            # in order, with decode's two operations a step
            h, hs = h0, []
            for j in range(s):
                h = a[:, j] * h
                h = h + gated[:, j]
                hs.append(h)
            h_all = torch.stack(hs, dim=1)
            return h_all.to(y.dtype), h, h_all
        aa, hh = _log_depth_scan(a, gated)
        if h0 is not None:
            hh = hh + aa * h0[:, None]
        return hh.to(y.dtype), hh[:, -1], None

    # ---------------------------------------------------------------- blocks
    def _rblock(self, lp: dict, x: torch.Tensor, ccfg: CascadeConfig, cache=None,
                mode: str = "full", n_valid=None, collect: dict | None = None,
                pending: torch.Tensor | None = None, seq: bool = False):
        """One recurrent block (``seq``: sequence parallelism, as
        ``TransformerLM._block``'s). ``pending``: the previous block's MLP output,
        not yet added to ``x`` (added inside this block's first norm).
        ``decode``/``extend`` update ``cache`` ({conv, h}) in place;
        ``prefill`` returns a new one. ``collect`` (a verify chunk of s
        tokens): this layer's checkpoint, filled in place with the raw conv
        input window over the chunk ("conv": (B, w-1+s, lru)) and the state
        before the chunk and after each token ("h": (B, s+1, lru) f32).
        Returns (x, this block's MLP output still to be added, its cache)."""
        cfg = self.cfg
        lp = L.seq_norms(lp, seq, ("ln", "ln2"))
        uk = ccfg.use_kernel
        pol = sharding.get_activation_policy() if cache is not None else None
        h_band = pol.cache_band("h") if pol is not None else None
        conv_band = pol.cache_band("conv") if pol is not None else None
        if mode != "decode" and (h_band is not None or conv_band is not None):
            raise ValueError(
                "a Griffin cache banded over model (the dry run's cache_specs placement) runs "
                "decode only: extend and the speculative verify pass need its state whole")
        if pending is None:
            u = L.norm_apply(lp["ln"], x, cfg.norm_type, use_kernel=uk)
        else:
            u, x = L.add_norm_apply(lp["ln"], x, pending, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        # this rank's band of the channels, where the state holds one
        cols = None if h_band is None else (pol.model_rank * cache["h"].shape[-1],
                                             cache["h"].shape[-1])
        c0, cw = cols if cols is not None else (0, self.lru)
        gate = L._gelu(_columns(lp["w_gate"], u, ccfg, c0, cw).to(torch.float32))
        y = cascade.linear_apply(lp["w_in"], u, ccfg)
        new_cache = None
        if mode == "decode":
            if conv_band is not None:
                y_c, new_conv = conv_decode_banded(pol, y, cache["conv"], lp["conv_w"],
                                                   lp["conv_b"])
            else:
                y_c, new_conv = _conv_decode(y, cache["conv"], lp["conv_w"], lp["conv_b"])
            out, h_last, _ = self._rglru(lp, y_c, ccfg, cache["h"], mode, cols=cols)
        elif mode == "extend":
            if collect is not None and uk:
                y_c, new_conv, conv_full = _conv_steps(y, cache["conv"], lp["conv_w"],
                                                       lp["conv_b"])
            else:
                y_c, new_conv, conv_full = _conv_extend(y, cache["conv"], lp["conv_w"],
                                                        lp["conv_b"], n_valid)
            out, h_last, h_all = self._rglru(lp, y_c, ccfg, cache["h"], mode, n_valid)
            if collect is not None:
                collect["conv"].copy_(conv_full)
                collect["h"][:, 0].copy_(cache["h"])
                collect["h"][:, 1:].copy_(h_all)
        else:
            y_c = _causal_conv(y, lp["conv_w"], lp["conv_b"])
            out, h_last, _ = self._rglru(lp, y_c, ccfg, None, mode)
            if mode == "prefill":
                new_cache = {"conv": conv_prefill_state(y, cfg.conv_width), "h": h_last}
        if mode in ("decode", "extend"):
            cache["conv"].copy_(new_conv)
            cache["h"].copy_(h_last)
            new_cache = cache
        mixed_in = (out.to(torch.float32) * gate).to(x.dtype)
        if cols is not None and cascade.banded(lp["w_out"]) != -2:
            mixed_in = pol.gather_model(mixed_in, -1)       # w_out wants every channel
        with sharding.rows_out(seq):
            mixed = cascade.out_apply(lp["w_out"], mixed_in, ccfg)
        u, x = L.add_norm_apply(lp["ln2"], x, mixed, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        with sharding.rows_out(seq):
            return x, L.mlp_apply(lp["mlp"], u, cfg.mlp_kind, ccfg), new_cache

    def _ablock(self, lp: dict, x: torch.Tensor, ccfg: CascadeConfig, cache=None,
                mode: str = "full", max_len: int | None = None, n_valid=None,
                pending: torch.Tensor | None = None, seq: bool = False):
        """One local-attention block (``pending`` and ``seq`` as in
        :meth:`_rblock`)."""
        cfg = self.cfg
        lp = L.seq_norms(lp, seq, ("ln", "ln2"))
        uk = ccfg.use_kernel
        if pending is None:
            u = L.norm_apply(lp["ln"], x, cfg.norm_type, use_kernel=uk)
        else:
            u, x = L.add_norm_apply(lp["ln"], x, pending, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        with sharding.rows_out(seq):
            h, nc = L.attn_apply(lp["attn"], u, self.attn_cfg, ccfg, cache=cache, mode=mode,
                                 max_len=max_len, n_valid=n_valid)
        u, x = L.add_norm_apply(lp["ln2"], x, h, cfg.norm_type, use_kernel=uk)
        (u,) = L.seq_whole(seq, u)
        with sharding.rows_out(seq):
            return x, L.mlp_apply(lp["mlp"], u, cfg.mlp_kind, ccfg), nc

    def _layers(self, params: dict, x: torch.Tensor, ccfg: CascadeConfig, mode: str,
                cache=None, max_len: int | None = None, n_valid=None, collect=None,
                remat: bool = False, remat_policy: str = "dots"):
        """Run every layer in order; returns (x, the last layer's MLP output
        still to be added, the R blocks' caches, the A blocks' caches).
        ``collect``: a verify checkpoint's R stacks, filled layer by layer.
        ``remat``: each block one checkpointed region under ``remat_policy``
        (``models.remat``; the reference checkpoints an (R, R, A) group and
        leaves the tail out, the bits are the same)."""
        rblock = R.layer_fn(self._rblock, remat, remat_policy)
        ablock = R.layer_fn(self._ablock, remat, remat_policy)
        x, seq = L.seq_layers(x, mode)
        pending, rcaches, acaches = None, [], []
        for li, kind in enumerate(self.kinds):
            lp = params["layers"][li]
            if kind == "R":
                ri = len(rcaches)
                c = cache_utils.layer_view(cache["layers"], ri) if cache is not None else None
                ck = cache_utils.layer_view(collect, ri) if collect is not None else None
                x, pending, nc = rblock(lp, x, ccfg, c, mode, n_valid, ck, pending, seq)
                rcaches.append(nc)
            else:
                c = (cache_utils.layer_view(cache["attn"], len(acaches)) if cache is not None
                     else None)
                x, pending, nc = ablock(lp, x, ccfg, c, mode, max_len, n_valid, pending, seq)
                acaches.append(nc)
        x, pending = L.seq_whole(seq, x, pending)
        return x, pending, rcaches, acaches

    # --------------------------------------------------------------- api
    def _head(self, params: dict, x: torch.Tensor, pending: torch.Tensor,
              ccfg: CascadeConfig) -> torch.Tensor:
        x, _ = L.add_norm_apply(params["final_norm"], x, pending, self.cfg.norm_type,
                                use_kernel=ccfg.use_kernel)
        return cascade.linear_apply(params["lm_head"], x, ccfg).to(torch.float32)

    def forward(self, params: dict, batch: dict, ccfg: CascadeConfig, remat: bool = False,
                remat_policy: str = "dots") -> torch.Tensor:
        """Full-sequence forward (no cache; the training forward): logits (B, S,
        V) f32, each block checkpointed under ``remat`` (see :meth:`_layers`)."""
        x, pending, _, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                        ccfg, "full", remat=remat, remat_policy=remat_policy)
        return self._head(params, x, pending, ccfg)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Zero state for ``batch`` slots. The rings hold the window whatever
        ``max_len`` is; the recurrence stays f32."""
        cfg = self.cfg
        device = resolve_device(device)
        one = L.attn_cache_init(batch, max_len, self.attn_cfg, dtype, device=device)
        return {
            "layers": {
                "conv": torch.zeros((self.n_rec, batch, cfg.conv_width - 1, self.lru),
                                    dtype=dtype, device=device),
                "h": torch.zeros((self.n_rec, batch, self.lru), dtype=torch.float32,
                                 device=device),
            },
            "attn": {k: v[None].repeat((self.n_attn,) + (1,) * v.dim()) for k, v in one.items()},
        }

    def prefill(self, params: dict, batch: dict, ccfg: CascadeConfig,
                max_len: int | None = None):
        """Prompt forward that also builds the cache: logits of the last
        position (B, 1, V) and the cache (rings aligned to p % window)."""
        x, pending, rc, ac = self._layers(params, L.embed_apply(params["embed"],
                                                                batch["tokens"]),
                                          ccfg, "prefill", max_len=max_len)
        return (self._head(params, x[:, -1:], pending[:, -1:], ccfg),
                {"layers": cache_utils.stack_layers(rc), "attn": cache_utils.stack_layers(ac)})

    def decode_step(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig):
        """One token per row against ``cache`` (updated in place)."""
        x, pending, _, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                        ccfg, "decode", cache)
        return self._head(params, x, pending, ccfg), cache

    def prefill_extend(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                       n_valid=None, all_logits: bool = False, kv_len: int | None = None):
        """Append a (right-padded) token chunk to ``cache`` (in place): the
        rings advance without clobbering in-window entries, and the RG-LRU
        and conv states carry across chunks (pad steps are the identity).
        Returns logits of the last valid token (B, 1, V), or of every chunk
        position with ``all_logits``. ``kv_len`` (the full-attention
        families' live-key bound) is unused: a ring's keys are its window."""
        s = batch["tokens"].shape[1]
        nv = s if n_valid is None else n_valid
        x, pending, _, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                        ccfg, "extend", cache, n_valid=nv)
        if not all_logits:
            x, pending = (cache_utils.take_last_valid(t, nv) for t in (x, pending))
        return self._head(params, x, pending, ccfg), cache

    # --------------------------------------------------- speculative decode
    def spec_verify(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                    ckpt: dict | None = None, kv_len: int | None = None):
        """Score a (B, 1+K) draft chunk in ONE extend pass. Returns per-position
        logits (B, 1+K, V), the cache advanced in place, and the rewind
        checkpoint: for the A blocks a copy of the ring rows the chunk
        overwrites (and their ``slot_pos``, and ``pos``); for the R blocks the
        conv window over the chunk and the state before and after each token
        (``{"layers": {"conv": (Lr, B, w-1+s, lru), "h": (Lr, B, s+1, lru)},
        "attn": {...}}``). A checkpoint of the same shapes may be passed as
        ``ckpt`` to be filled again. ``kv_len`` is unused."""
        cfg = self.cfg
        b, s = batch["tokens"].shape
        dev = cache["layers"]["h"].device
        if ckpt is None:
            ckpt = {"layers": {
                "conv": torch.empty((self.n_rec, b, cfg.conv_width - 1 + s, self.lru),
                                    dtype=cache["layers"]["conv"].dtype, device=dev),
                "h": torch.empty((self.n_rec, b, s + 1, self.lru), dtype=torch.float32,
                                 device=dev)}}
        ckpt["attn"] = cache_utils.seq_rows_snapshot(cache["attn"], s, out=ckpt.get("attn"))
        x, pending, _, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                        ccfg, "extend", cache, collect=ckpt["layers"])
        return self._head(params, x, pending, ccfg), cache, ckpt

    def spec_rewind(self, cache: dict, ckpt: dict, keep: torch.Tensor) -> dict:
        """Per-slot rewind to ``keep[b]`` committed chunk tokens, in place: the
        rejected ring rows restored and ``pos`` rewound to ``pos0 + keep``;
        the checkpointed conv window and RG-LRU state at the accept boundary."""
        ck = ckpt["layers"]
        cache["layers"]["conv"].copy_(
            cache_utils.slice_rows_per_slot(ck["conv"], keep, 1, self.cfg.conv_width - 1))
        cache["layers"]["h"].copy_(cache_utils.slice_rows_per_slot(ck["h"], keep, 1, 1)[:, :, 0])
        cache_utils.seq_rows_restore(cache["attn"], ckpt["attn"], keep)
        return cache

    # ----------------------------------------- continuous batching cache API
    def cache_pspecs(self, cache: dict, mesh, data_axis: str = "data"):
        """Mesh placement of a stacked cache: each leaf's probed slot axis
        over ``data_axis`` (``cache_utils.slot_pspecs``)."""
        return cache_utils.model_cache_pspecs(self, cache, mesh, data_axis)

    def write_cache(self, cache: dict, sub: dict, i: int) -> dict:
        return cache_utils.write_cache(cache, sub, i)
