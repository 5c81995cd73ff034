"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) LM, in PyTorch.

The param tree is the JAX package's, leaf for leaf: layer params are
stacked ``(L, ...)`` under ``layers`` (``ln``, ``in_proj``, ``conv_w``,
``conv_b``, ``A_log``, ``dt_bias``, ``D``, ``gnorm``, ``out_proj``) beside
``embed`` and ``final_norm`` (and ``lm_head`` when embeddings are untied).

Forward, prefill and extend run the chunked dual form (``ssd_chunked``) in
plain PyTorch, as the reference does: its matmul-reassociated sums are a
different reduction order from the sequential scan. Decode runs the O(1)
recurrence; with ``use_kernel`` it goes through the SSD scan kernel
(``kernels.ops.ssd_decode``) at S = 1 with the slot states carried in and
out. Caches are updated in place: ``{"layers": {"conv": (L, B, w-1,
conv_dim) in the KV dtype, "state": (L, B, H, P, N) f32}, "pos": (B,)}``.

Speculative decode checkpoints the state after every token of the verify
chunk and rewinds by selecting the checkpoint at each slot's accept
boundary; with ``use_kernel`` the verify pass runs the conv and recurrence
of plain decode, the recurrence through the kernel, one launch per chunk
token. Not ported yet: activation checkpointing of ``forward``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import cache_utils
from repro_torch.models import layers as L


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Right-pad axis 1 with ``pad`` zero steps."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))], dim=1)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, initial_state=None,
                return_chunk_states: bool = False):
    """Chunked SSD. x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,)
    (< 0); B, C: (b, s, g, n); D: (h,) or None. Returns (y: (b, s, h, p) in
    x's dtype, final_state: (b, h, p, n) f32), and with
    ``return_chunk_states`` the state BEFORE each chunk (b, nc, h, p, n): at
    chunk 1, the state before every token."""
    b, s_orig, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hb = h // g
    q = min(chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        # zero-padded steps have dt=0 => decay exp(0)=1 and zero input: the
        # state passes through unchanged; padded outputs are sliced off
        x, dt, B, C = (_pad_seq(a, pad) for a in (x, dt, B, C))
    s = s_orig + pad
    nc = s // q

    xf = x.to(torch.float32).reshape(b, nc, q, h, p)
    dtf = dt.to(torch.float32).reshape(b, nc, q, h)
    Bh = B.to(torch.float32).repeat_interleave(hb, dim=2).reshape(b, nc, q, h, n)
    Ch = C.to(torch.float32).repeat_interleave(hb, dim=2).reshape(b, nc, q, h, n)

    cum = torch.cumsum(dtf * A, dim=2)                              # inclusive within chunk

    # --- intra-chunk (quadratic in q) ---
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (b, nc, qi, qj, h)
    ii = torch.arange(q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # mask BEFORE exp: exp of the (positive) j > i entries overflows
    LL = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], -1e30))
    CB = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    scores = CB * LL * dtf[:, :, None, :, :]                         # * dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # --- chunk states ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)                # (b, nc, q, h)
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dtf, Bh, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                        # (b, nc, h)

    # --- inter-chunk carry (short loop over nc) ---
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.to(torch.float32))
    states_prev = []
    for c in range(nc):
        states_prev.append(state)                                    # the state BEFORE chunk c
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    states_prev = torch.stack(states_prev, dim=1)
    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(cum), Ch, states_prev)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    if D is not None:
        y = y + D[None, None, :, None] * x.to(torch.float32)
    if return_chunk_states:
        return y[:, :s_orig].to(x.dtype), state, states_prev
    return y[:, :s_orig].to(x.dtype), state


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrence. x: (b, 1, h, p); dt: (b, 1, h); B/C: (b, 1,
    g, n); D: (h,); state: (b, h, p, n). Returns (y: (b, 1, h, p),
    new_state); the SSD scan kernel's plain version at S = 1."""
    return ssd_scan_plain(x, dt, A, B, C, D, initial_state=state, return_final_state=True)


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds. x: (b, s, dim); w: (width, dim)."""
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return y + b


def _conv_decode(x, conv_state, w, b):
    """x: (b, 1, dim); conv_state: (b, width-1, dim) holding previous inputs
    (stored in the cache dtype). Computes in f32, returns the output in
    x's dtype and the advanced state in the cache dtype."""
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)            # (b, width, dim)
    y = (full.to(torch.float32) * w.to(torch.float32)).sum(dim=1) + b
    new_state = full[:, 1:].to(conv_state.dtype)
    return y[:, None].to(x.dtype), new_state


def _conv_extend(x, conv_state, w, b, n_valid=None):
    """Causal conv over a chunk with carried state (chunked prefill).

    x: (b, s, dim) raw conv inputs, only the first ``n_valid`` real;
    conv_state: (b, width-1, dim) previous raw inputs. Returns the conv
    outputs for the chunk, the state advanced to the ``n_valid`` boundary
    (so right-padding never leaks into the carry), and the full raw input
    window (b, width-1+s, dim)."""
    width = w.shape[0]
    s = x.shape[1]
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)            # (b, w-1+s, dim)
    y = sum(full[:, i:i + s] * w[i] for i in range(width)) + b
    nv = s if n_valid is None else int(n_valid)
    start = min(max(nv, 0), s)               # clamped, as the reference's dynamic_slice
    new_state = full[:, start:start + width - 1]
    return y, new_state.to(conv_state.dtype), full


def _conv_steps(x, conv_state, w, b):
    """``_conv_extend`` over a whole chunk (no padding), each token computed
    as ``_conv_decode`` computes it: its window passes through the cache
    dtype, f32 products are summed over the window, and the output is
    rounded to x's dtype. A verify chunk's conv outputs are then those plain
    decode would give, where ``_conv_extend`` keeps them in f32."""
    width = w.shape[0]
    bsz, s, dim = x.shape
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)            # (b, w-1+s, dim)
    win = full.unfold(1, width, 1).transpose(2, 3)                   # (b, s, w, dim)
    y, _ = _conv_decode(win[:, :, -1:].reshape(bsz * s, 1, dim),
                        win[:, :, :-1].reshape(bsz * s, width - 1, dim).to(conv_state.dtype),
                        w, b)
    return y.reshape(bsz, s, dim), full[:, s:].to(conv_state.dtype), full


def conv_prefill_state(x_raw, width: int):
    """Last ``width-1`` raw conv inputs after a whole-prompt prefill,
    left-padded with zeros when the prompt is shorter than that."""
    pad = max(0, (width - 1) - x_raw.shape[1])
    if pad:
        x_raw = F.pad(x_raw, (0, 0, pad, 0))
    return x_raw[:, -(width - 1):]


class Mamba2LM:
    #: recurrent state is O(1) in sequence length: no serving context limit
    unbounded_context = True

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.d_inner = cfg.d_inner or 2 * cfg.d_model
        self.n_heads = self.d_inner // cfg.ssm_head_dim
        self.conv_dim = self.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        self.d_in_proj = 2 * self.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + self.n_heads

    # ------------------------------------------------------------------ init
    def _layer_init(self, gen: torch.Generator, ccfg: CascadeConfig, device) -> dict:
        cfg = self.cfg
        h = self.n_heads
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "ln": L.norm_init(cfg.d_model, cfg.norm_type, device=device),
            "in_proj": cascade.linear_init(gen, cfg.d_model, self.d_in_proj, ccfg, device=device),
            "conv_w": torch.randn((cfg.conv_width, self.conv_dim), generator=gen, **f32) * 0.1,
            "conv_b": torch.zeros((self.conv_dim,), **f32),
            "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            "dt_bias": torch.zeros((h,), **f32),
            "D": torch.ones((h,), **f32),
            "gnorm": L.norm_init(self.d_inner, device=device),
            "out_proj": cascade.linear_init(gen, self.d_inner, cfg.d_model, ccfg, device=device),
        }

    def init_params(self, seed: int, ccfg: CascadeConfig, device=None) -> dict:
        """Random params from ``seed``. In ``serve_fp4`` mode every matrix is
        quantized as it is drawn."""
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

    # --------------------------------------------------------------- mixer
    def _mixer(self, lp: dict, u: torch.Tensor, ccfg: CascadeConfig, cache=None,
               mode: str = "full", n_valid=None, collect: dict | None = None):
        """One Mamba-2 mixer. ``decode``/``extend`` update ``cache`` ({conv,
        state} of this layer) in place and return it; ``prefill`` returns a
        new one; ``full`` returns None. ``collect`` (extend of a speculative
        verify chunk of s tokens): this layer's checkpoint, filled in place
        with the raw conv input window over the chunk ("conv": (B, w-1+s,
        conv_dim)) and the SSD state before the chunk and after each of its
        tokens ("state": (s+1, B, H, P, N) f32)."""
        cfg = self.cfg
        b, s, _ = u.shape
        di, g, n, h = self.d_inner, cfg.ssm_groups, cfg.ssm_state, self.n_heads
        p = cfg.ssm_head_dim
        zxbcdt = cascade.linear_apply(lp["in_proj"], u, ccfg)
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di: di + self.conv_dim]
        dt_raw = zxbcdt[..., di + self.conv_dim:]

        if mode == "decode":
            xbc_c, new_conv = _conv_decode(xbc, cache["conv"], lp["conv_w"], lp["conv_b"])
        elif mode == "extend" and collect is not None and ccfg.use_kernel:
            xbc_c, new_conv, conv_full = _conv_steps(xbc, cache["conv"], lp["conv_w"],
                                                     lp["conv_b"])
        elif mode == "extend":
            xbc_c, new_conv, conv_full = _conv_extend(xbc, cache["conv"], lp["conv_w"],
                                                      lp["conv_b"], n_valid)
        else:
            xbc_c = _causal_conv(xbc, lp["conv_w"], lp["conv_b"])
        xbc_c = F.silu(xbc_c)
        x = xbc_c[..., :di].reshape(b, -1, h, p)
        B = xbc_c[..., di: di + g * n].reshape(b, -1, g, n)
        C = xbc_c[..., di + g * n:].reshape(b, -1, g, n)
        dt = F.softplus(dt_raw.to(torch.float32) + lp["dt_bias"])
        if mode == "extend" and n_valid is not None:
            # right-pad steps get dt=0: decay exp(0)=1 and zero input, so the
            # recurrent state passes through padding exactly unchanged
            dt = dt * (torch.arange(s, device=u.device) < int(n_valid))[None, :, None]
        A = -torch.exp(lp["A_log"])

        new_cache = None
        if mode == "decode":
            if ccfg.use_kernel:
                # fused serving: the recurrence runs through the SSD scan
                # kernel at S = 1, writing the slot states in place. Extend
                # stays on the chunked dual form, as in the reference.
                from repro_torch.kernels import ops
                y, _ = ops.ssd_decode(x, dt, A, B, C, lp["D"], cache["state"],
                                      out_state=cache["state"])
            else:
                y, new_state = ssd_decode_step(x, dt, A, B, C, lp["D"], cache["state"])
                cache["state"].copy_(new_state)
            cache["conv"].copy_(new_conv)
            new_cache = cache
        elif mode == "extend" and collect is not None:
            collect["conv"].copy_(conv_full)
            st = collect["state"]
            if ccfg.use_kernel:
                # the conv (above) and the recurrence of plain decode, one
                # token per kernel launch, each writing its state into that
                # token's checkpoint: the verify pass computes what plain
                # decode computes, token by token
                from repro_torch.kernels import ops
                st[0].copy_(cache["state"])
                y = torch.cat([ops.ssd_decode(x[:, j:j + 1], dt[:, j:j + 1], A, B[:, j:j + 1],
                                              C[:, j:j + 1], lp["D"], st[j],
                                              out_state=st[j + 1])[0] for j in range(s)], dim=1)
            else:
                # the reference's chunk-1 dual form: its chunk states are the
                # per-token states
                y, final_state, st_prev = ssd_chunked(x, dt, A, B, C, lp["D"], 1,
                                                      initial_state=cache["state"],
                                                      return_chunk_states=True)
                st[:s].copy_(st_prev.transpose(0, 1))
                st[s].copy_(final_state)
            cache["state"].copy_(st[s])
            cache["conv"].copy_(new_conv)
            new_cache = cache
        elif mode == "extend":
            y, final_state = ssd_chunked(x, dt, A, B, C, lp["D"], cfg.ssm_chunk,
                                         initial_state=cache["state"])
            cache["state"].copy_(final_state)
            cache["conv"].copy_(new_conv)
            new_cache = cache
        else:
            y, final_state = ssd_chunked(x, dt, A, B, C, lp["D"], cfg.ssm_chunk)
            if mode == "prefill":
                new_cache = {"conv": conv_prefill_state(xbc, cfg.conv_width),
                             "state": final_state}

        # the gate y * silu(z) runs inside the gated norm (z read in place)
        y = L.gated_norm_apply(lp["gnorm"], y.reshape(b, -1, di), z, use_kernel=ccfg.use_kernel)
        return cascade.linear_apply(lp["out_proj"], y, ccfg), new_cache

    def _block(self, lp, x, ccfg, cache, mode, n_valid=None, collect=None, pending=None):
        """One layer. ``pending``: the previous layer's mixer output, not yet
        added to the residual stream ``x``; the add runs inside this layer's
        input norm (one add-norm). Returns (x, this layer's mixer output,
        still to be added, its cache)."""
        uk = ccfg.use_kernel
        if pending is None:
            u = L.norm_apply(lp["ln"], x, self.cfg.norm_type, use_kernel=uk)
        else:
            u, x = L.add_norm_apply(lp["ln"], x, pending, self.cfg.norm_type, use_kernel=uk)
        h, nc = self._mixer(lp, u, ccfg, cache, mode, n_valid, collect)
        return x, h, nc

    # --------------------------------------------------------------- api
    def _head(self, params: dict, x: torch.Tensor, pending: torch.Tensor, ccfg: CascadeConfig,
              per_token: bool = False) -> torch.Tensor:
        """Logits of the rows of ``x + pending`` (the last layer's mixer
        output is added inside the final norm)."""
        x, _ = L.add_norm_apply(params["final_norm"], x, pending, self.cfg.norm_type,
                                use_kernel=ccfg.use_kernel)
        if self.cfg.tie_embeddings:
            logits = L.tied_head(params["embed"], x, ccfg.compute_dtype, per_token)
        else:
            logits = cascade.linear_apply(params["lm_head"], x, ccfg)
        return logits.to(torch.float32)

    def _layers(self, params: dict, x: torch.Tensor, ccfg: CascadeConfig, mode: str,
                cache=None, n_valid=None, collect=None):
        """Run every layer (``collect``: a verify checkpoint's stacked
        ``layers``, filled layer by layer); returns x, the last layer's mixer
        output still to be added, and the per-layer caches."""
        pending, caches = None, []
        for i in range(self.cfg.n_layers):
            c = cache_utils.layer_view(cache["layers"], i) if cache is not None else None
            ck = cache_utils.layer_view(collect, i) if collect is not None else None
            x, pending, nc = self._block(cache_utils.layer_view(params["layers"], i), x, ccfg, c,
                                         mode, n_valid, ck, pending=pending)
            caches.append(nc)
        return x, pending, caches

    def forward(self, params: dict, batch: dict, ccfg: CascadeConfig) -> torch.Tensor:
        """Full-sequence forward (no cache): logits (B, S, V) f32."""
        x, pending, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                     ccfg, "full")
        return self._head(params, x, pending, ccfg)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Zero state for ``batch`` slots; ``max_len`` is unused (the state is
        O(1) in sequence length). ``pos`` counts each slot's tokens (the
        recurrence itself is position-free)."""
        cfg = self.cfg
        device = resolve_device(device)
        nl = cfg.n_layers
        return {
            "layers": {
                "conv": torch.zeros((nl, batch, cfg.conv_width - 1, self.conv_dim),
                                    dtype=dtype, device=device),
                # the recurrent accumulator stays f32
                "state": torch.zeros((nl, batch, self.n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=torch.float32, device=device),
            },
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        }

    def prefill(self, params: dict, batch: dict, ccfg: CascadeConfig,
                max_len: int | None = None):
        """Prompt forward that also builds the cache: logits of the last
        position (B, 1, V) and the cache."""
        b, s = batch["tokens"].shape
        x, pending, caches = self._layers(params, L.embed_apply(params["embed"],
                                                                batch["tokens"]), ccfg, "prefill")
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        return (self._head(params, x[:, -1:], pending[:, -1:], ccfg),
                {"layers": cache_utils.stack_layers(caches), "pos": pos})

    def decode_step(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig):
        """One token per row against ``cache`` (updated in place)."""
        x, pending, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                     ccfg, "decode", cache)
        cache["pos"].add_(1)
        return self._head(params, x, pending, ccfg), cache

    def prefill_extend(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                       n_valid=None, kv_len: int | None = None):
        """Append a (right-padded) token chunk to ``cache`` (in place): the
        conv state carries across chunks and padded steps leave the SSD state
        untouched (dt=0). Returns logits of the last valid token (B, 1, V).
        ``kv_len`` (the attention families' live-key bound) is unused: there
        is no attention."""
        s = batch["tokens"].shape[1]
        nv = s if n_valid is None else int(n_valid)
        x, pending, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                     ccfg, "extend", cache, nv)
        cache["pos"].add_(nv)
        x, pending = (cache_utils.take_last_valid(t, nv) for t in (x, pending))
        return self._head(params, x, pending, ccfg), cache

    # --------------------------------------------------- speculative decode
    def spec_verify(self, params: dict, batch: dict, cache: dict, ccfg: CascadeConfig,
                    ckpt: dict | None = None, kv_len: int | None = None):
        """Score a (B, 1+K) draft chunk in ONE extend pass, checkpointing the
        recurrent state after EVERY chunk token: a recurrence cannot be
        rewound in place, so a rejected suffix rolls back by selecting the
        checkpoint at the accept boundary. Returns per-position logits (B,
        1+K, V), the cache advanced in place, and the checkpoint
        ``{"layers": {"conv": (L, B, w-1+s, conv_dim), "state": (L, s+1, B,
        H, P, N) f32}, "pos": (B,)}``. The state stack puts the token axis
        before the slots (the reference's is (L, B, s+1, ...)) so that each
        token's (B, H, P, N) states are contiguous: the kernel writes them in
        place. The checkpoint is allocated when ``ckpt`` is None and filled
        again when a checkpoint of the same shapes is passed (at full width
        it holds gigabytes: an engine allocates it once). ``kv_len`` is
        unused, as in :meth:`prefill_extend`."""
        cfg = self.cfg
        b, s = batch["tokens"].shape
        dev = cache["pos"].device
        if ckpt is None:
            ckpt = {"layers": {
                "conv": torch.empty((cfg.n_layers, b, cfg.conv_width - 1 + s, self.conv_dim),
                                    dtype=ccfg.compute_dtype, device=dev),
                "state": torch.empty((cfg.n_layers, s + 1, b, self.n_heads, cfg.ssm_head_dim,
                                      cfg.ssm_state), dtype=torch.float32, device=dev)},
                "pos": torch.empty((b,), dtype=torch.int32, device=dev)}
        ckpt["pos"].copy_(cache["pos"])
        x, pending, _ = self._layers(params, L.embed_apply(params["embed"], batch["tokens"]),
                                     ccfg, "extend", cache, collect=ckpt["layers"])
        cache["pos"].add_(s)
        # the tied head token by token, at decode's shape: one f32 GEMM over
        # all B * s rows rounds otherwise than decode's M = B does. (The
        # norms' eager route still reduces in an order set by the row count;
        # the kernel's does not.)
        return self._head(params, x, pending, ccfg, per_token=True), cache, ckpt

    def spec_rewind(self, cache: dict, ckpt: dict, keep: torch.Tensor) -> dict:
        """Per-slot rewind to ``keep[b]`` committed chunk tokens, in place:
        the checkpointed conv window and SSD state at the accept boundary,
        and ``pos0 + keep[b]``."""
        ck = ckpt["layers"]
        cache["layers"]["conv"].copy_(
            cache_utils.slice_rows_per_slot(ck["conv"], keep, 1, self.cfg.conv_width - 1))
        cache["layers"]["state"].copy_(
            cache_utils.slice_rows_per_slot(ck["state"].transpose(1, 2), keep, 1, 1)[:, :, 0])
        cache["pos"].copy_(ckpt["pos"] + keep.to(ckpt["pos"].device))
        return cache

    # ----------------------------------------- continuous batching cache API
    def write_cache(self, cache: dict, sub: dict, i: int) -> dict:
        return cache_utils.write_cache(cache, sub, i)
