"""Serving engine: continuous batching over a fixed slot grid.

``ServeEngine`` owns ``max_batch`` decode slots backed by ONE stacked KV
cache. Each step:

1. **admission** -- queued requests are prefilled into a batch-1 staging
   cache in ``prefill_chunk``-token pieces (``prefill_extend``), at most
   ``token_budget`` prompt tokens per step; a fully prefilled request is
   copied into its slot and its first token is picked;
2. **decode** -- ONE batched ``decode_step`` runs over the whole slot grid;
   idle slots compute masked garbage that never escapes. With
   ``draft_len`` K > 0 the step is speculative instead: a prompt-lookup
   drafter (``serve/spec.py``) proposes up to K tokens per slot, ONE
   ``spec_verify`` pass scores all K+1 positions, each slot commits its
   accepted prefix plus one more token, and ``spec_rewind`` rolls every
   slot back to its accept boundary;
3. finished streams retire (eos, ``max_new_tokens`` or the context limit)
   by freeing their slot, token by token, so a speculative step stops a
   stream exactly where plain decode would. A model with
   ``unbounded_context`` (Mamba-2: O(1) recurrent state) has no context
   limit: no prompt is too long for it and no stream retires on ``max_len``.

Decoding is greedy argmax by default (speculation then commits exactly the
greedy stream). ``temperature`` > 0 (with ``top_k``) samples on the device
from the truncated softmax ``_truncate_logits`` defines, by a Gumbel-max
draw; speculative sampling accepts draft d with probability p(d) and
resamples a rejection from the residual (``spec_sample_accept``), so every
committed token follows plain sampled decode's distribution. Every draw
comes from ONE ``torch.Generator`` on the engine's device seeded by
``sample_seed``: a run is deterministic given the seed and the order of
draws. Torch's generator gives other bits than the reference's threefry
counters, so sampled streams match the reference in distribution, not
token for token.

The reference donates its cache to each jitted step; this engine updates
the stacked cache IN PLACE instead (the model writes K/V rows and advances
``pos`` inside the tensors it is given), so the grid is allocated once.

``fused=True`` sends every linear through the FP4 CUDA matmul, single-token
attention through the CUDA decode-attention kernel, every multi-token
attention (admission chunks, the verify pass) through the CUDA flash
attention kernel and the Mamba-2 decode recurrence (and the verify pass's
per-token recurrence) through the CUDA SSD scan kernel (``kernels/ops.py``);
on CPU tensors those wrappers run their plain versions. Not ported yet (the
engine raises ``NotImplementedError`` when asked): the paged KV pool and
prefix cache, CREST probes, the slot-wise loop and mesh serving.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.serve.spec import ngram_propose

#: methods a model needs for speculative decode
_SPEC_API = ("spec_verify", "spec_rewind")
#: the drafter matches suffix n-grams up to this long, over at most this
#: many trailing tokens of a slot's stream (the reference's defaults)
_NGRAM_MAX, _NGRAM_LOOKBACK = 3, 512


def _truncate_logits(logits: torch.Tensor, temperature: float, top_k: int) -> torch.Tensor:
    """Temperature-scaled, top-k-truncated f32 logits: ``softmax`` of the
    result is THE distribution every sampled path draws from, on any
    (..., V) shape (decode rows and all K+1 verify rows alike).

    The truncated support is defined by VALUE: every logit >= the k-th
    largest survives, so a tie at the k-th logit keeps every tied entry
    (more than k). The truncation is then a pure function of the values,
    which plain decode and the verify pass cannot resolve differently."""
    x = logits.to(torch.float32) / temperature
    if 0 < top_k < x.shape[-1]:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = x.masked_fill(x < kth, float("-inf"))
    return x


def _gumbel_argmax(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """(B, V) -> (B,) draws from softmax(x): argmax of x plus Gumbel noise.
    The noise is drawn for every row from the generator's stream by
    position, so an active row's draw never depends on another row's
    logits."""
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(x + gumbel, dim=-1)


def _sample_tokens(logits: torch.Tensor, gen: torch.Generator, temperature: float,
                   top_k: int) -> torch.Tensor:
    """(B, V) logits -> (B,) sampled token ids, on the logits' device."""
    return _gumbel_argmax(_truncate_logits(logits, temperature, top_k), gen)


#: finite logit penalty that removes the rejected draft from the residual.
#: Finite on purpose: if the residual is EMPTY (p was numerically a point
#: mass on the draft), the penalized draft still wins, the right action for
#: a "rejection" that only float rounding made possible.
_RESIDUAL_PENALTY = 1e30


def spec_sample_accept(logits: torch.Tensor, drafts: torch.Tensor, k_eff: torch.Tensor,
                       gen: torch.Generator, temperature: float, top_k: int):
    """Speculative-sampling acceptance for a point-mass drafter.

    ``logits`` (B, K+1, V) verify rows (row j conditions on the prefix and
    chunk tokens 0..j); ``drafts`` (B, K) the proposed tokens (chunk tokens
    1..K); ``k_eff`` (B,) real proposals per row (later positions are
    padding: never scored, always rejected). Returns ``(a, token)``: (B,)
    accepted draft counts and the step's final committed token.

    Draft d_j is accepted with probability p_j(d_j) (q is a point mass, so
    min(1, p/q) = p), p being the truncated softmax of ``_truncate_logits``,
    the distribution plain sampled decode draws from. At the first
    rejection (row a) the token is resampled from p_a with d_a's mass
    removed (the residual norm(max(0, p - q))); when all k_eff drafts are
    accepted the bonus token is drawn from row k_eff. The committed
    token's marginal at every row is then p(d)·1[t=d] + (1-p(d))·p(t)/(1-p(d))
    = p(t), plain sampled decode's distribution."""
    b, kp1, v = logits.shape
    k = kp1 - 1
    dev = logits.device
    x = _truncate_logits(logits, temperature, top_k)             # (B, K+1, V)
    logp = torch.log_softmax(x, dim=-1)
    drafts = drafts.to(device=dev, dtype=torch.int64)
    k_eff = k_eff.to(device=dev, dtype=torch.int64)
    p_draft = torch.exp(torch.gather(logp[:, :k], 2, drafts[..., None])[..., 0])   # (B, K)
    u = torch.rand((b, k), generator=gen, device=dev, dtype=torch.float32)
    real = torch.arange(k, device=dev)[None, :] < k_eff[:, None]
    accept = (u < p_draft) & real
    a = torch.cumprod(accept.to(torch.int64), dim=-1).sum(dim=-1)   # leading accepts
    rows = torch.arange(b, device=dev)
    row = x[rows, a]                                                 # (B, V)
    rejected = a < k_eff
    d_rej = drafts[rows, torch.clamp(a, max=k - 1)]
    hit = (torch.arange(v, device=dev)[None, :] == d_rej[:, None]) & rejected[:, None]
    row = row - hit.to(row.dtype) * _RESIDUAL_PENALTY
    return a, _gumbel_argmax(row, gen)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    created_at: float = 0.0       # arrival: pre-stamped by a load generator, else set at submit()
    admitted_at: float = 0.0      # when prefill started
    first_token_at: float = 0.0
    finished_at: float = 0.0
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: token_times[i] is the clock reading when tokens_out[i] was committed
    token_times: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    eos_id: int = -1              # -1: only stop at max_new_tokens
    crest_enabled: bool = False   # not ported: raises
    batched: bool = True          # False (slot-wise loop) is not ported: raises
    prefill_chunk: int = 32       # chunked-prefill piece size (0 = whole prompt)
    token_budget: int = 0         # max prompt tokens admitted per step (0 = no cap)
    temperature: float = 0.0      # <= 0: greedy argmax; > 0: seeded sampling on the device
    top_k: int = 0                # restrict sampling to the k best logits (0 = all)
    sample_seed: int = 0          # sampling is deterministic given seed + order of draws
    draft_len: int = 0            # speculative decode: K drafted tokens per slot per step
    fused: bool = False           # CUDA kernels (FP4 matmul, decode and flash attention,
                                  # SSD scan)
    paged: bool = False           # not ported: raises
    prefix_cache: bool = False    # not ported: raises


@dataclasses.dataclass
class _Staging:
    """A request mid-prefill: holds its batch-1 cache until fully prefilled."""
    req: Request
    cache: Any
    consumed: int
    slot: int


def _check_ported(scfg: ServeConfig, mesh) -> None:
    missing = [name for name, on in (
        ("paged / prefix_cache (ROADMAP Queue 1 item 8)", scfg.paged or scfg.prefix_cache),
        ("crest_enabled (ROADMAP Queue 1 item 13)", scfg.crest_enabled),
        ("batched=False (the slot-wise loop)", not scfg.batched),
        ("a device mesh (ROADMAP Queue 1 item 15)", mesh is not None),
    ) if on]
    if missing:
        raise NotImplementedError("not ported to PyTorch yet: " + "; ".join(missing))


class ServeEngine:
    def __init__(self, model, params, ccfg: CascadeConfig, scfg: ServeConfig,
                 mesh=None, device=None):
        _check_ported(scfg, mesh)
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.scfg = scfg
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * scfg.max_batch
        self.step_times: list = []
        self._decode_tokens = 0
        self._admission_waits: list = []
        self._retired: List[Request] = []
        self._rejected = 0
        self._staging: Optional[_Staging] = None
        # every downgrade warns once and shows in metrics()['effective_mode']
        self.downgrades: List[str] = []

        def _downgrade(msg: str):
            self.downgrades.append(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

        self._draft_len = 0
        if scfg.draft_len > 0:
            if all(hasattr(model, m) for m in _SPEC_API):
                self._draft_len = scfg.draft_len
            else:
                _downgrade("draft_len > 0 requested but this model lacks spec_verify/"
                           "spec_rewind -- speculative decode disabled")
        self.spec = self._draft_len > 0
        self._sampled = scfg.temperature > 0.0
        # ONE generator for every draw (admission, decode, speculative
        # accept/resample): deterministic given the seed and the draw order
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.sample_seed)
        self._accepted_drafts = 0     # drafted tokens the verify pass accepted
        self._spec_slot_steps = 0     # (slot, step) pairs that ran speculation
        # per-slot draft context, appended as tokens commit
        self._spec_ctx: List[Optional[list]] = [None] * scfg.max_batch
        self._ckpt = None             # the verify pass's checkpoint, allocated once
        self.fused = False
        if scfg.fused:
            if ccfg.mode != "serve_fp4":
                _downgrade(f"fused decode requested but ccfg.mode={ccfg.mode!r} -- the FP4 "
                           "kernel path needs packed serve_fp4 params (codes+scales); "
                           "running the plain path")
            else:
                self.fused = True
                ccfg = dataclasses.replace(ccfg, use_kernel=True)
        self.ccfg = ccfg
        # recurrent archs hold O(1) state: prompt length is not bounded by
        # the cache, and there is no context-limit retire
        self.ctx_unbounded = bool(getattr(model, "unbounded_context", False))
        # round the cache length up to a chunk multiple so padded chunk
        # writes never clamp into (and clobber) valid cache entries; a
        # verify pass writes up to draft_len rows past a stream's last
        # position, so speculation adds that much headroom
        c = scfg.prefill_chunk
        need = scfg.max_len + self._draft_len
        self._cache_len = (-(-need // c) * c) if c > 0 else need
        self.cache = model.init_cache(scfg.max_batch, self._cache_len,
                                      dtype=ccfg.resolved_kv_dtype, device=self.device)

    # ------------------------------------------------------------ admission
    def submit(self, req: Request):
        if req.created_at == 0.0:
            req.created_at = time.monotonic()
        self.queue.append(req)

    def _pop_admittable(self) -> Optional[Request]:
        """Next queued request; empty prompts and prompts too long for the
        cache to hold with room for one generated token are rejected (the
        latter only where the context is bounded)."""
        while self.queue:
            req = self.queue.popleft()
            if len(req.prompt) > 0 and (self.ctx_unbounded
                                        or len(req.prompt) < self.scfg.max_len):
                return req
            req.done = True
            req.finished_at = time.monotonic()
            self._rejected += 1
            self._retired.append(req)
        return None

    def _free_slot(self) -> Optional[int]:
        staged = self._staging.slot if self._staging is not None else -1
        for i in range(self.scfg.max_batch):
            if self.slots[i] is None and i != staged:
                return i
        return None

    def _tokens(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows).to(self.device)

    @torch.no_grad()
    def _admit(self):
        """Spend up to ``token_budget`` prompt tokens on (chunked) prefill."""
        budget = self.scfg.token_budget or 1 << 30
        spent = 0
        while spent < budget:
            if self._staging is None:
                slot = self._free_slot()
                if slot is None:
                    return
                req = self._pop_admittable()
                if req is None:
                    return
                req.admitted_at = time.monotonic()
                self._admission_waits.append(req.admitted_at - req.created_at)
                sub = self.model.init_cache(1, self._cache_len,
                                            dtype=self.ccfg.resolved_kv_dtype,
                                            device=self.device)
                self._staging = _Staging(req, sub, 0, slot)
            st = self._staging
            prompt = st.req.prompt
            chunk = self.scfg.prefill_chunk or len(prompt)
            logits = None
            while st.consumed < len(prompt) and spent < budget:
                n = min(chunk, len(prompt) - st.consumed)
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :n] = prompt[st.consumed:st.consumed + n]
                # the chunk's rows sit at [consumed, consumed + chunk): no
                # key past that is live
                logits, st.cache = self.model.prefill_extend(
                    self.params, {"tokens": self._tokens(toks)}, st.cache, self.ccfg,
                    n_valid=n, kv_len=st.consumed + chunk)
                st.consumed += n
                spent += n
            if st.consumed < len(prompt):
                return                      # budget exhausted mid-prompt
            nxt = self._pick(logits[0, -1])
            self._commit_token(st.req, nxt)
            self.model.write_cache(self.cache, st.cache, st.slot)
            self.slots[st.slot] = st.req
            if self.spec:
                self._spec_ctx[st.slot] = st.req.prompt.tolist() + st.req.tokens_out
            self._staging = None
            # the prefill-generated token may already end the stream
            self._retire_if_done(st.req, st.slot, nxt)

    # --------------------------------------------------------------- decode
    def _active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]

    def _pick(self, row: torch.Tensor) -> int:
        """Next token from a (V,) logits row (admission): argmax, or one
        draw from the engine's generator."""
        if not self._sampled:
            return int(torch.argmax(row))
        return int(_sample_tokens(row[None], self._gen, self.scfg.temperature,
                                  self.scfg.top_k)[0])

    def _commit_token(self, req: Request, tok: int):
        req.tokens_out.append(tok)
        req.token_times.append(time.monotonic())
        if req.first_token_at == 0.0:
            req.first_token_at = req.token_times[-1]

    def _retire_if_done(self, req: Request, i: int, nxt: int):
        used = len(req.prompt) + len(req.tokens_out)
        if (len(req.tokens_out) >= req.max_new_tokens
                or nxt == self.scfg.eos_id
                # context limit: the next write would fall outside the cache
                # (never fires for recurrent archs: their state is O(1))
                or (not self.ctx_unbounded and used >= self.scfg.max_len)):
            req.done = True
            req.finished_at = time.monotonic()
            self._retired.append(req)
            self.slots[i] = None

    @torch.no_grad()
    def _decode_batched(self, active: List[int]) -> int:
        toks = np.zeros((self.scfg.max_batch, 1), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].tokens_out[-1]
        logits, self.cache = self.model.decode_step(
            self.params, {"tokens": self._tokens(toks)}, self.cache, self.ccfg)
        if self._sampled:
            nxt = _sample_tokens(logits[:, -1], self._gen, self.scfg.temperature,
                                 self.scfg.top_k)
        else:
            # torch.argmax returns the first maximum, as jnp.argmax does
            nxt = torch.argmax(logits[:, -1], dim=-1)
        nxt = nxt.cpu().numpy()
        for i in active:
            req = self.slots[i]
            tok = int(nxt[i])
            self._commit_token(req, tok)
            self._retire_if_done(req, i, tok)
        return len(active)

    @torch.no_grad()
    def _decode_spec(self, active: List[int]) -> int:
        """One speculative step: draft up to K tokens per slot by prompt
        lookup over the slot's own stream (``k_eff`` of them real), score
        all K+1 positions in ONE verify pass, commit the accepted prefix and
        one more token per slot, then rewind every slot's cache to its
        accept boundary (inactive slots: a full rewind).

        Greedy: accept the longest real-draft prefix that matches the
        model's own argmax, so the stream is plain greedy decode's. Sampled:
        ``spec_sample_accept`` (rejection resampling) on the device. Padded
        proposals (positions >= ``k_eff``) are never scored as real."""
        k = self._draft_len
        b = self.scfg.max_batch
        toks = np.zeros((b, k + 1), np.int32)
        keff = np.zeros(b, np.int32)
        for i in active:
            ctx = self._spec_ctx[i]
            toks[i, 0] = ctx[-1]               # the pending token
            toks[i, 1:], keff[i] = ngram_propose(np.asarray(ctx[-_NGRAM_LOOKBACK:], np.int32),
                                                 k, _NGRAM_MAX)
        toks_dev = self._tokens(toks)
        # an active slot's cache holds its stream but the pending token, so
        # its chunk sits at [used - 1, used + k): no active row sees a key
        # past max(used) + k (inactive rows' outputs are discarded)
        live = max(len(self.slots[i].prompt) + len(self.slots[i].tokens_out)
                   for i in active) + k
        logits, self.cache, self._ckpt = self.model.spec_verify(
            self.params, {"tokens": toks_dev}, self.cache, self.ccfg, ckpt=self._ckpt,
            kv_len=live)
        if self._sampled:
            acc, fin = spec_sample_accept(logits, toks_dev[:, 1:], self._tokens(keff), self._gen,
                                          self.scfg.temperature, self.scfg.top_k)
            acc, fin = acc.cpu().numpy(), fin.cpu().numpy()
        else:
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()     # (B, K+1)
        keep = np.zeros(b, np.int64)
        produced = 0
        for i in active:
            req = self.slots[i]
            if self._sampled:
                a = int(acc[i])
                seq = [int(t) for t in toks[i, 1:a + 1]] + [int(fin[i])]
            else:
                a = 0
                while a < keff[i] and greedy[i, a] == toks[i, a + 1]:
                    a += 1
                seq = [int(t) for t in greedy[i, :a + 1]]
            keep[i] = a + 1                     # the pending token and the accepted drafts
            self._spec_slot_steps += 1
            # commit one token at a time: retirement fires at exactly the
            # token where plain decode would stop
            delivered = 0
            ctx = self._spec_ctx[i]
            for tok in seq:
                self._commit_token(req, tok)
                ctx.append(tok)
                delivered += 1
                self._retire_if_done(req, i, tok)
                if req.done:
                    break
            # only delivered drafts count: tokens/step/slot = accepted_per_step + 1
            self._accepted_drafts += delivered - 1
            produced += delivered
            if len(ctx) > 2 * _NGRAM_LOOKBACK:  # the drafter reads only the tail
                del ctx[:len(ctx) - _NGRAM_LOOKBACK]
        self.cache = self.model.spec_rewind(self.cache, self._ckpt, self._tokens(keep))
        return produced

    def step(self) -> int:
        """One engine step; returns the number of decode tokens produced."""
        self._admit()
        active = self._active()
        if not active:
            return 0
        t0 = time.monotonic()
        produced = self._decode_spec(active) if self.spec else self._decode_batched(active)
        self.step_times.append(time.monotonic() - t0)
        self._decode_tokens += produced
        return produced

    def busy(self) -> bool:
        return bool(self.queue) or self._staging is not None or bool(self._active())

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        n0 = len(self._retired)
        for _ in range(max_steps):
            self.step()
            if not self.busy():
                break
        return self._retired[n0:]

    # -------------------------------------------------------------- metrics
    @property
    def effective_mode(self) -> str:
        """The decode path this engine actually runs, downgrades included:
        '{spec|batched}-{greedy|sampled}[-fused]'."""
        mode = f"{'spec' if self.spec else 'batched'}-{'sampled' if self._sampled else 'greedy'}"
        return mode + ("-fused" if self.fused else "")

    def metrics(self) -> dict:
        """Throughput/latency counters."""
        st = np.asarray(self.step_times, np.float64)
        total = float(st.sum()) if st.size else 0.0
        return {
            "effective_mode": self.effective_mode,
            "downgrades": list(self.downgrades),
            "fused": self.fused,
            "device": str(self.device),
            "spec": self.spec,
            "draft_len": self._draft_len,
            "draft_tokens_accepted": self._accepted_drafts,
            # mean drafts accepted per (slot, step); one more token always
            # commits, so tokens/step/slot = accepted_per_step + 1
            "accepted_per_step": (self._accepted_drafts / self._spec_slot_steps
                                  if self._spec_slot_steps else 0.0),
            "steps": int(st.size),
            "decode_tokens": self._decode_tokens,
            "tokens_per_s": (self._decode_tokens / total) if total > 0 else 0.0,
            "admission_wait_s_mean": (float(np.mean(self._admission_waits))
                                      if self._admission_waits else 0.0),
            "step_time_p50_s": float(np.percentile(st, 50)) if st.size else 0.0,
            "step_time_p99_s": float(np.percentile(st, 99)) if st.size else 0.0,
            "requests_finished": len(self._retired) - self._rejected,
            "requests_rejected": self._rejected,
        }
