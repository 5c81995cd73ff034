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
   Griffin's local attention keeps a ring of ``window`` rows, so it is
   unbounded too; its admission chunks are clamped to the ring (a chunk
   must fit inside it, so its writes never collide) and its drafts to
   ``window - 1`` (the verify chunk is a chunk too).

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

``paged=True`` keeps the K/V in a page pool shared by the slots (pages of
``page_size`` rows, ``num_pages`` of them) with a host-owned (B, nb) block
table; ``prefix_cache=True`` adds a radix tree over prompt pages
(``serve/prefix.py``), so a prompt whose leading pages are resident maps
them into its block table and prefills only the rest. Both are token-exact
with the dense cache: each step gathers the slots' pages back into the
dense view and runs the same kernels at the same plans. A model whose cache
has no page layout (Mamba-2's recurrent state, Griffin's ring buffers) warns
and runs the dense cache. Paged admission prefills straight into the resident grid, and runs
each chunk over the admitting slot ALONE (B = 1: its row of the block table
and a view of its ``pos``), where the reference runs it over the whole grid
with a per-slot ``n_valid`` to keep one compiled shape. The tokens and the
live pages come out the same (the other rows' writes in the reference are
never read), and the slot-alone chunk is what dense admission runs: the
flash-attention plan depends on B (at B = 8 a chunk never splits over the
keys, at B = 1 it does from 256 live keys), and each matmul keeps a chunk's
M rows instead of max_batch times as many. Under a prefix hit admission
starts at the matched length, a multiple of ``page_size``; where that is
not a multiple of ``prefill_chunk``, the first chunk ends at the next
multiple and attends over the keys the dense engine's chunk of those rows
sees, so every chunk keeps the dense engine's boundaries, live keys and
flash plans (with the chunk boundaries shifted, past 256 live keys a
chunk split otherwise and a stream departed on the card).

``fused=True`` sends every linear through the FP4 CUDA matmul (the MoE
experts through its grouped launch, one a matmul over all experts),
single-token attention through the CUDA decode-attention kernel, every
multi-token attention (admission chunks, the verify pass) through the CUDA
flash attention kernel and the Mamba-2 decode recurrence (and the verify
pass's per-token recurrence) through the CUDA SSD scan kernel
(``kernels/ops.py``);
on CPU tensors those wrappers run their plain versions.

``crest_enabled`` runs a CREST probe wave (``core/crest.py``; the paper's
built-in self-test, Section 20.6) every ``crest_every`` steps, before the
step's decode: the CREST-protected matmul on a dense f32 copy of
``lm_head`` with a random (4, K) input. Confirmed faults and repairs
accumulate in ``crest_state`` (``crest_report()``); ``fault_mask`` (N,)
bool injects defective columns. A model without ``lm_head`` (Mamba-2's tied
head) skips the probe, as the reference does.

``batched=False``, or a model with a multi-codebook head (musicgen), runs
the slot-wise loop instead: each request is prefilled whole into its own
cache (``model.prefill``) and decoded one slot at a time, a 4-D logits row
picking codebook 0, at admission as at decode. As in the reference, that
loop runs no speculation and no pages: each such request downgrades with a
warning. Unlike the reference's, ``fused=True`` runs it through the kernels
(its calls are ``prefill`` and ``decode_step`` at B = 1). A model
fed stub embeddings (``input_embeds``) is refused: the engine takes token
prompts.

Every time the engine records (arrival, admission, token commits, step
times) reads an injected clock (``serve/traffic.py``: ``MonotonicClock``
by default, a ``VirtualClock`` in deterministic fleet tests). The fleet
layer (``serve/elastic.py``, ``serve/router.py``) drives engines through
``submit``, ``step``, ``load``, ``evict`` and ``abort_in_flight``; a
request rebuilt after a replica failure carries its emitted tokens inside
its prompt (``Request.prompt_carried`` of them). Not ported yet (the
engine raises ``NotImplementedError`` when asked): mesh serving.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core import cascade, crest
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.models import cache_utils
from repro_torch.serve.prefix import PagePool, RadixPrefixCache
from repro_torch.serve.spec import ngram_propose
from repro_torch.serve.traffic import MonotonicClock

#: methods a model needs for speculative decode
_SPEC_API = ("spec_verify", "spec_rewind")


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
    prompt_carried: int = 0       # leading tokens_out entries a failover rebuild put into
                                  # ``prompt``
    #: token_times[i] is the clock reading when tokens_out[i] was committed
    token_times: list = dataclasses.field(default_factory=list)
    slo_ttft_s: float = 0.0       # TTFT target this request is judged by (0: none)
    deadline_s: float = 0.0       # the router sheds the request if it is not dispatched
                                  # this many seconds after arrival (0: never)
    prefix_id: int = -1           # the traffic generator's shared-prefix tag (-1: none)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    eos_id: int = -1              # -1: only stop at max_new_tokens
    crest_enabled: bool = False   # CREST probe waves on lm_head. They keep a dense f32
                                  # copy of it: 1.51 GB on codeqwen1.5-7b (4096 x 92416),
                                  # 2.62 GB on recurrentgemma-2b, 0.41 GB on olmoe-1b-7b
    crest_every: int = 4          # run a probe wave every N engine steps
    crest_cfg: crest.CrestConfig = dataclasses.field(default_factory=crest.CrestConfig)
    batched: bool = True          # one decode over the whole slot grid; False: the
                                  # slot-wise loop (multi-codebook heads always)
    prefill_chunk: int = 32       # chunked-prefill piece size (0 = whole prompt;
                                  # clamped to the ring length for windowed archs)
    token_budget: int = 0         # max prompt tokens admitted per step (0 = no cap)
    temperature: float = 0.0      # <= 0: greedy argmax; > 0: seeded sampling on the device
    top_k: int = 0                # restrict sampling to the k best logits (0 = all)
    sample_seed: int = 0          # sampling is deterministic given seed + order of draws
    draft_len: int = 0            # speculative decode: K drafted tokens per slot per step
                                  # (clamped to window - 1 for ring-buffer archs)
    ngram_max: int = 3            # longest suffix n-gram the prompt-lookup drafter matches
    ngram_lookback: int = 512     # drafter scans at most this many trailing stream tokens
    fused: bool = False           # CUDA kernels (FP4 matmul, decode and flash attention,
                                  # SSD scan)
    paged: bool = False           # page-granular KV pool with host-owned block tables;
                                  # token-exact with the dense cache (full-attention
                                  # models; others downgrade with a warning)
    page_size: int = 16           # tokens per physical page
    num_pages: int = 0            # pool size (0: max_batch * blocks_per_slot + 1, so
                                  # every slot can fill, plus the trash page)
    prefix_cache: bool = False    # radix-tree prefix cache over prompt pages (implies paged)
    evict_watermark: float = 0.9  # pool fraction in use above which LRU tree-only pages
                                  # are evicted at allocation


@dataclasses.dataclass
class _Staging:
    """A request mid-prefill: holds its batch-1 cache until fully prefilled."""
    req: Request
    cache: Any
    consumed: int
    slot: int


class ServeEngine:
    def __init__(self, model, params, ccfg: CascadeConfig, scfg: ServeConfig,
                 mesh=None, device=None, clock=None):
        if mesh is not None:
            raise NotImplementedError("not ported to PyTorch yet: a device mesh "
                                      "(ROADMAP Queue 1 item 10)")
        mcfg = getattr(model, "cfg", None)
        if getattr(mcfg, "input_embeds", False):
            raise ValueError(
                f"{mcfg.name} takes stub-frontend embeddings (input_embeds), but the engine "
                "takes token prompts: run it at the model level (prefill, decode_step)")
        self.device = resolve_device(device)
        self.clock = clock if clock is not None else MonotonicClock()
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
        self._steps = 0
        self.crest_state = None
        self.fault_mask = None        # (N,) bool: columns to corrupt, set by tests and demos
        self._probe_w = None
        # every downgrade warns once and shows in metrics()['effective_mode']
        self.downgrades: List[str] = []

        def _downgrade(msg: str):
            self.downgrades.append(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

        # the batched path needs flat logits: a multi-codebook head runs the
        # slot-wise loop, as in the reference
        codebooks = getattr(mcfg, "n_codebooks", 0)
        self.batched = scfg.batched and not codebooks
        if scfg.batched and not self.batched:
            _downgrade("batched serving requested but this model has a multi-codebook "
                       "head -- falling back to the slot-wise decode loop")
        # a ring buffer holds exactly the window: an admission chunk, and the
        # verify pass's 1 + K tokens, must fit inside it
        window = getattr(getattr(model, "attn_cfg", None), "window", 0)
        self._chunk_cap = window if self.batched else 0
        self._draft_len = 0
        if scfg.draft_len > 0:
            if not self.batched:
                _downgrade("draft_len > 0 requested but speculation needs the batched "
                           "stacked-cache path -- speculative decode disabled")
            elif all(hasattr(model, m) for m in _SPEC_API):
                self._draft_len = min(scfg.draft_len, window - 1) if window else scfg.draft_len
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
        self.paged = False
        self.prefix: Optional[RadixPrefixCache] = None
        self.pool: Optional[PagePool] = None
        self._prefix_hits = 0
        self._prefix_lookups = 0
        if scfg.paged or scfg.prefix_cache:
            if not self.batched:
                _downgrade("paged KV requested but the engine runs the slot-wise loop -- "
                           "paging needs the batched stacked-cache path; running the dense "
                           "cache")
            elif getattr(model, "paged_attention", False):
                self.paged = True
            else:
                _downgrade("paged KV requested but this model's cache state has no "
                           "page-granular layout (ring-buffer / recurrent state) -- running "
                           "the dense cache")
        if self.paged:
            ps = max(1, scfg.page_size)
            self._page_size = ps
            nb = -(-self._cache_len // ps)
            self._blocks_per_slot = nb
            # nb * ps rows a slot: the gathered decode view then has the dense
            # cache's length, so decode attention splits as the dense step does
            self._cache_len = nb * ps
            # default pool: every slot can fill all its blocks, plus the trash
            # page, so admission never deadlocks (tree-only pages are evictable)
            npages = scfg.num_pages or scfg.max_batch * nb + 1
            self.cache = model.init_paged_cache(scfg.max_batch, npages, ps,
                                                dtype=ccfg.resolved_kv_dtype, device=self.device)
            self.pool = PagePool(npages)
            self._bt = np.zeros((scfg.max_batch, nb), np.int32)
            self._slot_pages: List[List[int]] = [[] for _ in range(scfg.max_batch)]
            self._watermark_pages = max(1, int(scfg.evict_watermark * (npages - 1)))
            if scfg.prefix_cache:
                self.prefix = RadixPrefixCache(self.pool, ps, copy_page=self._cow_page)
        elif self.batched:
            self.cache = model.init_cache(scfg.max_batch, self._cache_len,
                                          dtype=ccfg.resolved_kv_dtype, device=self.device)
        else:
            # the slot-wise loop: one prefill-built cache per resident request
            self._cache_len = scfg.max_len
            self.cache = None
            self.caches: List[Any] = [None] * scfg.max_batch
        if scfg.crest_enabled:
            head = params.get("lm_head")
            if head is not None:
                self._probe_w = cascade.linear_weight(head, ccfg).to(torch.float32)
                self.crest_state = crest.crest_init(self._probe_w.shape[1], scfg.crest_cfg,
                                                    device=self.device)

    # ------------------------------------------------------------ admission
    def submit(self, req: Request):
        # an open-loop load generator (or a failover rebuild) pre-stamps the arrival;
        # stamping it again would erase queueing delay TTFT must charge
        if req.created_at == 0.0:
            req.created_at = self.clock.now()
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
            req.finished_at = self.clock.now()
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

    # ------------------------------------------------------ page management
    def _bt_dev(self) -> torch.Tensor:
        """A device copy of the host block table, taken now, in int64 (the
        index type, so no layer casts it): through a pinned buffer as one
        non-blocking copy on the card (the pinned block is not reused before
        the copy has run). Later host edits of the table do not reach it."""
        host = torch.from_numpy(self._bt.astype(np.int64))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _alloc_page(self) -> int:
        """One page off the pool. Under the prefix cache, pool use above the
        watermark first evicts LRU tree-only pages, and a full pool one more.
        With the default pool size this never raises."""
        if self.prefix is not None:
            self.prefix.maybe_evict(self._watermark_pages)
            if self.pool.free_pages == 0:
                self.prefix.evict(1)
        return self.pool.alloc()

    def _cow_page(self, src: int) -> Optional[int]:
        """The radix tree's copy-on-write hook: clone page ``src`` for a
        stream that departs from it mid-page. No eviction here (the tree is
        mid-walk and the LRU victim could be ``src``): a full pool skips the
        partial-page match."""
        if self.pool.free_pages == 0:
            return None
        dst = self.pool.alloc()
        self.model.paged_copy_page(self.cache, src, dst)
        return dst

    def _ensure_pages(self, slot: int, n_tokens: int):
        """Back the slot's first ``n_tokens`` rows with pages."""
        needed = min(-(-n_tokens // self._page_size), self._blocks_per_slot)
        pages = self._slot_pages[slot]
        while len(pages) < needed:
            pg = self._alloc_page()
            self._bt[slot, len(pages)] = pg
            pages.append(pg)

    def _release_slot_pages(self, slot: int):
        """Drop the slot's page refs and point its table row at the trash
        page. Pages the radix tree holds stay resident for later hits."""
        for pg in self._slot_pages[slot]:
            self.pool.release(pg)
        self._slot_pages[slot] = []
        self._bt[slot, :] = 0

    def _slot_cache(self, slot: int) -> dict:
        """The paged cache as the admitting slot alone sees it: the shared
        pools beside a view of the slot's ``pos``, advanced in place."""
        lay = self.cache["layers"]
        return {"layers": {**lay, "pos": lay["pos"][:, slot:slot + 1]}}

    def _start_paged(self, req: Request, slot: int) -> int:
        """Map the prompt's resident prefix pages into the slot's block table
        (under the prefix cache) and set the slot's ``pos`` to the matched
        length, where its prefill starts."""
        matched = 0
        if self.prefix is not None:
            m = self.prefix.match(req.prompt)
            self._slot_pages[slot] = list(m.pages)
            self._bt[slot, :len(m.pages)] = m.pages
            matched = m.matched
            self._prefix_hits += m.hit_full
            self._prefix_lookups += len(req.prompt)
        cache_utils.reset_slot_pos(self.cache, slot, matched)
        return matched

    @torch.no_grad()
    def _admit(self):
        """Spend up to ``token_budget`` prompt tokens on (chunked) prefill:
        into a batch-1 staging cache, or (paged) straight into the slot's
        pages. Under the prefix cache only the unmatched suffix is prefilled
        and counted against the budget. The slot-wise loop prefills whole
        prompts into free slots instead (``_admit_slotwise``)."""
        if not self.batched:
            self._admit_slotwise()
            return
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
                req.admitted_at = self.clock.now()
                self._admission_waits.append(req.admitted_at - req.created_at)
                if self.paged:
                    self._staging = _Staging(req, self._slot_cache(slot),
                                             self._start_paged(req, slot), slot)
                else:
                    sub = self.model.init_cache(1, self._cache_len,
                                                dtype=self.ccfg.resolved_kv_dtype,
                                                device=self.device)
                    self._staging = _Staging(req, sub, 0, slot)
            st = self._staging
            prompt = st.req.prompt
            chunk = self.scfg.prefill_chunk or len(prompt)
            if self._chunk_cap:
                chunk = min(chunk, self._chunk_cap)
            logits = None
            while st.consumed < len(prompt) and spent < budget:
                # the dense engine's chunk holding row ``consumed`` starts
                # at ``c0`` (after a prefix hit, admission may start mid-chunk)
                c0 = st.consumed - st.consumed % chunk
                n = min(c0 + chunk - st.consumed, len(prompt) - st.consumed)
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :n] = prompt[st.consumed:st.consumed + n]
                batch = {"tokens": self._tokens(toks)}
                if self.paged:
                    self._ensure_pages(st.slot, st.consumed + n)
                    batch["block_table"] = self._bt_dev()[st.slot:st.slot + 1]
                # the chunk's valid rows end by c0 + chunk: no key past that
                # is live for them (pad rows past it attend to garbage)
                logits, st.cache = self.model.prefill_extend(
                    self.params, batch, st.cache, self.ccfg, n_valid=n, kv_len=c0 + chunk)
                st.consumed += n
                spent += n
            if st.consumed < len(prompt):
                return                      # budget exhausted mid-prompt
            nxt = self._pick(logits[0, -1])
            self._commit_token(st.req, nxt)
            if self.paged:
                if self.prefix is not None:
                    # publish the prompt's full pages for later hits
                    self.prefix.insert(prompt, self._slot_pages[st.slot])
            else:
                self.model.write_cache(self.cache, st.cache, st.slot)
            self.slots[st.slot] = st.req
            if self.spec:
                # the visible stream: the prompt (failover-carried tokens are
                # already inside it) and every token emitted since
                self._spec_ctx[st.slot] = (st.req.prompt.tolist()
                                           + st.req.tokens_out[st.req.prompt_carried:])
            self._staging = None
            # the prefill-generated token may already end the stream
            self._retire_if_done(st.req, st.slot, nxt)

    def _admit_slotwise(self):
        """The slot-wise loop's admission: each free slot takes the next
        request and prefills its whole prompt into a cache of its own."""
        for i in range(self.scfg.max_batch):
            if self.slots[i] is None and self.queue:
                req = self._pop_admittable()
                if req is None:
                    return
                req.admitted_at = self.clock.now()
                self._admission_waits.append(req.admitted_at - req.created_at)
                logits, cache = self.model.prefill(
                    self.params, {"tokens": self._tokens(req.prompt[None].astype(np.int32))},
                    self.ccfg, max_len=self.scfg.max_len)
                # a multi-codebook row (C, V) picks codebook 0, as decode does
                # (the reference's flat argmax over C * V ids can pass the
                # vocabulary)
                row = logits[0, -1]
                nxt = self._pick(row if row.dim() == 1 else row[0])
                self._commit_token(req, nxt)
                self.slots[i] = req
                self.caches[i] = cache
                # the prefill-generated token may already end the stream
                self._retire_if_done(req, i, nxt)

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
        """Commit a token with its clock reading; ``first_token_at`` is set
        once a stream (a failover clone arrives with it set)."""
        req.tokens_out.append(tok)
        req.token_times.append(self.clock.now())
        if req.first_token_at == 0.0:
            req.first_token_at = req.token_times[-1]

    @staticmethod
    def _used(req: Request) -> int:
        """Cache rows the stream uses: the prompt (carried tokens inside it)
        and every token emitted since."""
        return len(req.prompt) + len(req.tokens_out) - req.prompt_carried

    def _retire_if_done(self, req: Request, i: int, nxt: int):
        used = self._used(req)
        if (len(req.tokens_out) >= req.max_new_tokens
                or nxt == self.scfg.eos_id
                # context limit: the next write would fall outside the cache
                # (never fires for recurrent archs: their state is O(1))
                or (not self.ctx_unbounded and used >= self.scfg.max_len)):
            req.done = True
            req.finished_at = self.clock.now()
            self._retired.append(req)
            self.slots[i] = None
            if self.paged:
                self._release_slot_pages(i)
            if not self.batched:
                self.caches[i] = None

    def _batch(self, toks: np.ndarray, active: List[int], rows_ahead: int) -> dict:
        """A step's batch dict: the tokens and, paged, the block table, after
        backing each active slot's rows up to ``rows_ahead`` past its pending
        token's row (``used - 1``) with pages."""
        batch = {"tokens": self._tokens(toks)}
        if self.paged:
            for i in active:
                self._ensure_pages(i, self._used(self.slots[i]) + rows_ahead)
            batch["block_table"] = self._bt_dev()
        return batch

    @torch.no_grad()
    def _decode_batched(self, active: List[int]) -> int:
        toks = np.zeros((self.scfg.max_batch, 1), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].tokens_out[-1]
        logits, self.cache = self.model.decode_step(
            self.params, self._batch(toks, active, 0), self.cache, self.ccfg)
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
            toks[i, 1:], keff[i] = ngram_propose(
                np.asarray(ctx[-self.scfg.ngram_lookback:], np.int32), k, self.scfg.ngram_max)
        # an active slot's cache holds its stream but the pending token, so
        # its chunk sits at [used - 1, used + k): no active row sees a key
        # past max(used) + k (inactive rows' outputs are discarded); rows past
        # a slot's capacity land in the trash page, as the dense cache's
        # headroom leaves them unread
        batch = self._batch(toks, active, k)
        toks_dev = batch["tokens"]
        live = max(self._used(self.slots[i]) for i in active) + k
        logits, self.cache, self._ckpt = self.model.spec_verify(
            self.params, batch, self.cache, self.ccfg, ckpt=self._ckpt, kv_len=live)
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
            lb = self.scfg.ngram_lookback
            if len(ctx) > 2 * lb:               # the drafter reads only the tail
                del ctx[:len(ctx) - lb]
        self.cache = self.model.spec_rewind(self.cache, self._ckpt, self._tokens(keep))
        return produced

    @torch.no_grad()
    def _decode_slotwise(self, active: List[int]) -> int:
        """One decode step per resident request, each on its own cache; a
        multi-codebook head's (1, 1, C, V) logits pick codebook 0."""
        for i in active:
            req = self.slots[i]
            tok = self._tokens(np.asarray([[req.tokens_out[-1]]], np.int32))
            logits, self.caches[i] = self.model.decode_step(self.params, {"tokens": tok},
                                                            self.caches[i], self.ccfg)
            nxt = self._pick(logits[0, -1] if logits.dim() == 3 else logits[0, -1, 0])
            self._commit_token(req, nxt)
            self._retire_if_done(req, i, nxt)
        return len(active)

    def step(self) -> int:
        """One engine step; returns the number of decode tokens produced."""
        self._admit()
        active = self._active()
        if not active:
            return 0
        t0 = self.clock.now()
        self._steps += 1
        if self.scfg.crest_enabled and self._steps % self.scfg.crest_every == 0:
            self._crest_probe()
        produced = (self._decode_spec(active) if self.spec
                    else self._decode_batched(active) if self.batched
                    else self._decode_slotwise(active))
        self.step_times.append(self.clock.now() - t0)
        self._decode_tokens += produced
        return produced

    def busy(self) -> bool:
        return bool(self.queue) or self._staging is not None or bool(self._active())

    # ------------------------------------------------------------- failover
    def evict(self, i: int) -> Optional[Request]:
        """Free slot i and return its request. Its cache rows become garbage:
        the stream's state is rebuilt from its prompt and emitted tokens."""
        req = self.slots[i]
        self.slots[i] = None
        if self.paged:
            self._release_slot_pages(i)
        if not self.batched:
            self.caches[i] = None
        return req

    def abort_in_flight(self) -> List[Request]:
        """Evict every resident request and the one mid-prefill (a replica's
        death): the requests, for the fleet to rebuild elsewhere."""
        out = [r for r in (self.evict(i) for i in self._active()) if r is not None]
        if self._staging is not None:
            if self.paged:
                self._release_slot_pages(self._staging.slot)
            out.append(self._staging.req)
            self._staging = None
        return out

    def load(self) -> int:
        """Queued, resident and mid-prefill requests (the fleet's dispatch
        balances on it)."""
        return (len(self.queue) + sum(r is not None for r in self.slots)
                + (self._staging is not None))

    def straggler_p99(self) -> float:
        """The 99th percentile of the recorded step times (0 before any)."""
        if not self.step_times:
            return 0.0
        return float(np.percentile(np.asarray(self.step_times), 99))

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        n0 = len(self._retired)
        for _ in range(max_steps):
            self.step()
            if not self.busy():
                break
        return self._retired[n0:]

    # ---------------------------------------------------------------- crest
    @torch.no_grad()
    def _crest_probe(self):
        """A CREST probe wave (paper Section 20.6: CREST doubles as power-on
        and built-in self-test with test vectors): the CREST-protected matmul
        on the dense f32 ``lm_head`` with a random (4, K) f32 input; detected
        faults accumulate in ``crest_state`` and are repaired by spare
        recomputation. The input comes from a ``torch.Generator`` on the
        engine's device seeded by the step count, as the reference seeds its
        key by it; threefry's bits cannot be reproduced in torch, so the
        vectors differ from the reference's (any input detects a corrupted
        column: the injected corruption is 7 + 0.5 y). No host sync."""
        if self._probe_w is None:
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._steps)
        x = torch.randn((4, self._probe_w.shape[0]), generator=gen, device=self.device)
        _, self.crest_state = crest.crest_matmul(x, self._probe_w, self.crest_state,
                                                 self.scfg.crest_cfg, self.fault_mask)

    def crest_report(self) -> dict:
        if self.crest_state is None:
            return {}
        return {"confirmed_faults": int(self.crest_state.confirmed_faults.sum()),
                "repaired": int(self.crest_state.n_repaired)}

    # -------------------------------------------------------------- metrics
    @property
    def effective_mode(self) -> str:
        """The decode path this engine actually runs, downgrades included:
        '{spec|batched|slotwise}-{greedy|sampled}[-fused][-paged]'."""
        decode = "spec" if self.spec else "batched" if self.batched else "slotwise"
        mode = f"{decode}-{'sampled' if self._sampled else 'greedy'}"
        return mode + ("-fused" if self.fused else "") + ("-paged" if self.paged else "")

    @staticmethod
    def latency_percentiles(requests) -> dict:
        """TTFT (first committed token minus ``created_at``, the arrival
        under an open-loop load generator) and inter-token gaps (successive
        differences of each request's ``token_times``) percentiles over the
        requests that produced a token."""
        tt = np.asarray([r.first_token_at - r.created_at for r in requests
                         if r.first_token_at > 0.0], np.float64)
        gp = np.asarray([b - a for r in requests
                         for a, b in zip(r.token_times, r.token_times[1:])], np.float64)
        pct = lambda a, q: float(np.percentile(a, q)) if a.size else 0.0
        return {"ttft_p50_s": pct(tt, 50), "ttft_p99_s": pct(tt, 99),
                "inter_token_p50_s": pct(gp, 50), "inter_token_p99_s": pct(gp, 99)}

    def metrics(self) -> dict:
        """Throughput/latency counters."""
        st = np.asarray(self.step_times, np.float64)
        total = float(st.sum()) if st.size else 0.0
        return {
            **self.latency_percentiles(self._retired),
            "batched": self.batched,
            "effective_mode": self.effective_mode,
            "downgrades": list(self.downgrades),
            "fused": self.fused,
            "device": str(self.device),
            "paged": self.paged,
            "page_size": self._page_size if self.paged else 0,
            "prefix_cache": self.prefix is not None,
            "prefix_hits": self._prefix_hits,
            "prefix_lookups": self._prefix_lookups,
            # the share of submitted prompt tokens served from resident pages
            "prefix_hit_rate": (self._prefix_hits / self._prefix_lookups
                                if self._prefix_lookups else 0.0),
            "pages_in_use": self.pool.pages_in_use if self.paged else 0,
            "pages_total": self.pool.num_pages - 1 if self.paged else 0,
            "evictions": self.prefix.evictions if self.prefix is not None else 0,
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
