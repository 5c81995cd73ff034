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
its prompt (``Request.prompt_carried`` of them).

``mesh=`` (a ``launch.mesh.Mesh`` over the live process group) serves
explicit SPMD: every rank runs this engine on the same requests, with the
same scheduler, and holds only its own bands. The params are placed by
``filter_divisible(param_specs(params, tp_policy))`` (``distributed/
sharding.py``; whole params are cut, params drawn through
``sharding.param_placer`` are taken as they are): under ``cascade`` every
linear computes its output columns
on each rank (the FP4 kernels too, with ``fused=True``) and all-gathers
them, so no partial sum crosses ranks; ``megatron`` row-bands the modules
that return to d_model and all-reduces their partial sums. The KV heads
are banded over ``model`` where they divide it (``sharding.kv_head_bands``,
the part of the reference's ``cache_specs`` the engine places; the
reference's engine places none), and each rank attends on its heads. The
other model bands of ``cache_specs`` (the time band where the heads do not
divide, latent rows, recurrent state) are placed by the dry run, whose
decode step carries them, not by the engine. The slot grid is banded over ``data``
when ``max_batch`` divides that axis (the cache placed by
``model.cache_pspecs``: each data shard holds its slots), else
replicated. Each step's closure runs its shard's rows, then all-gathers
the tokens over ``data``, so every rank's scheduler commits the whole
grid's. Sampling draws the full grid's noise on every rank from the one
generator and keeps its rows, so the streams are the unsharded engine's.
Admission prefills a batch-1 staging cache on every rank (replicated over
``data``, as the reference's staging cache) and the owning shard writes it
into its slot. Every closure counts its collectives
(``distributed/collectives.py``; ``step_closures()[name]["collectives"]``
after a call), the counterpart of the reference's ``decode_step_hlo``. As
in the reference, a mesh refuses the slot-wise loop (``ValueError``) and
downgrades paged KV and the prefix cache to the dense cache.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import cascade, crest
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.models import cache_utils
from repro_torch.serve.prefix import PagePool, RadixPrefixCache
from repro_torch.serve.spec import ngram_propose
from repro_torch.serve.traffic import MonotonicClock
from repro_torch.trace import span

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


def _draw(shape: tuple, gen: torch.Generator, device, rows: Optional[tuple]) -> torch.Tensor:
    """Uniforms of ``shape``; with ``rows`` = (lo, hi, total), the draw is
    made for all ``total`` rows of the grid and rows lo:hi are kept (a data
    shard's), so every shard's generator advances alike."""
    if rows is None:
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    lo, hi, total = rows
    return torch.rand((total,) + tuple(shape[1:]), generator=gen, device=device,
                      dtype=torch.float32)[lo:hi]


def _gumbel_argmax(x: torch.Tensor, gen: torch.Generator,
                   rows: Optional[tuple] = None) -> torch.Tensor:
    """(B, V) -> (B,) draws from softmax(x): argmax of x plus Gumbel noise.
    The noise is drawn for every row from the generator's stream by
    position, so an active row's draw never depends on another row's
    logits (``rows``: see :func:`_draw`)."""
    u = _draw(x.shape, gen, x.device, rows)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(x + gumbel, dim=-1)


def _sample_tokens(logits: torch.Tensor, gen: torch.Generator, temperature: float,
                   top_k: int, rows: Optional[tuple] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) sampled token ids, on the logits' device."""
    return _gumbel_argmax(_truncate_logits(logits, temperature, top_k), gen, rows)


#: finite logit penalty that removes the rejected draft from the residual.
#: Finite on purpose: if the residual is EMPTY (p was numerically a point
#: mass on the draft), the penalized draft still wins, the right action for
#: a "rejection" that only float rounding made possible.
_RESIDUAL_PENALTY = 1e30


def spec_sample_accept(logits: torch.Tensor, drafts: torch.Tensor, k_eff: torch.Tensor,
                       gen: torch.Generator, temperature: float, top_k: int,
                       noise_rows: Optional[tuple] = None):
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
    = p(t), plain sampled decode's distribution. ``noise_rows``: a data
    shard's rows of the grid (see :func:`_draw`)."""
    b, kp1, v = logits.shape
    k = kp1 - 1
    dev = logits.device
    x = _truncate_logits(logits, temperature, top_k)             # (B, K+1, V)
    logp = torch.log_softmax(x, dim=-1)
    drafts = drafts.to(device=dev, dtype=torch.int64)
    k_eff = k_eff.to(device=dev, dtype=torch.int64)
    p_draft = torch.exp(torch.gather(logp[:, :k], 2, drafts[..., None])[..., 0])   # (B, K)
    u = _draw((b, k), gen, dev, noise_rows)
    real = torch.arange(k, device=dev)[None, :] < k_eff[:, None]
    accept = (u < p_draft) & real
    a = torch.cumprod(accept.to(torch.int64), dim=-1).sum(dim=-1)   # leading accepts
    rows = torch.arange(b, device=dev)
    row = x[rows, a]                                                 # (B, V)
    rejected = a < k_eff
    d_rej = drafts[rows, torch.clamp(a, max=k - 1)]
    hit = (torch.arange(v, device=dev)[None, :] == d_rej[:, None]) & rejected[:, None]
    row = row - hit.to(row.dtype) * _RESIDUAL_PENALTY
    return a, _gumbel_argmax(row, gen, noise_rows)


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
    tp_policy: str = "cascade"    # param placement under a mesh: 'cascade' (column-
                                  # parallel, no partial-sum all-reduce) or 'megatron'
                                  # (row+column baseline with its all-reduces)


@dataclasses.dataclass
class _Staging:
    """A request mid-prefill: holds its batch-1 cache until fully prefilled."""
    req: Request
    cache: Any
    consumed: int
    slot: int


def _closure(name: str, grid: bool = False):
    """A step closure of the engine: on a mesh it runs under the engine's
    activation policy, plans its attention as the whole grid's (``grid``:
    over the slot grid's rows, else a batch-1 admission; ``_planned_rows``)
    and records its counted collectives in ``engine.collectives[name]``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(self, *args):
            if self.mesh is None:
                return fn(self, *args)
            before = collectives.snapshot()
            with sharding.activation_policy(self._policy), self._planned_rows(grid):
                out = fn(self, *args)
            self.collectives[name] = collectives.since(before)
            return out
        return run
    return deco


class ServeEngine:
    def __init__(self, model, params, ccfg: CascadeConfig, scfg: ServeConfig,
                 mesh=None, device=None, clock=None):
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
        self.mesh = mesh
        self.tp_policy = scfg.tp_policy
        if mesh is not None and not self.batched:
            raise ValueError("mesh serving requires the batched stacked-cache path "
                             "(batched=True and a model with a flat-logits head)")
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
        self._place_on_mesh(params)
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
            elif mesh is not None:
                _downgrade("paged KV requested with a device mesh -- pool leaves have no "
                           "slot axis to shard over data; running the dense cache")
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
            self.cache = self._new_cache(self._b1 - self._b0)
        else:
            # the slot-wise loop: one prefill-built cache per resident request
            self._cache_len = scfg.max_len
            self.cache = None
            self.caches: List[Any] = [None] * scfg.max_batch
        if scfg.crest_enabled:
            head = self.params.get("lm_head")
            if head is not None:
                with sharding.activation_policy(self._policy):      # its bands, joined
                    self._probe_w = cascade.linear_weight(head, ccfg).to(torch.float32)
                self.crest_state = crest.crest_init(self._probe_w.shape[1], scfg.crest_cfg,
                                                    device=self.device)

    # ----------------------------------------------------------------- mesh
    def _place_on_mesh(self, params):
        """Place the params on ``self.mesh`` (this rank's bands) and choose
        this rank's rows of the slot grid, ``[_b0, _b1)``: a data shard's
        band when ``max_batch`` divides the data axis, else all of them.
        The specs come from the model's tree drawn on the meta device: whole
        params are cut to their bands, and params with the bands' shapes
        are taken as this rank's bands already (drawn through
        ``sharding.param_placer``)."""
        b = self.scfg.max_batch
        self._b0, self._b1 = 0, b
        self._policy = None
        self._head_factor = 1         # KV heads of the whole cache / this rank's
        self.collectives: Dict[str, dict] = {}
        mesh = self.mesh
        if mesh is None:
            return
        ds = mesh.size("data")
        if ds > 1 and b % ds == 0:
            self._b0 = mesh.coord("data") * (b // ds)
            self._b1 = self._b0 + b // ds
        tied = bool(getattr(self.model.cfg, "tie_embeddings", False))
        whole = self.model.init_params(0, self.ccfg, device="meta")
        self.param_specs = sharding.placed_param_specs(whole, mesh, self.scfg.tp_policy, tied)
        shapes = lambda tree: [(p, tuple(t.shape)) for p, t in T.leaves_with_paths(tree)]
        if shapes(params) == shapes(whole):
            self.params = sharding.shard_tree(params, self.param_specs, mesh)
        elif shapes(params) == shapes(sharding.shard_tree(whole, self.param_specs, mesh)):
            self.params = params
        else:
            raise ValueError(f"the params are neither the whole {self.model.cfg.name} tree nor "
                             f"this rank's {self.scfg.tp_policy} bands of it on {mesh}")
        cache = self.model.init_cache(b, self._cache_len, device="meta")
        self._head_bands = sharding.kv_head_bands(cache, mesh)
        self.cache_specs = sharding.merge_specs(self.model.cache_pspecs(cache, mesh),
                                                self._head_bands)
        self._policy = sharding.ActivationPolicy(mesh, self.scfg.tp_policy, self.params,
                                                 self.param_specs,
                                                 cache_bands=self._head_bands)
        if self._policy.cache_band("k") is not None:
            self._head_factor = mesh.size("model")

    @property
    def _data_sharded(self) -> bool:
        return self._b1 - self._b0 < self.scfg.max_batch

    def _rows(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a whole-grid tensor."""
        return t if t is None or not self._data_sharded else t[self._b0:self._b1]

    def _grid(self, t: torch.Tensor) -> torch.Tensor:
        """The whole grid's rows of a per-shard result, gathered over data."""
        if not self._data_sharded:
            return t
        return collectives.all_gather(t, self.mesh.group("data"), dim=0)

    def _new_cache(self, batch: int):
        """A cache of ``batch`` slots as this rank holds it: its band of the
        KV heads on a mesh (the staging cache of an admission too)."""
        cache = self.model.init_cache(batch, self._cache_len, dtype=self.ccfg.resolved_kv_dtype,
                                      device=self.device)
        if self._head_factor == 1:
            return cache
        return sharding.shard_tree(cache, self._head_bands, self.mesh)

    def _planned_rows(self, grid: bool):
        """Attention launches over this rank's rows (the grid's band, or a
        batch-1 admission) and heads plan as the whole grid's launch would
        (``ops.planned_rows``: the plan follows rows x KV heads), so the
        streams keep the unsharded engine's bits at any context length."""
        local = self._b1 - self._b0 if grid else 1
        whole = (self.scfg.max_batch if grid else 1) * self._head_factor
        if local == whole:
            return contextlib.nullcontext()
        return ops.planned_rows(local, whole)

    @property
    def _noise_rows(self) -> Optional[tuple]:
        return (self._b0, self._b1, self.scfg.max_batch) if self._data_sharded else None

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
        self.cache = self._copy_fn(self.cache, src, dst)
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

    def _slot_cache(self, slot: int, cache: Optional[dict] = None) -> dict:
        """The paged cache as the admitting slot alone sees it: the shared
        pools beside a view of the slot's ``pos``, advanced in place."""
        lay = (self.cache if cache is None else cache)["layers"]
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
        self.cache = self._reset_pos_fn(self.cache, slot, matched)
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
                    self._staging = _Staging(req, self._new_cache(1), 0, slot)
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
                bt = None
                if self.paged:
                    self._ensure_pages(st.slot, st.consumed + n)
                    bt = self._bt_dev()[st.slot:st.slot + 1]
                # the chunk's valid rows end by c0 + chunk: no key past that
                # is live for them (pad rows past it attend to garbage)
                with span("engine.admit.chunk"):
                    logits, st.cache = self._extend_fn(self.params, self._tokens(toks), st.cache,
                                                       bt, n, c0 + chunk)
                st.consumed += n
                spent += n
            if st.consumed < len(prompt):
                return                      # budget exhausted mid-prompt
            with span("engine.admit.pick"):
                nxt = self._pick(logits[0, -1])
            self._commit_token(st.req, nxt)
            if self.paged:
                if self.prefix is not None:
                    # publish the prompt's full pages for later hits
                    self.prefix.insert(prompt, self._slot_pages[st.slot])
            else:
                with span("engine.admit.write"):
                    self.cache = self._write_fn(self.cache, st.cache, st.slot)
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
        """Next token from a (V,) logits row (admission), read to the host."""
        return int(self._pick_fn(row))

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

    def _batch(self, toks: np.ndarray, active: List[int], rows_ahead: int) -> tuple:
        """A step's device token grid and, paged, block table (else None),
        after backing each active slot's rows up to ``rows_ahead`` past its
        pending token's row (``used - 1``) with pages."""
        bt = None
        if self.paged:
            for i in active:
                self._ensure_pages(i, self._used(self.slots[i]) + rows_ahead)
            bt = self._bt_dev()
        return self._tokens(toks), bt

    @torch.no_grad()
    def _decode_batched(self, active: List[int]) -> int:
        with span("engine.decode.prepare"):
            toks = np.zeros((self.scfg.max_batch, 1), np.int32)
            for i in active:
                toks[i, 0] = self.slots[i].tokens_out[-1]
            toks_dev, bt = self._batch(toks, active, 0)
        step = self._sample_fn if self._sampled else self._decode_fn
        with span("engine.decode.forward"):
            nxt, self.cache = step(self.params, toks_dev, self.cache, bt)
        with span("engine.decode.sync"):
            nxt = nxt.cpu().numpy()     # the step's one read to the host
        with span("engine.decode.commit"):
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
        toks_dev, bt = self._batch(toks, active, k)
        live = max(self._used(self.slots[i]) for i in active) + k
        if self._sampled:
            acc, fin, self.cache, self._ckpt = self._spec_sample_fn(
                self.params, toks_dev, self.cache, bt, self._tokens(keff), live)
            acc, fin = acc.cpu().numpy(), fin.cpu().numpy()
        else:
            greedy, self.cache, self._ckpt = self._verify_fn(self.params, toks_dev, self.cache,
                                                             bt, live)
            greedy = greedy.cpu().numpy()                            # (B, K+1)
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
        self.cache = self._rewind_fn(self.cache, self._ckpt, self._tokens(keep))
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

    # -------------------------------------------------------- step closures
    # The model-level calls a batched step makes, by the reference's names
    # (its jitted closures): each takes the params where it reads them, the
    # device token grid and the cache, and returns the cache it updated in
    # place. ``step()`` goes through them and ``step_closures()`` lists them,
    # so ``repro_torch.analysis`` audits what the step runs; the one read to
    # the host (the step's tokens) follows them.
    #
    # On a mesh every closure takes the whole grid's token rows, runs this
    # rank's rows of them (``_rows``) on its local cache under the engine's
    # activation policy, and returns the whole grid's results (``_grid``),
    # counting its collectives into ``self.collectives[name]``.
    @staticmethod
    def _batch_of(toks: torch.Tensor, bt: Optional[torch.Tensor]) -> dict:
        return {"tokens": toks} if bt is None else {"tokens": toks, "block_table": bt}

    @_closure("decode", grid=True)
    @torch.no_grad()
    def _decode_fn(self, params, toks, cache, bt=None):
        """decode_step over the slot grid, then each row's argmax (B,)."""
        logits, cache = self.model.decode_step(params, self._batch_of(self._rows(toks), bt),
                                               cache, self.ccfg)
        # torch.argmax returns the first maximum, as jnp.argmax does
        return self._grid(torch.argmax(logits[:, -1], dim=-1)), cache

    @_closure("sample", grid=True)
    @torch.no_grad()
    def _sample_fn(self, params, toks, cache, bt=None):
        """decode_step over the slot grid, then one draw a row (B,)."""
        logits, cache = self.model.decode_step(params, self._batch_of(self._rows(toks), bt),
                                               cache, self.ccfg)
        return self._grid(_sample_tokens(logits[:, -1], self._gen, self.scfg.temperature,
                                         self.scfg.top_k, self._noise_rows)), cache

    @_closure("extend")
    @torch.no_grad()
    def _extend_fn(self, params, toks, cache, bt, n_valid: int, kv_len: int):
        return self.model.prefill_extend(params, self._batch_of(toks, bt), cache, self.ccfg,
                                         n_valid=n_valid, kv_len=kv_len)

    @_closure("write")
    @torch.no_grad()
    def _write_fn(self, cache, staging, slot: int):
        """Write a staging cache into ``slot``: on a mesh, only the data
        shard that holds the slot writes."""
        if not self._b0 <= slot < self._b1:
            return cache
        return self.model.write_cache(cache, staging, slot - self._b0)

    @_closure("verify", grid=True)
    @torch.no_grad()
    def _verify_fn(self, params, toks, cache, bt, kv_len: int):
        """The verify pass and each position's argmax (B, K+1)."""
        logits, cache, ckpt = self.model.spec_verify(params,
                                                     self._batch_of(self._rows(toks), bt),
                                                     cache, self.ccfg, ckpt=self._ckpt,
                                                     kv_len=kv_len)
        return self._grid(torch.argmax(logits, dim=-1)), cache, ckpt

    @_closure("spec_sample", grid=True)
    @torch.no_grad()
    def _spec_sample_fn(self, params, toks, cache, bt, keff, kv_len: int):
        """The verify pass, then acceptance and resampling on the device."""
        toks = self._rows(toks)
        logits, cache, ckpt = self.model.spec_verify(params, self._batch_of(toks, bt), cache,
                                                     self.ccfg, ckpt=self._ckpt, kv_len=kv_len)
        acc, fin = spec_sample_accept(logits, toks[:, 1:], self._rows(keff), self._gen,
                                      self.scfg.temperature, self.scfg.top_k, self._noise_rows)
        return self._grid(acc), self._grid(fin), cache, ckpt

    @_closure("rewind")
    @torch.no_grad()
    def _rewind_fn(self, cache, ckpt, keep):
        return self.model.spec_rewind(cache, ckpt, self._rows(keep))

    @torch.no_grad()
    def _copy_fn(self, cache, src: int, dst: int):
        return self.model.paged_copy_page(cache, src, dst)

    @torch.no_grad()
    def _reset_pos_fn(self, cache, slot: int, value: int):
        return cache_utils.reset_slot_pos(cache, slot, value)

    @_closure("pick")
    @torch.no_grad()
    def _pick_fn(self, row: torch.Tensor) -> torch.Tensor:
        """Admission's next token from a (V,) logits row: argmax, or one draw
        from the engine's generator; a 0-d tensor on the row's device."""
        if not self._sampled:
            return torch.argmax(row)
        return _sample_tokens(row[None], self._gen, self.scfg.temperature, self.scfg.top_k)[0]

    def step_closures(self) -> Dict[str, dict]:
        """Every step closure this engine's mode makes, by name: ``{"fn",
        "donates_cache", "takes_params", "cache_arg", "cache_out"}``.
        ``cache_arg`` is the cache's index among the closure's arguments
        (:meth:`step_example_args`), ``cache_out`` its index among the
        outputs (-1: the output is the cache; None: no cache). The reference
        donates the cache to its closures; here they update it in place,
        which ``repro_torch.analysis.contract`` checks leaf by leaf. On a
        mesh each entry also has ``"collectives"``: the counted collectives
        of the closure's last call (``collectives.since``), None before one."""
        assert self.batched, "step closures exist only on the batched engine"
        reg: Dict[str, dict] = {}

        def add(name, fn, cache_arg, cache_out, takes_params=True):
            reg[name] = {"fn": fn, "donates_cache": cache_arg is not None,
                         "takes_params": takes_params, "cache_arg": cache_arg,
                         "cache_out": cache_out}

        add("decode", self._decode_fn, 2, 1)
        add("extend", self._extend_fn, 2, 1)
        if not self.paged:
            add("write", self._write_fn, 0, -1, takes_params=False)
        if self.spec:
            add("verify", self._verify_fn, 2, 1)
            add("rewind", self._rewind_fn, 0, -1, takes_params=False)
            if self._sampled:
                add("spec_sample", self._spec_sample_fn, 2, 2)
        if self._sampled:
            add("sample", self._sample_fn, 2, 1)
        if self.paged:
            add("copy_page", self._copy_fn, 0, -1, takes_params=False)
            add("reset_pos", self._reset_pos_fn, 0, -1, takes_params=False)
        add("pick", self._pick_fn, None, None, takes_params=False)
        if self.mesh is not None:
            for name, entry in reg.items():
                entry["collectives"] = self.collectives.get(name)
        return reg

    def step_example_args(self, name: str, cache: dict) -> tuple:
        """Arguments shaped as ``step()`` passes them to closure ``name``,
        over ``cache`` (a copy of the engine's, so a closure's writes land
        there): zero token grids on the device, the live block table, a
        fresh staging cache for dense admission. ``rewind`` takes the
        checkpoint of the last verify pass (one on ``cache`` if none ran)."""
        b = self.scfg.max_batch
        dev = self.device
        bt = self._bt_dev() if self.paged else None
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
        if name in ("decode", "sample"):
            return (self.params, zeros(b, 1), cache, bt)
        if name in ("verify", "spec_sample"):
            live = self._draft_len + 1
            if name == "verify":
                return (self.params, zeros(b, live), cache, bt, live)
            return (self.params, zeros(b, live), cache, bt, zeros(b), live)
        if name == "extend":
            chunk = self.scfg.prefill_chunk or self.scfg.max_len
            if self._chunk_cap:
                chunk = min(chunk, self._chunk_cap)
            if self.paged:
                return (self.params, zeros(1, chunk), self._slot_cache(0, cache), bt[:1], chunk,
                        chunk)
            return (self.params, zeros(1, chunk), self._new_cache(1), None, chunk, chunk)
        if name == "write":
            return (cache, self._new_cache(1), 0)
        if name == "rewind":
            ckpt = self._ckpt
            if ckpt is None:        # no verify pass yet: make one on this cache
                ckpt = self._verify_fn(*self.step_example_args("verify", cache))[2]
            return (cache, ckpt, zeros(b).to(torch.int64))
        if name in ("copy_page", "reset_pos"):
            return (cache, 0, 0)
        if name == "pick":
            return (torch.zeros((int(self.model.cfg.vocab),), dtype=torch.float32, device=dev),)
        raise KeyError(f"unknown step closure {name!r}")

    def step(self) -> int:
        """One engine step; returns the number of decode tokens produced."""
        with span("engine.admit"):
            self._admit()
        active = self._active()
        if not active:
            return 0
        with span("engine.decode"):
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
            "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
            "tp_policy": self.tp_policy,
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
