"""Serving engine: greedy continuous batching over a fixed slot grid.

``ServeEngine`` owns ``max_batch`` decode slots backed by ONE stacked KV
cache. Each step:

1. **admission** -- queued requests are prefilled into a batch-1 staging
   cache in ``prefill_chunk``-token pieces (``prefill_extend``), at most
   ``token_budget`` prompt tokens per step; a fully prefilled request is
   copied into its slot and its first token is picked;
2. **decode** -- ONE batched ``decode_step`` runs over the whole slot grid;
   idle slots compute masked garbage that never escapes;
3. finished streams retire (eos, ``max_new_tokens`` or the context limit)
   by freeing their slot. A model with ``unbounded_context`` (Mamba-2: O(1)
   recurrent state) has no context limit: no prompt is too long for it and
   no stream retires on ``max_len``.

The reference donates its cache to each jitted step; this engine updates
the stacked cache IN PLACE instead (the model writes K/V rows and advances
``pos`` inside the tensors it is given), so the grid is allocated once.

``fused=True`` sends every linear through the FP4 CUDA matmul, single-token
attention through the CUDA decode-attention kernel and the Mamba-2 decode
recurrence through the CUDA SSD scan kernel (``kernels/ops.py``); on CPU
tensors those wrappers run their plain versions. Not ported yet (the engine
raises ``NotImplementedError`` when asked): speculative decode, sampling,
the paged KV pool and prefix cache, CREST probes, the slot-wise loop and
mesh serving.
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
    temperature: float = 0.0      # > 0 (sampling) is not ported: raises
    draft_len: int = 0            # > 0 (speculative decode) is not ported: raises
    fused: bool = False           # CUDA kernels (FP4 matmul, decode attention, SSD scan)
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
        ("draft_len > 0 (speculative decode, ROADMAP Queue 1 item 7)", scfg.draft_len > 0),
        ("temperature > 0 (sampling, ROADMAP Queue 1 item 7)", scfg.temperature > 0.0),
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
        self.fused = False
        if scfg.fused:
            if ccfg.mode != "serve_fp4":
                msg = (f"fused decode requested but ccfg.mode={ccfg.mode!r} -- the FP4 "
                       "kernel path needs packed serve_fp4 params (codes+scales); "
                       "running the plain path")
                self.downgrades.append(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
            else:
                self.fused = True
                ccfg = dataclasses.replace(ccfg, use_kernel=True)
        self.ccfg = ccfg
        # recurrent archs hold O(1) state: prompt length is not bounded by
        # the cache, and there is no context-limit retire
        self.ctx_unbounded = bool(getattr(model, "unbounded_context", False))
        # round the cache length up to a chunk multiple so padded chunk
        # writes never clamp into (and clobber) valid cache entries
        c = scfg.prefill_chunk
        self._cache_len = (-(-scfg.max_len // c) * c) if c > 0 else scfg.max_len
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
                logits, st.cache = self.model.prefill_extend(
                    self.params, {"tokens": self._tokens(toks)}, st.cache, self.ccfg,
                    n_valid=n)
                st.consumed += n
                spent += n
            if st.consumed < len(prompt):
                return                      # budget exhausted mid-prompt
            nxt = int(torch.argmax(logits[0, -1]))
            self._commit_token(st.req, nxt)
            self.model.write_cache(self.cache, st.cache, st.slot)
            self.slots[st.slot] = st.req
            self._staging = None
            # the prefill-generated token may already end the stream
            self._retire_if_done(st.req, st.slot, nxt)

    # --------------------------------------------------------------- decode
    def _active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]

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
        # torch.argmax returns the first maximum, as jnp.argmax does
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i in active:
            req = self.slots[i]
            tok = int(nxt[i])
            self._commit_token(req, tok)
            self._retire_if_done(req, i, tok)
        return len(active)

    def step(self) -> int:
        """One engine step; returns the number of decode tokens produced."""
        self._admit()
        active = self._active()
        if not active:
            return 0
        t0 = time.monotonic()
        produced = self._decode_batched(active)
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
        """The decode path this engine actually runs: 'batched-greedy[-fused]'."""
        return "batched-greedy" + ("-fused" if self.fused else "")

    def metrics(self) -> dict:
        """Throughput/latency counters."""
        st = np.asarray(self.step_times, np.float64)
        total = float(st.sum()) if st.size else 0.0
        return {
            "effective_mode": self.effective_mode,
            "downgrades": list(self.downgrades),
            "fused": self.fused,
            "device": str(self.device),
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
