"""Open-loop traffic and the serving path's clock (numpy only).

* **Clocks.** Every latency number the serving path records (request
  timestamps, admission waits, step times, replica EWMAs) reads an injected
  ``Clock``. ``MonotonicClock`` is wall time; ``VirtualClock`` is advanced
  by hand, so a traffic test replays the same per-request TTFT and
  inter-token records on every run (the harness, ``serve/router.py`` or
  ``ReplicaSet.step_cost``, advances it; engines only read it).
* **The generator.** ``poisson_trace`` builds a seeded open-loop trace:
  Poisson arrivals at ``rate_rps``, prompt and output lengths from weighted
  mixtures of uniform integer ranges, per-request SLOs (a TTFT target and
  an admission deadline after which the router sheds the request), and
  optionally prompts that open with one of a few shared prefixes. Open
  loop: each request's arrival is fixed at generation, so queueing delay
  under overload shows in TTFT instead of throttling the offered load.

The same config gives the same trace (arrival times, prompts, lengths, SLO
fields, ``prefix_id``) as the JAX package's ``serve/traffic.py``: the draws
come from one ``numpy.random.default_rng(seed)`` in the same order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Protocol, runtime_checkable

import numpy as np


# --------------------------------------------------------------------- clocks
@runtime_checkable
class Clock(Protocol):
    """``now()`` in seconds (monotone; the zero point is arbitrary) and
    ``sleep_until(t)`` for idle gaps: a wall clock sleeps, a virtual clock
    jumps."""

    def now(self) -> float: ...

    def sleep_until(self, t: float) -> float: ...


class MonotonicClock:
    """Wall time: ``time.monotonic`` behind the protocol."""

    def now(self) -> float:
        return time.monotonic()

    def sleep_until(self, t: float) -> float:
        time.sleep(max(0.0, t - time.monotonic()))
        return time.monotonic()


class VirtualClock:
    """A deterministic clock advanced by the harness (``advance``,
    ``advance_to``); engines only read it."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, f"virtual time cannot go backwards (dt={dt})"
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        """Jump forward to ``t`` (no-op if ``t`` is in the past)."""
        self._t = max(self._t, float(t))
        return self._t

    def sleep_until(self, t: float) -> float:
        """A virtual sleep is a jump: no wall time passes."""
        return self.advance_to(t)


# ------------------------------------------------------------------ generator
@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """A seeded open-loop workload. ``prompt_lens``/``output_lens`` are
    mixtures of inclusive ``(lo, hi)`` ranges weighted by
    ``prompt_mix``/``output_mix`` (lengths uniform inside the chosen range).
    ``slo_ttft_s`` and ``deadline_s`` stamp every request (0: none). With
    ``shared_prefix_len`` > 0 a ``shared_fraction`` of requests open with
    one of ``n_shared_prefixes`` fixed prefixes (their ``prefix_id``)."""
    rate_rps: float = 8.0             # Poisson arrival rate (requests/s)
    n_requests: int = 32
    prompt_lens: tuple = ((4, 16),)   # mixture of inclusive [lo, hi] ranges
    prompt_mix: tuple = (1.0,)
    output_lens: tuple = ((4, 16),)
    output_mix: tuple = (1.0,)
    vocab: int = 256
    slo_ttft_s: float = 0.0           # per-request TTFT target (0 = none)
    deadline_s: float = 0.0           # shed if not dispatched this long after arrival
    shared_prefix_len: int = 0        # tokens in each shared prefix (0 = no mixture)
    n_shared_prefixes: int = 1
    shared_fraction: float = 1.0      # probability a request opens with a shared prefix
    seed: int = 0


@dataclasses.dataclass
class Arrival:
    """One trace entry: a request and its arrival, in seconds from the
    trace's start."""
    at_s: float
    request: "object"                 # serve.engine.Request (deferred import)


def _mixture_lengths(rng: np.random.Generator, n: int, ranges: tuple,
                     mix: tuple) -> np.ndarray:
    """n integer lengths from a weighted mixture of inclusive ranges."""
    assert len(ranges) == len(mix) and len(ranges) >= 1, (ranges, mix)
    for lo, hi in ranges:
        assert 1 <= lo <= hi, f"bad length range ({lo}, {hi})"
    w = np.asarray(mix, np.float64)
    assert (w >= 0).all() and w.sum() > 0, f"bad mixture weights {mix}"
    comp = rng.choice(len(ranges), size=n, p=w / w.sum())
    lens = np.empty(n, np.int64)
    for j, (lo, hi) in enumerate(ranges):
        idx = comp == j
        lens[idx] = rng.integers(lo, hi + 1, size=int(idx.sum()))
    return lens


def poisson_trace(cfg: TrafficConfig) -> List[Arrival]:
    """Seeded open-loop trace: arrivals in order, with prompts, output
    budgets and SLO fields. ``at_s`` is relative to the trace's start;
    ``SLORouter.run_trace`` re-bases it onto its clock and stamps each
    request's ``created_at`` with its arrival, so queueing delay before
    dispatch is charged to TTFT."""
    from repro_torch.serve.engine import Request   # deferred: the engine imports the clocks

    rng = np.random.default_rng(cfg.seed)
    assert cfg.rate_rps > 0 and cfg.n_requests > 0
    gaps = rng.exponential(1.0 / cfg.rate_rps, cfg.n_requests)
    at = np.cumsum(gaps)
    plens = _mixture_lengths(rng, cfg.n_requests, cfg.prompt_lens, cfg.prompt_mix)
    olens = _mixture_lengths(rng, cfg.n_requests, cfg.output_lens, cfg.output_mix)
    # the shared prefixes are drawn after the base draws, and only with the
    # mixture on, so a trace without it draws as it did before it existed
    prefixes, tags = [], np.full(cfg.n_requests, -1, np.int64)
    if cfg.shared_prefix_len > 0:
        assert cfg.n_shared_prefixes >= 1
        prefixes = [rng.integers(0, cfg.vocab, cfg.shared_prefix_len).astype(np.int32)
                    for _ in range(cfg.n_shared_prefixes)]
        shared = rng.random(cfg.n_requests) < cfg.shared_fraction
        tags = np.where(shared, rng.integers(0, cfg.n_shared_prefixes, cfg.n_requests), -1)
    trace = []
    for i in range(cfg.n_requests):
        prompt = rng.integers(0, cfg.vocab, int(plens[i])).astype(np.int32)
        if tags[i] >= 0:
            prompt = np.concatenate([prefixes[int(tags[i])], prompt])
        req = Request(uid=i, prompt=prompt, max_new_tokens=int(olens[i]),
                      slo_ttft_s=cfg.slo_ttft_s, deadline_s=cfg.deadline_s,
                      prefix_id=int(tags[i]))
        trace.append(Arrival(at_s=float(at[i]), request=req))
    return trace
