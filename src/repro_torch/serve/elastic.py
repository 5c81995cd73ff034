"""Elastic serving: replica failure, fail-in-place, straggler demotion.

The paper's fail-in-place story (Section 20): a defective part is mapped
out and the rack keeps serving. Here the unit is a replica, a
``ServeEngine``; ``ReplicaSet`` runs N of them:

* **dispatch**: ``submit`` sends a request to the least-loaded alive,
  non-demoted replica;
* **fail-in-place**: ``kill_replica`` marks a replica dead and moves its
  work to survivors. A resident stream is rebuilt from its prompt and the
  tokens it has emitted (``rebuild_request``): every cache family's state
  (full-attention K/V, ring buffers, recurrent state) is a function of the
  token prefix, so the survivor's chunked prefill rebuilds it and nothing
  replica-local is saved. ``tokens_out`` holds only committed tokens (a
  speculative step rolls rejected drafts back before it returns), so no
  unverified draft is carried. Greedy streams continue token for token; a
  sampled stream continues from the survivor's own generator, with other
  draws from the same distribution;
* **straggler demotion**: a replica whose step-time EWMA exceeds
  ``straggler_factor`` times the median of the OTHER alive, non-demoted
  replicas is demoted (its queue moves to the others, ``submit`` skips it,
  its resident work keeps stepping) until its EWMA is back under the bar.
  Median of the others: with two replicas the fleet median is the midpoint,
  and ``ewma > factor * median`` could never hold for factor >= 1.

Timing reads an injected clock (``serve/traffic.py``; by default the first
engine's). Under a ``VirtualClock`` a ``step_cost(i) -> seconds`` hook
gives replica i's step cost, paid before the engine steps, so committed
tokens carry the step's end time and the EWMA equals the cost exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.engine import Request, ServeEngine


def rebuild_request(req: Request) -> Request:
    """The failover clone of an in-flight request: its prompt is the prompt
    and every token emitted since the last rebuild, so a survivor's prefill
    rebuilds the stream's state and generates its next token; no emitted
    token is computed again (nor, sampled, drawn again). ``tokens_out``
    carries over, so the stream still retires at its ``max_new_tokens``;
    ``prompt_carried`` counts the tokens inside the prompt, so a second
    failure does not add them twice. The arrival, first-token time and
    token times carry over too: the stream's latency record is what the
    client saw across replicas. ``prefix_id`` does not carry (the prompt is
    no longer the tagged one), as in the reference. A request with no new
    token (mid-prefill) comes back unchanged."""
    new = req.tokens_out[req.prompt_carried:]
    if not new:
        return req
    clone = Request(uid=req.uid, prompt=np.concatenate([req.prompt, np.asarray(new, np.int32)]),
                    max_new_tokens=req.max_new_tokens, slo_ttft_s=req.slo_ttft_s,
                    deadline_s=req.deadline_s)
    clone.tokens_out = list(req.tokens_out)
    clone.prompt_carried = len(clone.tokens_out)
    clone.created_at = req.created_at
    clone.first_token_at = req.first_token_at
    clone.token_times = list(req.token_times)
    return clone


@dataclasses.dataclass
class ReplicaHealth:
    alive: bool = True
    demoted: bool = False        # straggling: keeps stepping, takes no new work
    ewma_ms: float = 0.0
    steps: int = 0


class ReplicaSet:
    def __init__(self, engines: List[ServeEngine], straggler_factor: float = 3.0,
                 clock=None, step_cost: Optional[Callable[[int], float]] = None):
        self.engines = engines
        self.health = [ReplicaHealth() for _ in engines]
        self.straggler_factor = straggler_factor
        self.clock = clock if clock is not None else engines[0].clock
        #: seconds one step of replica i costs on a virtual clock, paid before
        #: the step so its tokens carry the step's end time
        self.step_cost = step_cost
        self.requeued: list = []     # the clones failovers made

    # ------------------------------------------------------------ dispatch
    def submit(self, req: Request) -> int:
        """To the least-loaded alive, non-demoted replica (or, if every
        survivor is demoted, the least-loaded alive one)."""
        alive = [i for i, h in enumerate(self.health) if h.alive]
        assert alive, "no healthy replicas"
        pool = [i for i in alive if not self.health[i].demoted] or alive
        i = min(pool, key=lambda j: self.engines[j].load())
        self.engines[i].submit(req)
        return i

    def step(self) -> int:
        """One step of every alive replica, in turn; then demotion."""
        produced = 0
        for i, (eng, h) in enumerate(zip(self.engines, self.health)):
            if not h.alive:
                continue
            if self.step_cost is not None:
                # an idle replica takes no step and pays nothing (its EWMA
                # freezes; a demoted one recovers by stepping resident work)
                if not eng.busy():
                    continue
                dt_ms = float(self.step_cost(i)) * 1e3
                advance = getattr(self.clock, "advance", None)
                if advance is not None:
                    advance(dt_ms * 1e-3)
                produced += eng.step()
            else:
                t0 = self.clock.now()
                produced += eng.step()
                dt_ms = (self.clock.now() - t0) * 1e3
            h.ewma_ms = dt_ms if h.steps == 0 else 0.9 * h.ewma_ms + 0.1 * dt_ms
            h.steps += 1
        self._mitigate_stragglers()
        return produced

    # ------------------------------------------------------------- failure
    def kill_replica(self, i: int):
        """A hard loss of replica i: its resident and mid-prefill streams
        are rebuilt on survivors, its queue moves to them unchanged."""
        self.health[i].alive = False
        eng = self.engines[i]
        for req in eng.abort_in_flight():
            clone = rebuild_request(req)
            if clone is not req:
                self.requeued.append(clone)
            self.submit(clone)
        for req in list(eng.queue):
            self.submit(req)
        eng.queue.clear()

    def _mitigate_stragglers(self):
        """Demote a replica whose EWMA passes ``straggler_factor`` times the
        median of the other alive, non-demoted replicas past 4 steps (its
        queue moves to them); recover it once it is back under the bar.
        With no other to compare against, a replica is never demoted."""
        for i, h in enumerate(self.health):
            if not (h.alive and h.steps > 4):
                continue
            others = [o.ewma_ms for j, o in enumerate(self.health)
                      if j != i and o.alive and not o.demoted and o.steps > 4]
            if not others:
                h.demoted = False
                continue
            bar = self.straggler_factor * max(float(np.median(others)), 1e-6)
            if not h.demoted and h.ewma_ms > bar:
                h.demoted = True
                for req in list(self.engines[i].queue):
                    self.submit(req)
                self.engines[i].queue.clear()
            elif h.demoted and h.ewma_ms <= bar:
                h.demoted = False

    def drain(self, max_steps: int = 100_000):
        for _ in range(max_steps):
            if all((not h.alive) or not e.busy() for e, h in zip(self.engines, self.health)):
                break
            self.step()
