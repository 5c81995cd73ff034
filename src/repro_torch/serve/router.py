"""SLO-aware routing of open-loop traffic over a ``ReplicaSet``.

The router owns the admission queue between ``traffic.poisson_trace``
(arrivals the system does not control) and the replicas:

* **dispatch**: to the least-loaded alive, non-demoted replica, and only
  while it has headroom (``load() < max_batch``). Work the fleet cannot
  start yet waits in the router, where the deadline can still reach it,
  not in an engine queue that admits strictly in order;
* **shedding**: a request whose admission deadline (``deadline_s`` after
  arrival) passes before dispatch is dropped and counted
  (``requests_shed``); a shed request with an SLO counts as a miss;
* **failover**: ``run_trace``'s kills re-route in-flight work through
  ``elastic.rebuild_request``; a rebuilt stream keeps its arrival and its
  committed token times.

``run_trace`` runs on either clock: a ``VirtualClock`` jumps over idle gaps
(replica step costs come from ``ReplicaSet.step_cost``), so two runs of one
seeded trace give the same per-request records; ``MonotonicClock`` sleeps
until the next arrival and latency is real. Replicas step in turn on the
calling thread.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.elastic import ReplicaSet
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.traffic import Arrival


class SLORouter:
    def __init__(self, replicas: ReplicaSet):
        self.replicas = replicas
        self.clock = replicas.clock
        self.pending: deque = deque()       # arrived, not yet dispatched
        self.shed: List[Request] = []       # deadline passed before dispatch
        self._offered = 0

    # ------------------------------------------------------------ admission
    def offer(self, req: Request):
        """One arrival; its ``created_at`` (the arrival) is already stamped."""
        assert req.created_at > 0.0, "open-loop arrivals are pre-stamped"
        self._offered += 1
        self.pending.append(req)

    def _dispatch(self) -> int:
        """Shed the overdue, forward the rest while a replica has headroom."""
        sent = 0
        while self.pending:
            now = self.clock.now()
            req = self.pending[0]
            if req.deadline_s > 0.0 and now - req.created_at > req.deadline_s:
                self.pending.popleft()
                req.done = True
                req.finished_at = now
                self.shed.append(req)
                continue
            i = self._target()
            if i is None:                   # no headroom: wait here, still sheddable
                break
            self.pending.popleft()
            self.replicas.engines[i].submit(req)
            sent += 1
        return sent

    def _target(self) -> Optional[int]:
        """The least-loaded alive non-demoted replica with headroom (all
        alive ones if every survivor is demoted); None if none has room."""
        hs = self.replicas.health
        alive = [i for i, h in enumerate(hs) if h.alive]
        assert alive, "no healthy replicas"
        pool = [i for i in alive if not hs[i].demoted] or alive
        engines = self.replicas.engines
        pool = [i for i in pool if engines[i].load() < engines[i].scfg.max_batch]
        if not pool:
            return None
        return min(pool, key=lambda j: engines[j].load())

    # ------------------------------------------------------------- the loop
    def run_trace(self, trace: Sequence[Arrival], kills: Sequence[Tuple[float, int]] = (),
                  max_steps: int = 100_000) -> List[Request]:
        """Drive a trace to its end; returns one final record per uid
        (``results``). Arrival times and ``kills`` (``(at_s, replica)``
        fail-in-place events) are trace-relative, re-based onto the clock;
        each request's ``created_at`` is its re-based arrival, so queueing
        delay in the router and the engine is charged to TTFT."""
        t0 = self.clock.now()
        arrivals = deque(sorted(trace, key=lambda a: a.at_s))
        for a in arrivals:
            assert a.request.created_at == 0.0, "trace already run"
            a.request.created_at = t0 + a.at_s
        kill_q = deque(sorted((t0 + t, i) for t, i in kills))
        for _ in range(max_steps):
            now = self.clock.now()
            while kill_q and kill_q[0][0] <= now:
                self.replicas.kill_replica(kill_q.popleft()[1])
            while arrivals and t0 + arrivals[0].at_s <= now:
                self.offer(arrivals.popleft().request)
            self._dispatch()
            busy = any(h.alive and e.busy()
                       for e, h in zip(self.replicas.engines, self.replicas.health))
            if busy or self.pending:
                self.replicas.step()
            elif arrivals or kill_q:
                # the fleet is idle: sleep (or jump) to the next event
                nxt = min(([t0 + arrivals[0].at_s] if arrivals else [])
                          + ([kill_q[0][0]] if kill_q else []))
                self.clock.sleep_until(nxt)
            else:
                return self.results()
        raise RuntimeError(f"trace did not drain in {max_steps} steps")

    # -------------------------------------------------------------- results
    def results(self) -> List[Request]:
        """The final record per uid, shed requests included. A failover
        leaves two objects per re-routed stream (the aborted original and
        the clone, which retires with more tokens): the one with the most
        tokens (ties: the later ``finished_at``) is what the client saw."""
        best: Dict[int, Request] = {}
        everything = [r for e in self.replicas.engines for r in e._retired] + self.shed
        for r in everything:
            cur = best.get(r.uid)
            if cur is None or ((len(r.tokens_out), r.finished_at)
                               > (len(cur.tokens_out), cur.finished_at)):
                best[r.uid] = r
        return sorted(best.values(), key=lambda r: r.uid)

    def metrics(self) -> dict:
        """Fleet telemetry over the final records: latency percentiles,
        finished / shed / rejected (engine admission: an unservable prompt),
        and SLO attainment (a first token within ``slo_ttft_s``; a shed or
        rejected request with an SLO is a miss)."""
        recs = self.results()
        shed_uids = {r.uid for r in self.shed}
        em = [e.metrics() for e in self.replicas.engines]
        slo = [r for r in recs if r.slo_ttft_s > 0.0]
        attained = [r for r in slo if r.first_token_at > 0.0
                    and r.first_token_at - r.created_at <= r.slo_ttft_s]
        phits = sum(m["prefix_hits"] for m in em)
        plook = sum(m["prefix_lookups"] for m in em)
        return {
            "prefix_hits": phits,
            "prefix_lookups": plook,
            "prefix_hit_rate": (phits / plook) if plook else 0.0,
            "pages_in_use": sum(m["pages_in_use"] for m in em),
            "evictions": sum(m["evictions"] for m in em),
            **ServeEngine.latency_percentiles(recs),
            "requests_offered": self._offered,
            "requests_finished": sum(1 for r in recs
                                     if r.uid not in shed_uids and r.first_token_at > 0.0),
            "requests_shed": len(self.shed),
            "requests_rejected": sum(m["requests_rejected"] for m in em),
            "slo_attainment": (len(attained) / len(slo)) if slo else 1.0,
            "replicas_alive": sum(h.alive for h in self.replicas.health),
            "replicas_demoted": sum(h.demoted for h in self.replicas.health if h.alive),
        }
