"""The port's fleet layer (``serve/elastic.py``, ``serve/router.py``).

Under the injected VirtualClock (with ``ReplicaSet.step_cost``) every
timestamp is a sum of configured step costs, so runs are exact:

* the reference's own scenarios (``tests/test_router.py`` and
  ``tests/test_elastic.py``) run on the port's fleet;
* the mid-trace kill, deadline shedding, straggler demotion and the
  multi-kill bookkeeping also run on the JAX fleet with the same trace and
  weights (the reference's params carried across, f32 on both sides): the
  streams, the shed sets and every virtual timestamp must be equal;
* a CLI run of ``--traffic --smoke --device cpu --kill-at``.

The reference's scenarios draw prompt ids up to 512 against the smoke
model's 256-token vocabulary; its ``jnp.take`` gives those ids NaN
embeddings, where the port's indexing raises. The traces here draw from the
model's vocabulary (``VOCAB``), on both sides.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import registry as jregistry
from repro.serve import elastic as jelastic
from repro.serve import engine as jengine
from repro.serve import router as jrouter
from repro.serve import traffic as jtraffic
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import registry
from repro_torch.serve import elastic as telastic
from repro_torch.serve import engine as tengine
from repro_torch.serve import router as trouter
from repro_torch.serve import traffic as ttraffic

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
J_CCFG = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
T_CCFG = CascadeConfig(mode="train", compute_dtype=torch.float32)
#: the two sides' modules: engine, elastic, router, traffic
SIDES = {"jax": (jengine, jelastic, jrouter, jtraffic),
         "torch": (tengine, telastic, trouter, ttraffic)}


@pytest.fixture(scope="module")
def tiny():
    """codeqwen's smoke config on both sides, one set of weights."""
    cfg, jm = jregistry.load("codeqwen1.5-7b", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0), J_CCFG)
    _, tm = registry.load("codeqwen1.5-7b", smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, {"jax": (jm, jp, J_CCFG), "torch": (tm, tp, T_CCFG)}


def _engine(tiny, side, clock=None, max_batch=2):
    eng_mod = SIDES[side][0]
    model, params, ccfg = tiny[1][side]
    scfg = eng_mod.ServeConfig(max_batch=max_batch, max_len=64, batched=True, prefill_chunk=8)
    kw = {"device": "cpu"} if side == "torch" else {}
    return eng_mod.ServeEngine(model, params, ccfg, scfg, clock=clock, **kw)


def _fleet(tiny, side="torch", n=2, max_batch=2, step_cost=None):
    clk = SIDES[side][3].VirtualClock()
    return SIDES[side][1].ReplicaSet([_engine(tiny, side, clk, max_batch) for _ in range(n)],
                                     clock=clk, step_cost=step_cost)


def _run(tiny, tcfg, side="torch", kills=(), replicas=2, max_batch=2, step_cost=0.01,
         slow_replica=None):
    _, elastic, router, traffic = SIDES[side]
    rs = _fleet(tiny, side, replicas, max_batch,
                lambda i: step_cost * (100.0 if i == slow_replica else 1.0))
    rt = router.SLORouter(rs)
    recs = rt.run_trace(traffic.poisson_trace(traffic.TrafficConfig(**tcfg)), kills=kills)
    return recs, rt


def _reqs(tiny, n, side="torch", max_new=4, seed=0, start_uid=0):
    rng = np.random.default_rng(seed)
    return [SIDES[side][0].Request(uid=start_uid + i,
                                   prompt=rng.integers(0, tiny[0].vocab, 8).astype(np.int32),
                                   max_new_tokens=max_new) for i in range(n)]


def _records(recs):
    return [(r.uid, r.created_at, r.admitted_at, r.first_token_at, r.finished_at,
             tuple(r.token_times), tuple(r.tokens_out), r.prompt_carried, r.done)
            for r in recs]


#: codeqwen's smoke vocabulary
VOCAB = 256
TCFG = dict(rate_rps=25.0, n_requests=16, vocab=VOCAB, prompt_lens=((4, 10),),
            output_lens=((8, 14),), slo_ttft_s=0.5, seed=11)
SHED_TCFG = dict(rate_rps=200.0, n_requests=24, vocab=VOCAB, prompt_lens=((4, 10),),
                 output_lens=((6, 10),), slo_ttft_s=0.05, deadline_s=0.10, seed=2)
SLOW_TCFG = dict(rate_rps=25.0, n_requests=24, vocab=VOCAB, prompt_lens=((4, 10),),
                 output_lens=((8, 12),), slo_ttft_s=0.5, seed=5)


# ---------------------------------------------------------------------------
# router scenarios (tests/test_router.py), on the port
# ---------------------------------------------------------------------------

def test_same_seed_identical_latency_records(tiny):
    a, _ = _run(tiny, TCFG)
    b, _ = _run(tiny, TCFG)
    assert _records(a) == _records(b)


def test_mid_trace_kill_zero_lost_tokens_and_equal_to_jax(tiny):
    """Kill replica 0 at 0.15 s: every stream drains with the unkilled
    run's tokens, and the whole record (streams, every virtual timestamp,
    ``prompt_carried``) equals the JAX fleet's on the same trace."""
    ref, _ = _run(tiny, TCFG)
    out, rt = _run(tiny, TCFG, kills=[(0.15, 0)])
    jout, jrt = _run(tiny, TCFG, side="jax", kills=[(0.15, 0)])
    assert sum(h.alive for h in rt.replicas.health) == 1
    assert rt.replicas.requeued, "a kill mid-decode must re-route work"
    assert {r.uid: r.tokens_out for r in out} == {r.uid: r.tokens_out for r in ref}
    assert rt.metrics()["requests_finished"] == TCFG["n_requests"]
    assert all(r.first_token_at > r.created_at > 0.0 for r in out)
    assert _records(out) == _records(jout)
    assert _records(rt.replicas.requeued) == _records(jrt.replicas.requeued)
    tm, jm = rt.metrics(), jrt.metrics()
    assert tm == jm


def test_failover_latency_record_spans_replicas(tiny):
    out, rt = _run(tiny, TCFG, kills=[(0.15, 0)])
    carried = {c.uid for c in rt.replicas.requeued}
    assert carried
    for r in out:
        if r.uid in carried:
            assert len(r.token_times) == len(r.tokens_out)
            assert all(b >= a for a, b in zip(r.token_times, r.token_times[1:]))


def test_deadline_shedding_honest_accounting_and_equal_to_jax(tiny):
    """One replica, crushing load, a tight deadline: requests shed from the
    router's queue, counted honestly, the same set (at the same instants)
    as the JAX fleet sheds."""
    recs, rt = _run(tiny, SHED_TCFG, replicas=1, step_cost=0.02)
    jrecs, jrt = _run(tiny, SHED_TCFG, side="jax", replicas=1, step_cost=0.02)
    m = rt.metrics()
    assert m["requests_shed"] > 0
    assert m["requests_offered"] == (m["requests_finished"] + m["requests_shed"]
                                     + m["requests_rejected"])
    assert m["slo_attainment"] <= 1.0 - m["requests_shed"] / SHED_TCFG["n_requests"]
    shed = [r for r in recs if not r.tokens_out]
    assert len(shed) == m["requests_shed"]
    assert all(r.done and r.first_token_at == 0.0 for r in shed)
    assert [(r.uid, r.finished_at) for r in rt.shed] == [(r.uid, r.finished_at) for r in jrt.shed]
    assert _records(recs) == _records(jrecs)
    assert m == jrt.metrics()


def test_no_shedding_without_deadline(tiny):
    recs, rt = _run(tiny, dict(SHED_TCFG, deadline_s=0.0), replicas=1, step_cost=0.02)
    m = rt.metrics()
    assert m["requests_shed"] == 0 and m["requests_finished"] == SHED_TCFG["n_requests"]
    assert m["ttft_p99_s"] > m["ttft_p50_s"] > 0.0
    assert m["slo_attainment"] < 1.0


def test_headroom_gate_bounds_engine_queues(tiny):
    rs = _fleet(tiny, step_cost=lambda i: 0.02)
    rt = trouter.SLORouter(rs)
    t0 = rs.clock.now()
    for r in _reqs(tiny, 12):
        r.created_at = t0 + 1e-9          # a burst: all arrive at once
        rt.offer(r)
    for _ in range(400):
        rt._dispatch()
        assert all(e.load() <= e.scfg.max_batch for e in rs.engines)
        if not rt.pending and not any(e.busy() for e in rs.engines):
            break
        rs.step()
    assert sum(len(e._retired) for e in rs.engines) == 12


def test_slow_replica_demoted_under_traffic_as_in_jax(tiny):
    """A 100x straggler demotes mid-trace and takes no new arrivals; the
    records and the health (demotion, EWMA, steps) equal the JAX fleet's."""
    recs, rt = _run(tiny, SLOW_TCFG, slow_replica=0)
    jrecs, jrt = _run(tiny, SLOW_TCFG, side="jax", slow_replica=0)
    assert rt.replicas.health[0].demoted
    assert rt.metrics()["requests_finished"] == SLOW_TCFG["n_requests"]
    served = [len(e._retired) for e in rt.replicas.engines]
    assert served[1] > served[0]
    assert _records(recs) == _records(jrecs)
    assert [vars(h) for h in rt.replicas.health] == [vars(h) for h in jrt.replicas.health]


# ---------------------------------------------------------------------------
# ReplicaSet scenarios (tests/test_elastic.py), on the port
# ---------------------------------------------------------------------------

def test_submit_least_loaded_invariant(tiny):
    rs = _fleet(tiny, n=3, step_cost=lambda i: 0.01)
    for r in _reqs(tiny, 9):
        loads = [e.load() for e in rs.engines]
        i = rs.submit(r)
        assert loads[i] == min(loads), (i, loads)
        if r.uid % 3 == 2:
            rs.step()
    rs.drain(max_steps=500)
    served = [len(e._retired) for e in rs.engines]
    assert sum(served) == 9 and max(served) < 9, served


def test_replica_ewma_equals_virtual_step_cost(tiny):
    rs = _fleet(tiny, step_cost=lambda i: 0.02 * (i + 1))
    for r in _reqs(tiny, 4):
        rs.submit(r)
    rs.drain(max_steps=200)
    for i, h in enumerate(rs.health):
        assert h.steps > 0
        assert h.ewma_ms == pytest.approx(20.0 * (i + 1))


def test_straggler_p99_reads_step_times(tiny):
    eng = _engine(tiny, "torch")
    for r in _reqs(tiny, 2):
        eng.submit(r)
    eng.run_until_drained(200)
    assert eng.step_times and eng.straggler_p99() > 0.0
    assert eng.straggler_p99() == pytest.approx(
        float(np.percentile(np.asarray(eng.step_times), 99)))


def test_slow_replica_demoted_and_stops_receiving(tiny):
    rs = _fleet(tiny, max_batch=4, step_cost=lambda i: 1.0 if i == 0 else 0.01)
    for r in _reqs(tiny, 2, max_new=64):
        rs.submit(r)
    for _ in range(8):
        rs.step()
    assert rs.health[0].demoted and not rs.health[1].demoted
    assert {rs.submit(r) for r in _reqs(tiny, 4, start_uid=100)} == {1}


def test_demotion_reroutes_queued_work(tiny):
    rs = _fleet(tiny, max_batch=1, step_cost=lambda i: 1.0 if i == 0 else 0.01)
    for r in _reqs(tiny, 2, max_new=64):
        rs.submit(r)
    extra = _reqs(tiny, 1, start_uid=50)[0]
    rs.engines[0].submit(extra)
    assert extra in rs.engines[0].queue
    for _ in range(8):
        rs.step()
    assert rs.health[0].demoted
    assert extra not in rs.engines[0].queue and extra in rs.engines[1].queue


def test_demoted_replica_recovers(tiny):
    cost = {"slow": True}
    rs = _fleet(tiny, max_batch=4,
                step_cost=lambda i: (1.0 if cost["slow"] else 0.01) if i == 0 else 0.01)
    for r in _reqs(tiny, 2, max_new=200):
        rs.submit(r)
    for _ in range(8):
        rs.step()
    assert rs.health[0].demoted
    cost["slow"] = False
    for _ in range(80):
        rs.step()
        if not rs.health[0].demoted:
            break
    assert not rs.health[0].demoted
    rs.drain(max_steps=1000)


def test_never_demote_last_dispatch_target(tiny):
    rs = _fleet(tiny, step_cost=lambda i: 1.0)
    for r in _reqs(tiny, 2, max_new=16):
        rs.submit(r)
    rs.kill_replica(1)
    for _ in range(8):
        rs.step()
    assert rs.health[0].alive and not rs.health[0].demoted
    rs.drain(max_steps=500)
    assert sum(len(e._retired) for e in rs.engines) == 2


def test_drain_terminates_with_dead_replicas(tiny):
    rs = _fleet(tiny, n=3, step_cost=lambda i: 0.01)
    for r in _reqs(tiny, 6):
        rs.submit(r)
    rs.step()
    rs.kill_replica(0)
    rs.kill_replica(2)
    rs.drain(max_steps=500)
    assert all(not e.busy() or not h.alive for e, h in zip(rs.engines, rs.health))
    assert {r.uid for r in rs.engines[1]._retired} == set(range(6))


def _multi_kill(tiny, side):
    """Six 32-token streams over three replicas; kill replica 0 after 3
    steps and replica 1 two steps later, then drain."""
    rs = _fleet(tiny, side, n=3, max_batch=4, step_cost=lambda i: 0.01)
    reqs = _reqs(tiny, 6, side, max_new=32)
    for r in reqs:
        rs.submit(r)
    for _ in range(3):
        rs.step()
    rs.kill_replica(0)
    for _ in range(2):
        rs.step()
    rs.kill_replica(1)
    rs.drain(max_steps=2000)
    return rs, reqs


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_requeued_bookkeeping_after_multi_kill(tiny, side):
    """Streams killed once or twice are rebuilt as telemetry-carrying clones
    that never bake a token twice; every stream finishes its 32 tokens
    exactly once, on both fleets."""
    rs, reqs = _multi_kill(tiny, side)
    assert rs.requeued
    for clone in rs.requeued:
        assert clone.prompt_carried == len(clone.prompt) - 8
        assert clone.created_at > 0.0 and len(clone.token_times) >= clone.prompt_carried
    final = {}
    for e in rs.engines:
        for r in e._retired:
            if r.uid not in final or len(r.tokens_out) > len(final[r.uid].tokens_out):
                final[r.uid] = r
    assert set(final) == {r.uid for r in reqs}
    assert all(len(r.tokens_out) == 32 and r.done for r in final.values())


def test_multi_kill_records_equal_the_jax_fleet(tiny):
    """The multi-kill scenario on both fleets: every final record and every
    failover clone equal, virtual timestamps included."""
    out = {}
    for side in ("jax", "torch"):
        rs, _ = _multi_kill(tiny, side)
        retired = sorted((r for e in rs.engines for r in e._retired),
                         key=lambda r: (r.uid, len(r.tokens_out)))
        out[side] = (_records(retired), _records(rs.requeued))
    assert out["torch"] == out["jax"]


def test_rebuild_request_carries_latency_telemetry(tiny):
    rs = _fleet(tiny, step_cost=lambda i: 0.01)
    req = _reqs(tiny, 1, max_new=16)[0]
    req.created_at = 1.5
    req.prefix_id = 3
    rs.submit(req)
    for _ in range(4):
        rs.step()
    assert req.token_times and req.first_token_at > 0.0
    clone = telastic.rebuild_request(req)
    assert clone is not req and clone.prefix_id == -1     # not carried, as in the reference
    assert (clone.created_at, clone.first_token_at, clone.token_times) \
        == (1.5, req.first_token_at, req.token_times)
    assert clone.prompt.tolist() == req.prompt.tolist() + req.tokens_out
    rs.engines[1].submit(clone)
    assert clone.created_at == 1.5


def test_abort_in_flight_releases_pages_and_the_staged_request(tiny):
    """A paged replica's abort returns its resident and mid-prefill
    requests and gives every page back to the pool."""
    model, params, ccfg = tiny[1]["torch"]
    eng = tengine.ServeEngine(model, params, ccfg, tengine.ServeConfig(
        max_batch=3, max_len=64, prefill_chunk=8, token_budget=8, paged=True, page_size=4),
        device="cpu")
    reqs = [tengine.Request(uid=i, prompt=(np.arange(n, dtype=np.int32) * 7 + i) % VOCAB,
                            max_new_tokens=8) for i, n in enumerate((8, 8, 20))]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                 # r0, then r1 admitted; r2 one chunk into its prompt
        eng.step()
    assert len(eng._active()) == 2 and eng._staging is not None
    assert eng.load() == 3 and eng.pool.pages_in_use > 0
    out = eng.abort_in_flight()
    assert sorted(r.uid for r in out) == [0, 1, 2]
    assert eng.pool.pages_in_use == 0 and eng._staging is None and not eng._active()
    assert eng.load() == 0 and not eng.busy()


def test_serve_cli_routes_traffic_and_kills_a_replica():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--traffic", "--requests", "8", "--rate", "50", "--kill-at", "0.05"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert "traffic: 8 arrivals at 50 req/s over 2 replicas (1 alive after 1 kill(s)" \
        in res.stdout
    assert "SLO attainment" in res.stdout and "shed 0, rejected 0" in res.stdout
