"""The port's open-loop traffic generator and clocks against the JAX package.

``poisson_trace`` must give the reference's trace exactly for the same
config (arrival times bit for bit, prompts, lengths, SLO fields and
``prefix_id``), for several seeds and length mixtures, with and without
the shared-prefix pool; the clocks keep the reference's protocol.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.serve import traffic as jtraffic
from repro_torch.serve import traffic as ttraffic


def _sig(trace):
    return [(a.at_s, a.request.uid, a.request.prompt.tolist(), a.request.prompt.dtype.name,
             a.request.max_new_tokens, a.request.slo_ttft_s, a.request.deadline_s,
             a.request.prefix_id, a.request.created_at) for a in trace]


MIXTURES = [
    dict(),
    dict(rate_rps=12.0, n_requests=20, prompt_lens=((2, 8), (16, 24)), prompt_mix=(3.0, 1.0),
         output_lens=((1, 4),), slo_ttft_s=0.3, deadline_s=1.0),
    dict(rate_rps=4.0, n_requests=24, prompt_lens=((64, 128),), output_lens=((16, 32),),
         vocab=92416, slo_ttft_s=1.0),
    dict(n_requests=40, vocab=512, shared_prefix_len=12, n_shared_prefixes=3,
         shared_fraction=0.6, output_lens=((2, 5), (9, 12)), output_mix=(0.5, 0.5)),
]


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("mix", range(len(MIXTURES)))
def test_poisson_trace_equals_the_reference(seed, mix):
    kw = dict(MIXTURES[mix], seed=seed)
    want = jtraffic.poisson_trace(jtraffic.TrafficConfig(**kw))
    got = ttraffic.poisson_trace(ttraffic.TrafficConfig(**kw))
    assert _sig(got) == _sig(want)
    from repro_torch.serve.engine import Request
    assert all(type(a.request) is Request for a in got)


def test_trace_is_open_loop_shaped():
    """Arrivals sorted and unstamped (the router re-bases them onto its
    clock), the SLO fields on every request."""
    trace = ttraffic.poisson_trace(ttraffic.TrafficConfig(rate_rps=5.0, n_requests=12,
                                                          slo_ttft_s=0.25, deadline_s=2.0,
                                                          seed=3))
    ats = [a.at_s for a in trace]
    assert len(trace) == 12 and ats == sorted(ats) and ats[0] > 0.0
    assert all(a.request.created_at == 0.0 and a.request.slo_ttft_s == 0.25
               and a.request.deadline_s == 2.0 for a in trace)


def test_bad_mixtures_are_refused_as_in_the_reference():
    for bad in (dict(prompt_lens=((8, 4),)), dict(prompt_lens=((4, 8), (2, 3)),
                                                 prompt_mix=(1.0,)), dict(prompt_mix=(0.0,))):
        with pytest.raises(AssertionError):
            ttraffic.poisson_trace(ttraffic.TrafficConfig(**bad))


def test_clocks_keep_the_protocol():
    assert isinstance(ttraffic.MonotonicClock(), ttraffic.Clock)
    assert isinstance(ttraffic.VirtualClock(), ttraffic.Clock)
    clk = ttraffic.VirtualClock(start=5.0)
    assert clk.now() == 5.0
    assert clk.advance(1.5) == 6.5
    assert clk.advance_to(6.0) == 6.5          # in the past: no-op
    assert clk.advance_to(10.0) == 10.0
    assert clk.sleep_until(12.0) == 12.0 == clk.now()
    with pytest.raises(AssertionError):
        clk.advance(-0.1)
    wall = ttraffic.MonotonicClock()
    a = wall.now()
    assert wall.sleep_until(a + 0.01) >= a + 0.01 and wall.now() >= a


def test_the_engine_reads_its_injected_clock():
    """Arrival, admission, token and step times all come from the clock the
    engine is given: under a VirtualClock nothing moves until it does."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    _, model = registry.load("codeqwen1.5-7b", smoke=True)
    ccfg = CascadeConfig(mode="train", compute_dtype=torch.float32)
    clk = ttraffic.VirtualClock(start=3.0)
    eng = ServeEngine(model, model.init_params(0, ccfg, device="cpu"), ccfg,
                      ServeConfig(max_batch=2, max_len=32), device="cpu", clock=clk)
    req = Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.submit(req)
    eng.step()
    clk.advance(0.5)
    eng.run_until_drained()
    assert req.created_at == req.admitted_at == req.first_token_at == 3.0
    assert req.token_times == [3.0, 3.0, 3.5] and req.finished_at == 3.5
    assert eng.step_times == [0.0, 0.0]
