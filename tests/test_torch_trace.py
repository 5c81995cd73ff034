"""The serving path's profiler spans (``repro_torch.trace``) on the smoke
dense and MoE engines, on the CPU: the spans nest as the engine's work does,
none is built while no profiler runs, and a profiled run serves the same
streams as an unprofiled one."""
import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

ARCHS = ["codeqwen1.5-7b", "olmoe-1b-7b"]
FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
#: each engine span and the span it sits in
ENGINE_TREE = {
    "engine.admit": None, "engine.admit.chunk": "engine.admit",
    "engine.admit.pick": "engine.admit", "engine.admit.write": "engine.admit",
    "engine.decode": None, "engine.decode.prepare": "engine.decode",
    "engine.decode.forward": "engine.decode", "engine.decode.sync": "engine.decode",
    "engine.decode.commit": "engine.decode",
}
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.combine")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg, m = registry.load(request.param, smoke=True)
    return cfg, m, m.init_params(0, FP4, device="cpu")


def _serve(model, profiled: bool):
    """Three requests over two slots, chunked admission spread over steps
    (prompts longer than the budget), run to the end; their streams, and
    the profile's events when ``profiled``."""
    cfg, m, params = model
    eng = ServeEngine(m, params, FP4, ServeConfig(max_batch=2, max_len=64, prefill_chunk=8,
                                                  token_budget=8, fused=True), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate((13, 5, 20))]
    for r in reqs:
        eng.submit(r)
    if not profiled:
        eng.run_until_drained()
        return [r.tokens_out for r in reqs], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_until_drained()
    return [r.tokens_out for r in reqs], prof.events()


@pytest.fixture(scope="module")
def served(model):
    """The streams of an unprofiled run, and those and the events of a
    profiled one."""
    plain, _ = _serve(model, profiled=False)
    traced, events = _serve(model, profiled=True)
    return plain, traced, events


def _span_parent(e):
    """The nearest enclosing program span of a profile event, None at the top."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(trace.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(trace.PREFIX):]


def test_spans_nest_as_the_engine_works(model, served):
    cfg = model[0]
    events = served[2]
    spans = [e for e in events if e.name.startswith(trace.PREFIX)]
    parents: dict = {}
    for e in spans:
        parents.setdefault(e.name[len(trace.PREFIX):], set()).add(_span_parent(e))
    moe = set(MOE_SPANS) if cfg.family == "moe" else set()
    assert set(parents) == set(ENGINE_TREE) | moe
    for name, parent in ENGINE_TREE.items():
        assert parents[name] == {parent}, (name, parents[name])
    for name in moe:
        # every routed layer runs in both the decode step and each chunk
        assert parents[name] == {"engine.decode.forward", "engine.admit.chunk"}, name
    # a span is a host range, not a user annotation: the device timeline
    # gets no copy of it
    assert not any(e.is_user_annotation for e in spans)
    # one admission span and at most one decode span an engine step
    n = {k: sum(1 for e in spans if e.name == trace.PREFIX + k) for k in ENGINE_TREE}
    assert n["engine.decode"] <= n["engine.admit"]
    for k in ("prepare", "forward", "sync", "commit"):
        assert n[f"engine.decode.{k}"] == n["engine.decode"]
    assert n["engine.admit.pick"] == n["engine.admit.write"] == 3
    assert n["engine.admit.chunk"] == 2 + 1 + 3


def test_no_range_is_built_without_a_profiler(model, monkeypatch):
    built = []
    make = torch._C._profiler._RecordFunctionFast

    def counting(name, *args):
        built.append(name)
        return make(name, *args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    _serve(model, profiled=False)
    assert built == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert built == [trace.PREFIX + "probe"]


def test_a_profiled_run_serves_the_same_streams(served):
    plain, traced, _ = served
    assert traced == plain
    assert all(len(s) == 6 for s in plain)


def test_the_private_profiler_names_the_span_reads_are_there():
    """``span`` reads ``torch.autograd.profiler._is_profiler_enabled`` and
    builds ``torch._C._profiler._RecordFunctionFast``: a torch that renames
    either fails here, not silently in a profile with no spans."""
    assert autograd_profiler._is_profiler_enabled is False
    assert trace.span("x") is trace.span("y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled is True
        with trace.span("probe"):
            torch.ones(2).add_(1)
    assert autograd_profiler._is_profiler_enabled is False
    (probe,) = [e for e in prof.events() if e.name == trace.PREFIX + "probe"]
    assert not probe.is_user_annotation
    assert any(_span_parent(e) == "probe" for e in prof.events() if e.name == "aten::add_")
