"""The check that decides ``correct``, at smoke size on the CPU: a sound run
passes, the control (the reference in float8) fails, and a run with the
timed path broken underneath comes out not correct, once for each fault a
one-chip serving cell can have: a decode step that leaves its state (the
cache) unchanged, half of the slots' tokens not computed (the other half's
taken), a produced token altered. These cells run on one chip, so there is
no exchange between chips to leave out. Each cell runs under its own mix and,
for the open loop, the paged engine and the prefix cache, under ``OPEN``."""
import time

import pytest
import torch

from servebench import harness
from servebench.tests.cells import OPEN, TickClock, smoke_cell

CELLS = [("codeqwen-decode-c128", None), ("olmoe-decode-c128", None),
         ("codeqwen-decode-c128", "open")]
IDS = ["codeqwen-decode-c128", "olmoe-decode-c128", "codeqwen-open"]
SEED = 2**31 + 101


def _tree_clone(t):
    return {k: _tree_clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()


def state_unchanged(eng):
    orig = eng._decode_fn

    def step(params, toks, cache, bt=None):
        nxt, _ = orig(params, toks, _tree_clone(cache), bt)
        return nxt, cache
    eng._decode_fn = step


def half_batch(eng):
    orig = eng._decode_fn

    def step(params, toks, cache, bt=None):
        nxt, cache = orig(params, toks, cache, bt)
        b = nxt.shape[0]
        nxt = nxt.clone()
        nxt[b // 2:] = nxt[:b - b // 2]
        return nxt, cache
    eng._decode_fn = step


def token_altered(eng):
    orig = eng._decode_fn
    calls = [0]

    def step(params, toks, cache, bt=None):
        nxt, cache = orig(params, toks, cache, bt)
        calls[0] += 1
        if calls[0] % 3 == 0:
            nxt = nxt.clone()
            nxt[0] = (nxt[0] + 1) % int(eng.model.cfg.vocab)
        return nxt, cache
    eng._decode_fn = step


def decode_past_the_recorder(eng):
    """The batched decode no longer goes through ``_decode_fn`` (as a step
    replayed whole from a captured graph would not)."""
    fn = eng._decode_fn

    def batched(active):
        wrapped, eng._decode_fn = eng._decode_fn, fn
        try:
            return type(eng)._decode_batched(eng, active)
        finally:
            eng._decode_fn = wrapped
    eng._decode_batched = batched


def _run(cell, hook=None, control=False, trace=False, deep=False):
    name, mix = cell
    c = smoke_cell(name, deep, OPEN if mix == "open" else None)
    return harness.run_cell(c, SEED, 2.0, trace, "cpu", time.monotonic(),
                            hook=hook, control=control, clock=TickClock())


@pytest.mark.parametrize("name", CELLS, ids=IDS)
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    run = _run(name, control=True, deep=True)
    checks = run.result["checks"]
    assert run.result["correct"], checks
    assert run.check["tokens"] >= 200
    # the control in the program's place: it fails one of the cell's numbers
    assert any(run.check["control_" + k] > c["limit"] for k, c in checks.items()), run.check


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, token_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS, ids=IDS)
def test_a_broken_step_is_not_correct(name, fault):
    run = _run(name, hook=fault)
    assert not run.result["correct"], run.result["checks"]


@pytest.mark.parametrize("name", CELLS, ids=IDS)
def test_work_past_the_recorded_calls_stops_the_run(name):
    with pytest.raises(RuntimeError, match="bypassed the recorded calls"):
        _run(name, hook=decode_past_the_recorder)


@pytest.mark.parametrize("name", CELLS, ids=IDS)
def test_a_traced_run_reads_its_per_layer_metrics_from_the_slice(name):
    run = _run(name, trace=True)
    res = run.result
    assert res["correct"] and set(res["device"]) == {"busy_s", "window_s"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    # on the CPU no device operation is traced: the host-side metrics remain
    assert "decode_step_ms_p50" in res["metrics"]
    assert list(res)[-1] == "checks"


@pytest.mark.gpu
def test_a_sound_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = harness.run_cell(smoke_cell("codeqwen-decode-c128"), SEED, 2.0, True, "cuda",
                           time.monotonic())
    assert run.result["correct"], run.result["checks"]
    assert run.result["device"]["busy_s"] > 0
    for m in ("cascade_matmul_roofline", "decode_attention_roofline"):
        assert 0 < run.result["metrics"].get(m, {"value": 1})["value"] <= 105
