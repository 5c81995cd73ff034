"""The port's CREST, sparsity and flops modules against the JAX package's.

``crest_matmul`` runs beside the reference's on the same numpy ``x``, ``w``
and fault mask, step after step: the integer state (cursor, mismatch
counters, spare assignment, confirmed faults, repairs) must equal the
reference's exactly at every step, and ``y`` within f32 rounding (atol /
rtol 1e-5: the same f32 products, summed in another order by another
library). The reference's own CREST scenarios are ported with torch inputs,
and the serving engine's probe waves are held to the reference engine's
contract: faults confirmed and repaired, streams unchanged, Mamba-2's tied
head skipped. ``topk_sparsify`` masks equal the reference's exactly;
``flops`` counts equal the reference's exactly for every registry config.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from _hypothesis_shim import given, settings, strategies as st
from repro.configs import base as jbase
from repro.core import crest as jcrest
from repro.core import flops as jflops
from repro.core import sparsity as jsparsity
from repro.models import registry as jregistry
from repro_torch.configs import base as tbase
from repro_torch.core import crest as tcrest
from repro_torch.core import flops as tflops
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import registry
from repro_torch.serve import engine as tengine

jax.config.update("jax_platform_name", "cpu")

Y_TOL = dict(atol=1e-5, rtol=1e-5)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
STATE_FIELDS = ("cursor", "mismatch_count", "spare_assign", "confirmed_faults", "n_repaired")


def _fault_mask(n, cols):
    m = np.zeros(n, bool)
    m[list(cols)] = True
    return m


def _assert_state_equal(ts, js, step):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f"{f} at step {step}")


# n, k, m, n_spares, threshold, faulty columns
CASES = {
    "three_faults": (32, 16, 8, 4, 2, (3, 17, 30)),
    # seven faults, four spares, confirmed on the first mismatch: more
    # confirmations than free slots, so later faults find no slot
    "more_faults_than_spares": (16, 8, 4, 4, 1, (0, 1, 2, 5, 9, 10, 15)),
    # more spares than columns: the test window wraps onto itself
    "spares_wrap_the_columns": (10, 8, 4, 16, 2, (4, 7)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_crest_matmul_state_equals_jax_at_every_step(case):
    n, k, m, ns, thr, faults = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    w = rng.standard_normal((k, n)).astype(np.float32)
    fm = _fault_mask(n, faults)
    jcfg = jcrest.CrestConfig(n_spares=ns, threshold=thr)
    tcfg = tcrest.CrestConfig(n_spares=ns, threshold=thr)
    js, ts = jcrest.crest_init(n, jcfg), tcrest.crest_init(n, tcfg)
    jstep = jax.jit(lambda x, s: jcrest.crest_matmul(x, jnp.asarray(w), s, jcfg,
                                                     jnp.asarray(fm)))
    for i in range(40):
        x = rng.standard_normal((m, k)).astype(np.float32)
        jy, js = jstep(jnp.asarray(x), js)
        ty, ts = tcrest.crest_matmul(torch.from_numpy(x), torch.from_numpy(w), ts, tcfg,
                                     torch.from_numpy(fm))
        _assert_state_equal(ts, js, i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL, err_msg=f"y at step {i}")
    stats = tcrest.coverage_stats(ts, torch.from_numpy(fm))
    assert stats == jcrest.coverage_stats(js, jnp.asarray(fm))
    assert stats["detected"] == len(faults) and stats["false_positives"] == 0
    if case == "spares_wrap_the_columns":
        # a column appears twice in the wrapped window, and the reference's
        # scan allocates a slot at each appearance: more repairs than faults
        assert stats["repaired"] > len(faults)
    else:
        assert stats["repaired"] == min(len(faults), ns)
    if case == "more_faults_than_spares":
        assert stats["detected"] == len(faults) and stats["repaired"] == ns


def _alloc_scan(assign, newly, test_cols):
    """The reference's allocation ``lax.scan``, one test column at a time."""
    assign = assign.copy()
    allocated = np.zeros(len(newly), bool)
    for i in range(len(newly)):
        free = assign == -1
        if newly[i] and free.any():
            assign[np.argmax(free)] = test_cols[i]
            allocated[i] = True
    return assign, allocated


@pytest.mark.parametrize("seed", range(4))
def test_vectorised_allocation_equals_the_scan(seed):
    """Random slot tables (some taken, some free), newly confirmed sets and
    test windows: the vectorised allocation gives the scan's assignment and
    allocations in every case."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        ns = int(rng.integers(1, 20))
        assign = np.where(rng.random(ns) < rng.random(), rng.integers(0, 100, ns), -1) \
            .astype(np.int32)
        newly = rng.random(ns) < rng.random()
        cols = rng.integers(0, 100, ns).astype(np.int32)
        want, want_alloc = _alloc_scan(assign, newly, cols)
        got, got_alloc = tcrest.allocate_spares(torch.from_numpy(assign),
                                                torch.from_numpy(newly),
                                                torch.from_numpy(cols).to(torch.int64))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_alloc.numpy(), want_alloc)


# ---------------------------------------------------------------------------
# the reference's scenarios (tests/test_substrates.py, tests/test_properties.py)
# ---------------------------------------------------------------------------

def _randn(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_crest_detects_and_repairs_all_faults():
    cfg = tcrest.CrestConfig(n_spares=4, threshold=2)
    n, k, m = 32, 16, 8
    w = _randn(0, (k, n))
    fault = tcrest.inject_column_faults(torch.Generator().manual_seed(1), n, 3)
    assert int(fault.sum()) == 3
    state = tcrest.crest_init(n, cfg)
    for i in range(40):
        _, state = tcrest.crest_matmul(_randn(100 + i, (m, k)), w, state, cfg, fault)
    stats = tcrest.coverage_stats(state, fault)
    assert stats["detected"] == 3 and stats["false_positives"] == 0
    # the repaired output equals the clean product everywhere
    x = _randn(999, (m, k))
    y, _ = tcrest.crest_matmul(x, w, state, cfg, fault)
    np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=1e-4)


def test_crest_healthy_path_is_exact_and_stateless():
    cfg = tcrest.CrestConfig(n_spares=2, threshold=3)
    w = _randn(0, (8, 16))
    state = tcrest.crest_init(16, cfg)
    x = _randn(1, (4, 8))
    y, s2 = tcrest.crest_matmul(x, w, state, cfg, None)
    np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=1e-5)
    assert int(s2.confirmed_faults.sum()) == 0 and int(s2.n_repaired) == 0
    assert int(state.cursor) == 0      # the input state is not modified


def test_crest_transient_errors_filtered():
    """A fault that appears once (a cosmic ray) then disappears is not
    confirmed (the consecutive-mismatch filter, paper Section 20.2)."""
    cfg = tcrest.CrestConfig(n_spares=16, threshold=3)   # every column tested each step
    n, k = 16, 8
    w = _randn(0, (k, n))
    state = tcrest.crest_init(n, cfg)
    transient = torch.zeros((n,), dtype=torch.bool)
    transient[5] = True
    for i in range(6):
        _, state = tcrest.crest_matmul(_randn(i, (4, k)), w, state, cfg,
                                       transient if i == 2 else None)
    assert int(state.confirmed_faults.sum()) == 0
    assert int(state.mismatch_count.sum()) == 0


def _eventually_detected(seed, n_faults):
    cfg = tcrest.CrestConfig(n_spares=4, threshold=2)
    n, k = 24, 8
    w = _randn(seed, (k, n))
    fault = (tcrest.inject_column_faults(torch.Generator().manual_seed(seed + 1), n, n_faults)
             if n_faults else torch.zeros((n,), dtype=torch.bool))
    state = tcrest.crest_init(n, cfg)
    for i in range((n // cfg.n_spares) * (cfg.threshold + 1) + 2):
        _, state = tcrest.crest_matmul(_randn(1000 + seed + i, (4, k)), w, state, cfg,
                                       fault if n_faults else None)
    stats = tcrest.coverage_stats(state, fault)
    assert stats["detected"] == n_faults
    assert stats["false_positives"] == 0
    assert stats["repaired"] == n_faults


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 16), st.integers(0, 4))
def test_crest_eventually_detects_any_fault_set(seed, n_faults):
    """Any fault set of at most n_spares columns is detected and repaired,
    with no false positive, within enough probe cycles."""
    _eventually_detected(seed, n_faults)


@pytest.mark.parametrize("seed,n_faults", [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4)])
def test_crest_eventually_detects_fault_sets_of_each_size(seed, n_faults):
    """The property above at one seed for each fault count (it runs where
    hypothesis is not installed)."""
    _eventually_detected(seed, n_faults)


# ---------------------------------------------------------------------------
# the serving engine's probe waves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def codeqwen():
    cfg, model = registry.load("codeqwen1.5-7b", smoke=True)
    return cfg, model, model.init_params(0, T_FP4, device="cpu")


def _serve(eng, cfg, n=4, prompt_len=8, max_new=12, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [tengine.Request(uid=i, prompt=rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
                            max_new_tokens=max_new) for i in range(n)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(200)
    assert all(r.done for r in reqs)
    return [r.tokens_out for r in reqs]


def test_crest_confirms_and_repairs_faults_through_the_batched_engine(codeqwen):
    """The reference's ``test_crest_confirms_faults_through_batched_engine``:
    probe waves every step on the lm_head while requests flow, then enough
    idle-time probes for three cursor cycles."""
    cfg, model, params = codeqwen
    scfg = tengine.ServeConfig(max_batch=2, max_len=48, fused=True, crest_enabled=True,
                               crest_every=1,
                               crest_cfg=tcrest.CrestConfig(n_spares=8, threshold=2))
    eng = tengine.ServeEngine(model, params, T_FP4, scfg, device="cpu")
    eng.fault_mask = tcrest.inject_column_faults(torch.Generator().manual_seed(7), cfg.vocab, 3)
    _serve(eng, cfg, max_new=16)
    for _ in range(3 * cfg.vocab // scfg.crest_cfg.n_spares):
        eng._steps += 1
        eng._crest_probe()
    rep = eng.crest_report()
    assert rep["confirmed_faults"] >= 3 and rep["repaired"] >= 3, rep
    stats = tcrest.coverage_stats(eng.crest_state, eng.fault_mask)
    assert stats["detected"] == 3 and stats["false_positives"] == 0


@pytest.mark.parametrize("draft_len", [0, 3])
def test_crest_leaves_greedy_streams_unchanged(codeqwen, draft_len):
    """Probe waves touch no serving state: greedy streams (plain and
    speculative, on repetitive prompts so drafts are accepted) equal the
    CREST-off run's, and a healthy run confirms no fault."""
    cfg, model, params = codeqwen
    streams, engines = [], []
    for on in (False, True):
        scfg = tengine.ServeConfig(max_batch=2, max_len=48, prefill_chunk=8, fused=True,
                                   draft_len=draft_len, crest_enabled=on, crest_every=2)
        eng = tengine.ServeEngine(model, params, T_FP4, scfg, device="cpu")
        rng = np.random.default_rng(3)
        reqs = [tengine.Request(uid=i, prompt=np.resize(rng.integers(0, cfg.vocab, 3), 10)
                                .astype(np.int32), max_new_tokens=10) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        streams.append([r.tokens_out for r in reqs])
        engines.append(eng)
    assert streams[0] == streams[1]
    off, on = engines
    assert off.crest_report() == {} and off.crest_state is None
    assert on.crest_report() == {"confirmed_faults": 0, "repaired": 0}
    assert int(on.crest_state.cursor) > 0             # probes ran
    assert on._probe_w.dtype == torch.float32 and on._probe_w.shape == (cfg.d_model, cfg.vocab)


def test_crest_on_mamba2_skips_the_probe():
    """Mamba-2 ties its head to the embedding and has no ``lm_head``: no
    dense probe weight, no state, no probe, the same streams. (The
    reference's ``_crest_probe`` skips such a model too; its engine
    constructor reads the missing weight's shape and raises first.)"""
    cfg, model = registry.load("mamba2-370m", smoke=True)
    params = model.init_params(0, T_FP4, device="cpu")
    streams = []
    for on in (False, True):
        eng = tengine.ServeEngine(model, params, T_FP4, tengine.ServeConfig(
            max_batch=2, max_len=32, fused=True, crest_enabled=on, crest_every=1), device="cpu")
        streams.append(_serve(eng, cfg, n=2, max_new=6))
        assert eng._probe_w is None and eng.crest_state is None and eng.crest_report() == {}
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# sparsity and flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.1, 0.5])
@pytest.mark.parametrize("per_column", [True, False], ids=["per_column", "per_tensor"])
def test_topk_sparsify_masks_equal_jax(density, per_column):
    """f32 random weights (no ties): the same masks and weights."""
    w = np.random.default_rng(5).standard_normal((48, 20)).astype(np.float32)
    jw, jm = jsparsity.topk_sparsify(jnp.asarray(w), density, per_column)
    tw, tm = tsparsity.topk_sparsify(torch.from_numpy(w), density, per_column)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(tm.sum(0).min() if per_column else tm.sum()) == (
        max(1, round(density * 48)) if per_column else max(1, round(density * 48 * 20)))
    js, ts = jsparsity.sparsity_stats(jw), tsparsity.sparsity_stats(tw)
    assert ts["total"] == js["total"] and ts["zeros"] == js["zeros"]
    for key in ("sparsity", "activity_factor"):
        assert ts[key] == pytest.approx(js[key], rel=1e-7), key


def test_topk_sparsify_keeps_every_weight_tied_at_the_threshold():
    """Ties: every weight whose magnitude equals the keep-th largest is kept
    (a column may keep more than ``keep``), as the reference's threshold
    keeps it; the masks equal the reference's on ties too."""
    w = np.array([[1.0, -2.0], [1.0, 2.0], [-1.0, 0.5], [0.25, 2.0]], np.float32)
    tw, tm = tsparsity.topk_sparsify(torch.from_numpy(w), 0.5)        # keep 2 of 4 a column
    np.testing.assert_array_equal(tm.numpy(), [[True, True], [True, True], [True, False],
                                               [False, True]])
    jw, jm = jsparsity.topk_sparsify(jnp.asarray(w), 0.5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("arch", sorted(registry.ALIASES) + ["llama31_405b"])
def test_flops_equal_jax_for_every_registry_config(arch):
    for smoke in (False, True):
        tcfg = registry.get_config(arch, smoke)
        jcfg = jregistry.get_config(arch, smoke)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tflops.param_count(tcfg) == jflops.param_count(jcfg)
        for fp4 in (True, False):
            assert tflops.weight_bytes(tcfg, fp4) == jflops.weight_bytes(jcfg, fp4)
        for name, shape in tbase.SHAPES.items():
            jshape = jbase.SHAPES[name]
            assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
            assert tbase.shape_applicable(tcfg, shape) == jbase.shape_applicable(jcfg, jshape)
            assert tflops.step_flops(tcfg, shape) == jflops.step_flops(jcfg, jshape)
