"""The port's Griffin (``repro_torch.models.griffin``), its ring-buffer
attention and its engine limits, against the JAX package's.

Inputs come from numpy seeds; model weights are the reference's own (FP4
for the model and engine, dense f32 for the attention layer), carried
across by ``convert.params_from_numpy`` (which unstacks the reference's
(R, R, A) groups into the port's layer list). Everything runs in f32 at
smoke size (5 layers: one (R, R, A) group and two tail R blocks; d_model
64, 4 heads over 1 KV head of 16, window 16 or 8, vocab 256). Tolerances:

* ring attention (decode, extend): atol/rtol 1e-5; the same f32 einsums
  and softmax, summed in another order; the ring's integer state
  (``slot_pos``, ``pos``) exactly;
* the RG-LRU: atol/rtol 1e-5 in decode (the same elementwise f32 ops);
  extend steps through the chunk in order and full mode runs a log-depth
  scan where the reference runs ``lax.associative_scan``: the same products
  and sums associated otherwise, also within 1e-5;
* model logits and caches: atol/rtol 1e-4, as the transformer tests hold
  them (five layers of those differences through norms and FP4 matmuls);
* engine streams: token for token.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import layers as jL
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as tL
from repro_torch.models import registry
from repro_torch.models.griffin import GriffinLM
from repro_torch.serve import engine as tengine

jax.config.update("jax_platform_name", "cpu")

PRIM_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_TRAIN = CascadeConfig(mode="train", compute_dtype=torch.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# ring-buffer attention
# ---------------------------------------------------------------------------

ACFG = dict(d_model=32, n_heads=4, n_kv_heads=1, head_dim=8, window=8)


def _ring_state(b, t, positions, seed):
    """A consistent ring: row b next writes ``positions[b]``; rows hold the
    last positions below it (-1: never written), random K/V."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(positions, np.int64)[:, None]
    r = np.arange(t)[None, :]
    last = pos - 1 - ((pos - 1 - r) % t)
    slot_pos = np.where(last >= 0, last, -1).astype(np.int32)
    k = rng.standard_normal((b, t, 1, 8)).astype(np.float32)
    v = rng.standard_normal((b, t, 1, 8)).astype(np.float32)
    return {"k": k, "v": v, "slot_pos": slot_pos, "pos": np.asarray(positions, np.int32)}


def _close_ring(tc, jc):
    for name in ("k", "v"):
        _close(tc[name], jc[name], PRIM_TOL)
    for name in ("slot_pos", "pos"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


# (chunk, n_valid) steps; 0 = a decode step
RING_STEPS = {
    "pads": [(5, 3), (0, None), (4, 1), (5, 5), (0, None)],
    "wraps": [(6, 6), (6, 6), (0, None), (0, None), (7, 4), (8, 8), (0, None)],
}


@pytest.mark.parametrize("steps", list(RING_STEPS))
@pytest.mark.parametrize("start", [[0, 0], [5, 13]], ids=["empty", "wrapped"])
def test_ring_decode_and_extend_equal_jax(steps, start):
    """Extend chunks with pad rows and across the ring's wrap, and decode
    steps, on the same ring: outputs and the ring (K/V, ``slot_pos``,
    ``pos``) after every step."""
    jcfg = jL.AttnConfig(**ACFG)
    tcfg = tL.AttnConfig(**ACFG)
    jp = jL.attn_init(jax.random.PRNGKey(1), jcfg, J_TRAIN)
    tp = _to_torch(jp)
    state = _ring_state(2, 8, start, seed=len(steps))
    jc = {k: jnp.asarray(v) for k, v in state.items()}
    tc = {k: _t(v) for k, v in state.items()}
    rng = np.random.default_rng(7)
    for s, nv in RING_STEPS[steps]:
        mode = "extend" if s else "decode"
        x = rng.standard_normal((2, s or 1, 32)).astype(np.float32)
        jo, jc = jL.attn_apply(jp, jnp.asarray(x), jcfg, J_TRAIN, cache=jc, mode=mode,
                               n_valid=nv)
        to, tc = tL.attn_apply(tp, _t(x), tcfg, T_TRAIN, cache=tc, mode=mode, n_valid=nv)
        valid = slice(None) if nv is None else slice(0, nv)
        _close(to[:, valid], jo[:, valid], PRIM_TOL)
        _close_ring(tc, jc)


def test_ring_extend_refuses_a_chunk_longer_than_the_ring():
    tcfg = tL.AttnConfig(**ACFG)
    tp = _to_torch(jL.attn_init(jax.random.PRNGKey(1), jL.AttnConfig(**ACFG), J_TRAIN))
    tc = tL.attn_cache_init(1, 4, tcfg, torch.float32)
    assert tc["k"].shape[1] == 8 and bool((tc["slot_pos"] == -1).all())  # the window, not 4
    with pytest.raises(ValueError, match="ring"):
        tL.attn_apply(tp, torch.zeros((1, 9, 32)), tcfg, T_TRAIN, cache=tc, mode="extend")


@pytest.mark.parametrize("s", [5, 19])
def test_windowed_prefill_and_its_ring_equal_jax(s):
    """Windowed full-sequence attention, and the ring ``prefill`` builds
    (shorter and longer than the window: padded, or the last window rolled
    to p % window)."""
    jcfg, tcfg = jL.AttnConfig(**ACFG), tL.AttnConfig(**ACFG)
    jp = jL.attn_init(jax.random.PRNGKey(2), jcfg, J_TRAIN)
    x = np.random.default_rng(s).standard_normal((2, s, 32)).astype(np.float32)
    jo, jc = jL.attn_apply(jp, jnp.asarray(x), jcfg, J_TRAIN, mode="prefill", max_len=4)
    to, tc = tL.attn_apply(_to_torch(jp), _t(x), tcfg, T_TRAIN, mode="prefill", max_len=4)
    _close(to, jo, PRIM_TOL)
    _close_ring(tc, jc)


def _reference_ring_softmax(q, ring_k, ring_v, k, v, slot_pos, pos, window):
    """The reference's [ring, chunk] attention (``layers.attn_apply``,
    ring-buffer extend) in JAX, in its (B, S, H, D) layout."""
    b, s, h, d = q.shape
    rows = pos[:, None] + jnp.arange(s, dtype=jnp.int32)[None, :]
    key_pos = jnp.concatenate([slot_pos, rows], axis=1)
    att_k = jnp.concatenate([ring_k, k], axis=1)
    att_v = jnp.concatenate([ring_v, v], axis=1)
    valid = ((key_pos[:, None, :] >= 0) & (key_pos[:, None, :] <= rows[:, :, None])
             & (rows[:, :, None] - key_pos[:, None, :] < window))
    hk = k.shape[2]
    qd = q.reshape(b, s, hk, h // hk, d)
    logits = jnp.einsum("bshgd,bthd->bhgst", qd, att_k) / (d ** 0.5)
    logits = jnp.where(valid[:, None, None], logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("bhgst,bthd->bshgd", p, att_v).reshape(b, s, h, d)


@pytest.mark.parametrize("positions", [[3, 40], [8, 9]])
def test_flash_attention_plain_with_k_pos_and_window_equals_the_reference_ring(positions):
    rng = np.random.default_rng(sum(positions))
    b, t, s, h, hk, d, w = 2, 16, 6, 4, 2, 8, 16
    st = _ring_state(b, t, positions, seed=1)
    ring_k = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    ring_v = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, hk, hk))
    pos = st["pos"]
    want = _reference_ring_softmax(*(jnp.asarray(a) for a in (q, ring_k, ring_v, k, v,
                                                              st["slot_pos"], pos)), w)
    rows = pos[:, None] + np.arange(s, dtype=np.int32)[None, :]
    k_pos = _t(np.concatenate([st["slot_pos"], rows], axis=1))
    got = tfa.flash_attention_plain(
        _t(q).transpose(1, 2), _t(np.concatenate([ring_k, k], 1)).transpose(1, 2),
        _t(np.concatenate([ring_v, v], 1)).transpose(1, 2), True, None, _t(pos), k_pos, w)
    _close(got.transpose(1, 2), want, dict(atol=1e-6, rtol=1e-6))


def test_flash_attention_plain_without_k_pos_or_window_keeps_its_bits():
    """The plain version as it was before ``k_pos`` and ``window`` (inline
    below) and the extended one give the same bits on the same call."""
    rng = np.random.default_rng(0)
    b, hq, hkv, s, t, d = 3, 6, 2, 7, 20, 16
    q, k, v = (_t(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    off = torch.tensor([0, 5, 13], dtype=torch.int32)
    scale = 1.0 / (d ** 0.5)
    qf = q.reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k) * scale
    rows = off.to(torch.int64)[:, None] + torch.arange(s)
    visible = torch.arange(t)[None, None, :] <= rows[:, :, None]
    logits = logits.masked_fill(~visible[:, None, None], -1e30)
    before = torch.einsum("bhgst,bhtd->bhgsd", torch.softmax(logits, -1), v).reshape(b, hq, s, d)
    assert torch.equal(tfa.flash_attention_plain(q, k, v, True, None, off), before)
    full = torch.einsum("bhgst,bhtd->bhgsd",
                        torch.softmax(torch.einsum("bhgsd,bhtd->bhgst", qf, k) * scale, -1),
                        v).reshape(b, hq, s, d)
    assert torch.equal(tfa.flash_attention_plain(q, k, v, False), full)


# ---------------------------------------------------------------------------
# the RG-LRU and the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def griffin():
    """(cfg, JAX model, JAX FP4 params, port model, port params) at smoke size."""
    cfg, jm = jregistry.load("recurrentgemma-2b", smoke=True)
    jp = jax.jit(lambda k: jcascade.tree_to_serve_fp4(jm.init_params(k, J_TRAIN), J_FP4))(
        jax.random.PRNGKey(0))
    _, tm = registry.load("recurrentgemma-2b", smoke=True)
    assert isinstance(tm, GriffinLM) and tm.unbounded_context
    return cfg, jm, jp, tm, _to_torch(jp)


@pytest.mark.parametrize("mode,n_valid", [("decode", None), ("extend", None), ("extend", 5),
                                          ("full", None)])
def test_rglru_equals_jax(griffin, mode, n_valid):
    cfg, jm, jp, tm, tp = griffin
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"]["b0"])
    lp_t = tp["layers"][0]
    rng = np.random.default_rng(3)
    s = 1 if mode == "decode" else 9
    y = rng.standard_normal((2, s, tm.lru)).astype(np.float32)
    h0 = None if mode == "full" else rng.standard_normal((2, tm.lru)).astype(np.float32)
    jo, jh, jall = jm._rglru(lp_j, jnp.asarray(y), J_FP4,
                             None if h0 is None else jnp.asarray(h0), mode, n_valid)
    to, th, tall = tm._rglru(lp_t, _t(y), T_FP4, None if h0 is None else _t(h0), mode,
                             n_valid)
    _close(to, jo, PRIM_TOL)
    _close(th, jh, PRIM_TOL)
    if mode == "extend":
        _close(tall, jall, PRIM_TOL)
        if n_valid is not None:            # pad steps are the identity
            assert torch.equal(tall[:, n_valid:], tall[:, n_valid - 1:n_valid].expand_as(
                tall[:, n_valid:]))


def test_params_carry_across_as_one_layer_list(griffin):
    cfg, jm, jp, tm, tp = griffin
    assert tm.kinds == ["R", "R", "A", "R", "R"] and len(tp["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(tp["layers"][2]["attn"]["wq"]["codes"].numpy(),
                                  np.asarray(jp["groups"]["b2"]["attn"]["wq"]["codes"][0]))
    np.testing.assert_array_equal(tp["layers"][4]["lam"].numpy(), np.asarray(jp["tail"][1]["lam"]))


def _jcache_to_port(tm, jc):
    """The reference's cache ({groups: {b0, b1, b2} stacked by group, tail:
    [...]}) in the port's layout ({layers: R blocks, attn: A blocks})."""
    rec, att = [], []
    for g in range(tm.n_groups):
        for i, kind in enumerate(tm.group):
            leaf = jax.tree.map(lambda a: np.asarray(a)[g], jc["groups"][f"b{i}"])
            (rec if kind == "R" else att).append(leaf)
    rec += [jax.tree.map(np.asarray, c) for c in jc["tail"]]
    stack = lambda trees: {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return {"layers": stack(rec), "attn": stack(att)}


def _close_cache(tm, tc, jc):
    want = _jcache_to_port(tm, jc)
    for group in ("layers", "attn"):
        for name, leaf in want[group].items():
            got = tc[group][name]
            if name in ("pos", "slot_pos"):
                np.testing.assert_array_equal(got.numpy(), leaf, err_msg=name)
            else:
                _close(got, leaf)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_griffin_forward_prefill_and_decode_equal_jax(griffin):
    cfg, jm, jp, tm, tp = griffin
    toks = _tokens(cfg, 2, 24)                          # past the 16-token window
    _close(tm.forward(tp, {"tokens": _t(toks)}, T_FP4),
           jm.forward(jp, {"tokens": jnp.asarray(toks)}, J_FP4))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=32)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, T_FP4, max_len=32)
    _close(tl, jl)
    _close_cache(tm, tc, jc)
    for i in range(3):
        nxt = _tokens(cfg, 2, 1, seed=10 + i)
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
        tl, tc = tm.decode_step(tp, {"tokens": _t(nxt)}, tc, T_FP4)
        _close(tl, jl)
        _close_cache(tm, tc, jc)


def test_griffin_prefill_extend_chunks_equal_jax(griffin):
    """Right-padded chunks of 8 from an empty cache, across the window:
    logits of the last valid token and every cache leaf after each chunk."""
    cfg, jm, jp, tm, tp = griffin
    prompt = _tokens(cfg, 1, 29, seed=4)[0]
    jc = jm.init_cache(1, 32, dtype=jnp.float32)
    tc = tm.init_cache(1, 32, dtype=torch.float32, device="cpu")
    for c0 in range(0, len(prompt), 8):
        n = min(8, len(prompt) - c0)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[c0:c0 + n]
        jl, jc = jm.prefill_extend(jp, {"tokens": jnp.asarray(toks)}, jc, J_FP4,
                                   n_valid=jnp.int32(n))
        tl, tc = tm.prefill_extend(tp, {"tokens": _t(toks)}, tc, T_FP4, n_valid=n)
        _close(tl, jl)
        _close_cache(tm, tc, jc)


def test_griffin_spec_verify_and_rewind_equal_jax(griffin):
    """A verify pass over a (2, 4) chunk after a ring-wrapping prefill, then
    per-slot rewinds (keep 1 and 3): logits, the advanced cache and the
    rewound cache."""
    cfg, jm, jp, tm, tp = griffin
    toks = _tokens(cfg, 2, 20, seed=5)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=32)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, T_FP4, max_len=32)
    chunk = _tokens(cfg, 2, 4, seed=6)
    jl, jc, jck = jm.spec_verify(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4)
    tl, tc, tck = tm.spec_verify(tp, {"tokens": _t(chunk)}, tc, T_FP4)
    _close(tl, jl)
    _close_cache(tm, tc, jc)
    keep = np.array([1, 3], np.int32)
    jc = jm.spec_rewind(jc, jck, jnp.asarray(keep))
    tc = tm.spec_rewind(tc, tck, _t(keep))
    _close_cache(tm, tc, jc)


# ---------------------------------------------------------------------------
# the engine: the reference's ring cases (tests/test_engine.py), speculation,
# paging, slot reuse
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def griffin_w8(griffin):
    """Window 8 (the reference's ``griffin_w8``), so prompts overrun the ring
    quickly; the same weights (the window shapes no parameter)."""
    cfg, jm, jp, tm, tp = griffin
    cfg8 = dataclasses.replace(cfg, window=8)
    return cfg8, jregistry.build_model(cfg8), jp, registry.build_model(cfg8), tp


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(mod, eng, prompts, max_new):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(600)
    assert all(r.done for r in reqs)
    return [list(r.tokens_out) for r in reqs]


def _both(models, prompts, max_new, **scfg):
    """The JAX engine's streams (plain) and the port's (kernel routes, their
    plain versions on the CPU), and the port's engine."""
    cfg, jm, jp, tm, tp = models
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**scfg))
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(fused=True, **scfg),
                               device="cpu")
    return _serve(jengine, jeng, prompts, max_new), _serve(tengine, teng, prompts, max_new), teng


RING_CASES = {
    # prompts several times the window, chunk-prefilled through the ring
    "prompt_longer_than_window": (dict(max_batch=2, max_len=64, prefill_chunk=4), [23, 40, 9]),
    # chunk == ring length: every chunk boundary lands on the ring's wrap
    "chunk_boundary_on_ring_wrap": (dict(max_batch=2, max_len=64, prefill_chunk=8),
                                    [16, 24, 17, 8]),
    # a chunk larger than the ring is clamped to it
    "oversized_chunk_clamped": (dict(max_batch=1, max_len=64, prefill_chunk=32), [20]),
    # prompts longer than max_len are admitted and never context-retired
    "window_aware_admission": (dict(max_batch=2, max_len=16, prefill_chunk=8), [30, 70]),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_engine_ring_cases_equal_jax(griffin_w8, case):
    scfg, lens = RING_CASES[case]
    cfg = griffin_w8[0]
    js, ts, teng = _both(griffin_w8, _prompts(cfg.vocab, lens, seed=len(lens)), 5, **scfg)
    assert ts == js and all(len(t) == 5 for t in ts)
    m = teng.metrics()
    assert m["effective_mode"] == "batched-greedy-fused" and m["requests_rejected"] == 0
    if case == "oversized_chunk_clamped":
        assert teng._chunk_cap == 8


def test_engine_window_larger_than_max_len_equals_jax(griffin):
    """window 16 > max_len 12: the ring still holds the full window."""
    cfg = griffin[0]
    js, ts, teng = _both(griffin, _prompts(cfg.vocab, [20, 30, 10], seed=9), 6,
                         max_batch=2, max_len=12, prefill_chunk=8)
    assert ts == js
    assert teng.cache["attn"]["k"].shape[2] == 16


def test_spec_greedy_with_draft_clamped_to_the_window_equals_plain_and_jax(griffin_w8):
    """draft_len 12 on a window of 8 is clamped to 7 (the verify chunk of
    1 + K tokens must fit the ring): speculative greedy streams, on
    repetitive prompts so drafts are accepted, equal plain greedy and the
    JAX speculative engine's."""
    cfg, jm, jp, tm, tp = griffin_w8
    rng = np.random.default_rng(3)
    prompts = [np.resize(rng.integers(0, cfg.vocab, 3), n).astype(np.int32)
               for n in (12, 21, 9)]
    scfg = dict(max_batch=2, max_len=64, prefill_chunk=8, draft_len=12)
    js, ts, teng = _both(griffin_w8, prompts, 10, **scfg)
    plain = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
        fused=True, **dict(scfg, draft_len=0)), device="cpu")
    assert ts == js == _serve(tengine, plain, prompts, 10)
    m = teng.metrics()
    assert m["draft_len"] == 7 and m["effective_mode"] == "spec-greedy-fused"
    assert m["draft_tokens_accepted"] > 0


def test_paged_request_downgrades_to_the_dense_ring_with_a_warning(griffin_w8):
    cfg, jm, jp, tm, tp = griffin_w8
    prompts = _prompts(cfg.vocab, [11, 19], seed=3)
    dense = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
        max_batch=2, max_len=32, prefill_chunk=8, fused=True), device="cpu")
    with pytest.warns(RuntimeWarning, match="paged KV requested"):
        eng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
            max_batch=2, max_len=32, prefill_chunk=8, fused=True, prefix_cache=True,
            page_size=4), device="cpu")
    assert not eng.paged and eng.prefix is None and eng.downgrades
    assert _serve(tengine, eng, prompts, 4) == _serve(tengine, dense, prompts, 4)


def test_a_reused_slot_keeps_nothing_of_its_last_ring(griffin_w8):
    """One slot serves a long stream, then a short one: at the short one's
    admission the slot's rings hold only its own positions, and its stream
    equals the stream a fresh engine gives it."""
    cfg, jm, jp, tm, tp = griffin_w8
    long_p, short_p = _prompts(cfg.vocab, [27, 3], seed=8)
    scfg = tengine.ServeConfig(max_batch=1, max_len=64, prefill_chunk=8, fused=True)
    eng = tengine.ServeEngine(tm, tp, T_FP4, scfg, device="cpu")
    _serve(tengine, eng, [long_p], 6)
    req = tengine.Request(uid=9, prompt=short_p, max_new_tokens=4)
    eng.submit(req)
    eng._admit()
    sp = eng.cache["attn"]["slot_pos"][:, 0]
    assert int(sp.max()) == len(short_p) - 1 and int((sp >= 0).sum(-1).max()) == len(short_p)
    assert bool((eng.cache["attn"]["pos"][:, 0] == len(short_p)).all())
    eng.run_until_drained()
    fresh = tengine.ServeEngine(tm, tp, T_FP4, scfg, device="cpu")
    assert req.tokens_out == _serve(tengine, fresh, [short_p], 4)[0]


def test_windowed_transformer_equals_jax():
    """A windowed dense transformer (codeqwen's smoke config with window 8)
    builds, pages nothing and is context-unbounded, and its chunked prefill
    over the ring and decode steps equal the reference's."""
    jcfg = dataclasses.replace(jregistry.get_config("codeqwen1.5-7b", smoke=True), window=8)
    jm = jregistry.build_model(jcfg)
    jp = jcascade.tree_to_serve_fp4(jm.init_params(jax.random.PRNGKey(0), J_TRAIN), J_FP4)
    tm = registry.build_model(dataclasses.replace(
        registry.get_config("codeqwen1.5-7b", smoke=True), window=8))
    assert tm.unbounded_context and not tm.paged_attention
    tp = _to_torch(jp)
    jc = jm.init_cache(1, 16, dtype=jnp.float32)
    tc = tm.init_cache(1, 16, dtype=torch.float32, device="cpu")
    prompt = _tokens(jcfg, 1, 19, seed=2)
    for c0 in range(0, 19, 8):
        n = min(8, 19 - c0)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[0, c0:c0 + n]
        jl, jc = jm.prefill_extend(jp, {"tokens": jnp.asarray(toks)}, jc, J_FP4,
                                   n_valid=jnp.int32(n))
        tl, tc = tm.prefill_extend(tp, {"tokens": _t(toks)}, tc, T_FP4, n_valid=n)
        _close(tl, jl)
    for i in range(3):
        nxt = _tokens(jcfg, 1, 1, seed=20 + i)
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
        tl, tc = tm.decode_step(tp, {"tokens": _t(nxt)}, tc, T_FP4)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))


def test_serve_cli_runs_griffin_on_the_cpu():
    import os
    import subprocess
    import sys
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "recurrentgemma-2b", "--smoke", "--device", "cpu", "--fused",
                          "--requests", "3", "--prompt-len", "20", "--max-new", "4",
                          "--draft-len", "3"],
                         capture_output=True, text=True, timeout=300, cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "spec-greedy-fused" in res.stdout
