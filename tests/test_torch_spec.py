"""The port's speculative decode and sampling against the JAX package's.

* The drafter (``serve/spec.py``) is integer work: equal to the reference's
  on its own test cases and on random contexts.
* ``_truncate_logits`` is equal to the reference's, ties at the k-th logit
  included (the support is defined by value).
* Greedy speculative streams equal the JAX speculative engine's and the
  port's own plain greedy streams, on the reference's FP4 weights in f32
  (codeqwen and Mamba-2 smokes, fused and not).
* Sampled paths are held by distribution, since torch's generator gives
  other bits than the reference's threefry counters: the enumeration of
  ``tests/test_spec.py`` (total variation < 0.06 at the first row, < 0.1 at
  the second, acceptance frequency within 0.05 of p(d), 4096 draws each)
  and its deterministic branches, on models with an 8-token vocabulary.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro.serve.spec import ngram_propose as jngram_propose
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import registry
from repro_torch.serve import engine as tengine
from repro_torch.serve.spec import ngram_propose

jax.config.update("jax_platform_name", "cpu")

J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
T_TRAIN = CascadeConfig(mode="train", compute_dtype=torch.float32)
TINY_VOCAB = 8


# ---------------------------------------------------------------------------
# drafter
# ---------------------------------------------------------------------------

# the reference's drafter cases (tests/test_spec.py), plus the degenerate ends
NGRAM_CASES = [([1, 2, 3, 9, 1, 2, 3], 3, 3), ([5, 7, 1, 5, 7, 2, 5, 7], 1, 2),
               ([4, 1, 2, 4], 2, 3), ([1, 2, 3], 2, 3), ([7], 2, 3), ([9, 3, 9], 3, 1),
               ([5, 0, 0, 7, 1, 5], 3, 1), ([4, 0, 4], 3, 1), ([7, 0, 7], 1, 1),
               ([0] * 12, 4, 3), ([8, 9, 8, 9, 8], 4, 2), ([], 2, 3), ([1, 1], 0, 2)]


@pytest.mark.parametrize("ctx,k,n", NGRAM_CASES)
def test_ngram_propose_matches_jax_on_reference_cases(ctx, k, n):
    want, wk = jngram_propose(np.asarray(ctx, np.int32), k, n)
    got, gk = ngram_propose(np.asarray(ctx, np.int32), k, n)
    assert gk == wk and got.dtype == np.int32 and got.tolist() == want.tolist()


def test_ngram_propose_matches_jax_on_random_contexts():
    rng = np.random.default_rng(0)
    for _ in range(400):
        ctx = rng.integers(0, rng.integers(1, 6), rng.integers(0, 40)).astype(np.int32)
        k, n = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        want, wk = jngram_propose(ctx, k, n)
        got, gk = ngram_propose(ctx, k, n)
        assert gk == wk and got.tolist() == want.tolist(), (ctx.tolist(), k, n)


# ---------------------------------------------------------------------------
# truncation and the acceptance law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 1, 3, 8, 20])
def test_truncate_logits_matches_jax_ties_included(top_k):
    rng = np.random.default_rng(top_k)
    logits = rng.integers(-3, 4, (2, 3, 8)).astype(np.float32)    # many ties
    want = np.asarray(jengine._truncate_logits(jnp.asarray(logits), 0.7, top_k))
    got = tengine._truncate_logits(torch.from_numpy(logits), 0.7, top_k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a tie at the k-th logit keeps every tied entry
    tied = tengine._truncate_logits(torch.tensor([5.0, 4.0, 4.0, 4.0, 1.0]), 1.0, 2)
    assert torch.isfinite(tied).tolist() == [True, True, True, True, False]


def _tiny(arch):
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), vocab=TINY_VOCAB)
    model = registry.build_model(cfg)
    return cfg, model, model.init_params(0, T_TRAIN, device="cpu")


@pytest.fixture(scope="module", params=["codeqwen1.5-7b", "mamba2-370m"], ids=str)
def tiny_model(request):
    return _tiny(request.param)


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _p(logits, temperature, top_k):
    return torch.softmax(tengine._truncate_logits(logits, temperature, top_k), dim=-1)


@torch.no_grad()
def test_verify_row0_shares_p_with_plain_decode(tiny_model):
    """Row 0 of the verify pass and the plain decode step score the same
    distribution from the same cache state: the premise of the acceptance
    rule."""
    cfg, model, params = tiny_model
    prompt = torch.tensor([[3, 1, 4, 1, 5, 2, 6]]) % cfg.vocab
    _, cache = model.prefill(params, {"tokens": prompt}, T_TRAIN, max_len=32)
    dec, _ = model.decode_step(params, {"tokens": torch.tensor([[2]])}, _copy(cache), T_TRAIN)
    ver, _, _ = model.spec_verify(params, {"tokens": torch.tensor([[2, 5, 0]])}, _copy(cache),
                                  T_TRAIN)
    torch.testing.assert_close(dec[0, 0], ver[0, 0], atol=2e-5, rtol=2e-5)


@torch.no_grad()
def test_spec_sampled_marginal_exact_enumeration(tiny_model):
    """Every possible draft d0 on real verify logits: the committed token's
    marginal at the first row is the truncated p (accept d0 with p(d0),
    else resample from the residual) and, given acceptance, the second row's
    is p1."""
    cfg, model, params = tiny_model
    temperature, top_k, v, n = 0.8, 5, cfg.vocab, 4096
    prompt = torch.tensor([[1, 6, 2, 0, 3, 3, 7, 4]]) % v
    _, cache = model.prefill(params, {"tokens": prompt}, T_TRAIN, max_len=32)
    gen = torch.Generator().manual_seed(9)
    keff = torch.full((n,), 2)
    for d0 in range(v):
        chunk = torch.tensor([[5, d0, 2]])                  # pending, d0, d1
        logits, _, _ = model.spec_verify(params, {"tokens": chunk}, _copy(cache), T_TRAIN)
        p = _p(logits, temperature, top_k)[0].numpy()
        a, t = tengine.spec_sample_accept(logits.expand(n, -1, -1), chunk[:, 1:].expand(n, -1),
                                          keff, gen, temperature, top_k)
        a, t = a.numpy(), t.numpy()
        first = np.where(a > 0, d0, t)
        emp0 = np.bincount(first, minlength=v) / n
        assert 0.5 * np.abs(emp0 - p[0]).sum() < 0.06, (d0, emp0, p[0])
        acc = a >= 1
        if acc.sum() > 400:
            second = np.where(a[acc] > 1, 2, t[acc])
            emp1 = np.bincount(second, minlength=v) / acc.sum()
            assert 0.5 * np.abs(emp1 - p[1]).sum() < 0.1, (d0, emp1, p[1])
        assert abs(acc.mean() - p[0][d0]) < 0.05, (d0, acc.mean(), p[0][d0])


def test_spec_sampled_branch_enumeration_deterministic():
    """The branches whose law is a point, over 32 draws each: p(d) = 1
    always accepts and the bonus comes from row 1; a draft outside the
    top-k always rejects and the residual never returns it; k_eff = 0
    ignores the drafts; a padded position is never accepted even when its
    token has p = 1 (the bonus then comes from row k_eff)."""
    v, big, n = 6, 50.0, 32
    gen = torch.Generator().manual_seed(0)

    def run(logits, drafts, keff, top_k):
        lg = torch.tensor(logits, dtype=torch.float32)[None].expand(n, -1, -1)
        a, t = tengine.spec_sample_accept(lg, torch.tensor([drafts]).expand(n, -1),
                                          torch.full((n,), keff), gen, 1.0, top_k)
        return a.tolist(), t.tolist()

    lg = np.full((2, v), -big, np.float32)
    lg[0, 3], lg[1, 1] = big, big
    a, t = run(lg, [3], 1, 0)
    assert set(a) == {1} and set(t) == {1}
    lg = np.zeros((2, v), np.float32)
    lg[0] = [5.0, 4.0, 3.0, -big, 0.0, 0.0]
    a, t = run(lg, [3], 1, 3)
    assert set(a) == {0} and set(t) <= {0, 1, 2}
    lg = np.full((2, v), -big, np.float32)
    lg[0, 2] = big
    a, t = run(lg, [2], 0, 0)
    assert set(a) == {0} and set(t) == {2}
    lg = np.full((3, v), -big, np.float32)
    lg[0, 4], lg[1, 0], lg[2, 5] = big, big, big
    a, t = run(lg, [4, 0], 1, 0)
    assert set(a) == {1} and set(t) == {0}


def test_sampled_engine_first_decode_token_follows_the_exact_mixture(tiny_model):
    """End to end: over 150 seeds the first token of a speculative sampled
    step follows sum_t0 p0(t0) p1(. | t0) computed from the model, the law of
    plain sampled decode (admission draw included)."""
    cfg, model, params = tiny_model
    temperature, v, n = 0.9, cfg.vocab, 150
    prompt = (np.asarray([1, 6, 2, 0, 3, 3, 7, 4]) % v).astype(np.int32)
    with torch.no_grad():
        pl, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]}, T_TRAIN,
                              max_len=64)
        p0 = _p(pl[0, -1], temperature, 0).numpy()
        exact = np.zeros(v)
        for t0 in range(v):
            ext = torch.from_numpy(np.append(prompt, t0).astype(np.int32))[None]
            pl1, _ = model.prefill(params, {"tokens": ext}, T_TRAIN, max_len=64)
            exact += p0[t0] * _p(pl1[0, -1], temperature, 0).numpy()
    firsts = []
    for seed in range(n):
        eng = tengine.ServeEngine(model, params, T_TRAIN, tengine.ServeConfig(
            max_batch=1, max_len=64, prefill_chunk=8, draft_len=2, temperature=temperature,
            sample_seed=seed), device="cpu")
        req = tengine.Request(uid=seed, prompt=prompt, max_new_tokens=2)
        eng.submit(req)
        eng.run_until_drained(50)
        firsts.append(req.tokens_out[1])
    assert eng.effective_mode == "spec-sampled"
    emp = np.bincount(firsts, minlength=v) / n
    assert 0.5 * np.abs(emp - exact).sum() < 0.2, (emp, exact)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["codeqwen1.5-7b", "mamba2-370m"], ids=str)
def models(request):
    cfg, jm = jregistry.load(request.param, smoke=True)
    jp = jcascade.tree_to_serve_fp4(
        jm.init_params(jax.random.PRNGKey(0),
                       JCascadeConfig(mode="train", compute_dtype=jnp.float32)), J_FP4)
    _, tm = registry.load(request.param, smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _prompts(cfg, lens, seed=0):
    """Half repetitive (a short pattern tiled, so drafts get accepted), half
    random."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        if i % 2 == 0:
            out.append(np.resize(rng.integers(0, cfg.vocab, 3), n).astype(np.int32))
        else:
            out.append(rng.integers(0, cfg.vocab, n).astype(np.int32))
    return out


def _serve(eng, mod, prompts, max_new):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [list(r.tokens_out) for r in reqs]


def _three_ways(models, prompts, max_new, fused=True, **scfg):
    """Streams of the JAX speculative engine, the port's speculative engine
    and the port's plain greedy engine; the two speculative engines."""
    cfg, jm, jp, tm, tp = models
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(fused=fused, **scfg))
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(fused=fused, **scfg),
                               device="cpu")
    plain = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
        fused=fused, **dict(scfg, draft_len=0)), device="cpu")
    streams = (_serve(jeng, jengine, prompts, max_new), _serve(teng, tengine, prompts, max_new),
               _serve(plain, tengine, prompts, max_new))
    return streams, jeng, teng


@pytest.mark.parametrize("fused", [True, False])
def test_greedy_spec_streams_equal_jax_spec_and_plain_greedy(models, fused):
    cfg = models[0]
    (js, ts, ps), jeng, teng = _three_ways(models, _prompts(cfg, [12, 9, 15, 6]), 10,
                                           fused=fused, max_batch=2, max_len=40,
                                           prefill_chunk=8, draft_len=3)
    assert ts == js == ps
    assert all(len(s) == 10 for s in ts)
    assert teng.effective_mode == jeng.effective_mode == \
        "spec-greedy" + ("-fused" if fused else "")
    tm, jm = teng.metrics(), jeng.metrics()
    for key in ("steps", "decode_tokens", "draft_len", "draft_tokens_accepted",
                "accepted_per_step", "requests_finished"):
        assert tm[key] == jm[key], key


def test_fused_engine_hands_flash_attention_the_live_cache_prefix(monkeypatch):
    """The fused engine gives flash attention only the keys a chunk can see:
    an admission chunk exactly its position plus its length, a verify pass
    the longest active stream plus the draft length, which covers every
    active row's chunk (read from the cache positions the kernel gets)."""
    from repro_torch.kernels import ops as tops
    cfg, tm = registry.load("codeqwen1.5-7b", smoke=True)
    tp = tm.init_params(0, T_FP4, device="cpu")
    eng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
        fused=True, max_batch=2, max_len=48, prefill_chunk=8, draft_len=3), device="cpu")
    flash, seen = tops.flash_attention, {"admit": 0, "verify": 0}

    def spy(q, k, v, *, q_offset=None, **kw):
        s, t, off = q.shape[2], k.shape[2], q_offset.tolist()
        if eng._staging is not None and q.shape[0] == 1:
            assert t == off[0] + s, (t, off, s)
            seen["admit"] += 1
        else:
            active = eng._active()
            used = [len(eng.slots[i].prompt) + len(eng.slots[i].tokens_out) for i in active]
            assert t == max(used) + 3 and all(off[i] + s <= t for i in active), (t, off, used)
            seen["verify"] += 1
        return flash(q, k, v, q_offset=q_offset, **kw)
    monkeypatch.setattr(tops, "flash_attention", spy)
    streams = _serve(eng, tengine, _prompts(cfg, [12, 20, 7], seed=3), 6)
    assert all(len(st) == 6 for st in streams)
    assert seen["admit"] > 0 and seen["verify"] > 0, seen


def test_spec_with_budgeted_chunked_prefill_equals_jax(models):
    """Speculation interleaved with admissions of prompts longer than a
    chunk, a few tokens per step."""
    cfg = models[0]
    (js, ts, ps), jeng, teng = _three_ways(models, _prompts(cfg, [17, 8, 29], seed=1), 5,
                                           max_batch=2, max_len=64, prefill_chunk=8,
                                           token_budget=8, draft_len=4)
    assert ts == js == ps
    assert teng.metrics()["steps"] == jeng.metrics()["steps"]


def test_spec_eos_mid_acceptance_retires_like_plain_decode(models):
    """An eos inside an accepted run ends the stream at that token: the
    drafts after it are never exposed."""
    cfg = models[0]
    prompts = _prompts(cfg, [8], seed=2)
    (_, probe, _), _, _ = _three_ways(models, prompts, 6, max_batch=1, max_len=64,
                                      draft_len=4)
    eos = probe[0][2]
    (js, ts, ps), _, _ = _three_ways(models, prompts, 6, max_batch=1, max_len=64,
                                     draft_len=4, eos_id=eos)
    assert ts == js == ps
    assert ts[0][-1] == eos and len(ts[0]) <= 3


def test_spec_cache_has_draft_len_rows_of_headroom(models):
    cfg, jm, jp, tm, tp = models
    scfg = dict(max_batch=2, max_len=40, prefill_chunk=8, draft_len=4)
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**scfg))
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**scfg), device="cpu")
    assert teng._cache_len == jeng._cache_len == 48


# ---------------------------------------------------------------------------
# the engine on its own
# ---------------------------------------------------------------------------

def test_sampled_engine_is_deterministic_given_its_seed():
    cfg, model, params = _tiny("codeqwen1.5-7b")
    prompts = [np.arange(8, dtype=np.int32) % cfg.vocab, np.array([3, 1, 4, 1, 5], np.int32)]

    def run(draft_len, seed):
        eng = tengine.ServeEngine(model, params, T_TRAIN, tengine.ServeConfig(
            max_batch=2, max_len=64, prefill_chunk=8, draft_len=draft_len, temperature=0.9,
            top_k=5, sample_seed=seed), device="cpu")
        out = _serve(eng, tengine, prompts, 12)
        assert not eng.downgrades
        return out, eng.effective_mode

    for draft_len, mode in ((4, "spec-sampled"), (0, "batched-sampled")):
        a, got_mode = run(draft_len, 11)
        assert got_mode == mode
        assert run(draft_len, 11)[0] == a
        assert all(len(s) == 12 and all(0 <= t < cfg.vocab for t in s) for s in a)
        assert run(draft_len, 12)[0] != a


def test_spec_metrics_report_acceptance():
    """A zeroed head makes the greedy stream constant (argmax 0) and a zero
    tail keeps the drafter at k_eff = 4 from the first step: every step
    accepts all 4 drafts, and the accounting counts exactly those."""
    cfg, model, params = _tiny("codeqwen1.5-7b")
    params = dict(params, lm_head={"w": torch.zeros_like(params["lm_head"]["w"])})
    prompt = np.concatenate([np.tile([1, 2, 3, 4], 2), np.zeros(12)]).astype(np.int32)
    eng = tengine.ServeEngine(model, params, T_TRAIN, tengine.ServeConfig(
        max_batch=1, max_len=256, prefill_chunk=8, draft_len=4), device="cpu")
    eng.submit(tengine.Request(uid=0, prompt=prompt, max_new_tokens=41))
    eng.run_until_drained(200)
    m = eng.metrics()
    assert m["spec"] and m["draft_len"] == 4 and m["effective_mode"] == "spec-greedy"
    assert m["accepted_per_step"] == 4.0
    assert m["decode_tokens"] == 40 == m["draft_tokens_accepted"] + m["steps"]


def test_model_without_the_spec_api_downgrades_with_a_warning():
    cfg, model, params = _tiny("codeqwen1.5-7b")
    bare = types.SimpleNamespace(**{name: getattr(model, name) for name in (
        "init_cache", "prefill_extend", "decode_step", "write_cache")})
    with pytest.warns(RuntimeWarning, match="lacks spec_verify/spec_rewind"):
        eng = tengine.ServeEngine(bare, params, T_TRAIN,
                                  tengine.ServeConfig(draft_len=3, max_len=32), device="cpu")
    assert not eng.spec and eng.effective_mode == "batched-greedy"
    assert eng.metrics()["draft_len"] == 0 and eng.downgrades
