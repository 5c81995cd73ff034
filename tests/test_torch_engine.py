"""The port's greedy batched engine against the JAX ServeEngine.

Both engines serve the reference's own FP4 weights (carried across through
``convert.params_from_numpy``) in f32, so near-tie logits do not flip, and
must emit the same greedy token streams: codeqwen (dense transformer) with
``fused=True``, Mamba-2 with and without it. The JAX engine runs its Pallas
kernels in interpret mode; the port's wrappers run their plain versions on
the CPU tensors.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import registry as jregistry
from repro.serve import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import registry
from repro_torch.serve import engine as tengine

jax.config.update("jax_platform_name", "cpu")

J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    cfg, jm = jregistry.load("codeqwen1.5-7b", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0),
                        JCascadeConfig(mode="train", compute_dtype=jnp.float32))
    jp = jcascade.tree_to_serve_fp4(jp, J_FP4)
    _, tm = registry.load("codeqwen1.5-7b", smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def mamba_models():
    cfg, jm = jregistry.load("mamba2-370m", smoke=True)
    jp = jcascade.tree_to_serve_fp4(
        jm.init_params(jax.random.PRNGKey(0),
                       JCascadeConfig(mode="train", compute_dtype=jnp.float32)), J_FP4)
    _, tm = registry.load("mamba2-370m", smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _serve(eng, mod, prompts, max_new, waves=None):
    """Submit ``prompts`` (in ``waves``: lists of indices submitted only once
    the engine has drained the previous wave) and drain."""
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for wave in waves or [range(len(reqs))]:
        for i in wave:
            eng.submit(reqs[i])
        eng.run_until_drained()
    return reqs


def _both(models, prompts, max_new, waves=None, fused=True, **scfg):
    cfg, jm, jp, tm, tp = models
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(fused=fused, **scfg))
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(fused=fused, **scfg),
                               device="cpu")
    jr = _serve(jeng, jengine, prompts, max_new, waves)
    tr = _serve(teng, tengine, prompts, max_new, waves)
    assert jeng.fused == teng.fused == fused
    assert teng.effective_mode == jeng.effective_mode == \
        "batched-greedy" + ("-fused" if fused else "")
    return jeng, jr, teng, tr


def _streams(reqs):
    return [list(r.tokens_out) for r in reqs]


def test_greedy_streams_equal_jax_fused_engine(models):
    cfg = models[0]
    jeng, jr, teng, tr = _both(models, _prompts(cfg, [10, 10, 10]), 10,
                               max_batch=2, max_len=40)
    assert _streams(tr) == _streams(jr)
    assert all(len(r.tokens_out) == 10 and r.done for r in tr)
    tm, jm = teng.metrics(), jeng.metrics()
    for key in ("steps", "decode_tokens", "requests_finished", "requests_rejected"):
        assert tm[key] == jm[key], key


def test_chunked_admission_under_token_budget(models):
    """Prompts longer than a chunk, admitted a few tokens per step while
    other slots decode: same streams, same step count."""
    cfg = models[0]
    jeng, jr, teng, tr = _both(models, _prompts(cfg, [9, 3, 13, 6], seed=1), 6,
                               max_batch=2, max_len=24, prefill_chunk=4, token_budget=6)
    assert _streams(tr) == _streams(jr)
    assert teng.metrics()["steps"] == jeng.metrics()["steps"]


def test_oversized_and_empty_prompts_are_rejected(models):
    cfg = models[0]
    prompts = _prompts(cfg, [5, 16, 0, 20, 4], seed=2)   # max_len 16: 16 and 20 too long
    jeng, jr, teng, tr = _both(models, prompts, 4, max_batch=2, max_len=16,
                               prefill_chunk=8)
    assert _streams(tr) == _streams(jr)
    assert [len(r.tokens_out) for r in tr] == [4, 0, 0, 0, 4]
    assert all(r.done for r in tr)
    assert teng.metrics()["requests_rejected"] == jeng.metrics()["requests_rejected"] == 3


def test_eos_retires_like_jax(models):
    cfg = models[0]
    prompts = _prompts(cfg, [7, 7], seed=3)
    _, ref, _, _ = _both(models, prompts, 8, max_batch=2, max_len=24)
    eos = ref[0].tokens_out[2]
    jeng, jr, teng, tr = _both(models, prompts, 8, max_batch=2, max_len=24, eos_id=eos)
    assert _streams(tr) == _streams(jr)
    assert tr[0].tokens_out[-1] == eos and len(tr[0].tokens_out) <= 3


def test_idle_slot_position_runs_past_the_cache(models):
    """Slot 1 stays idle while slot 0 serves two requests in turn; its pos
    advances every decode step until it passes cache_len, and the clamped
    write keeps both the port and the streams intact."""
    cfg = models[0]
    prompts = _prompts(cfg, [4, 4, 5], seed=4)
    jeng, jr, teng, tr = _both(models, prompts, 11, waves=[[0], [1], [2]],
                               max_batch=2, max_len=16, prefill_chunk=8)
    assert _streams(tr) == _streams(jr)
    cache_len = teng.cache["layers"]["k"].shape[2]
    idle_pos = teng.cache["layers"]["pos"][:, 1]
    assert cache_len == 16 and bool((idle_pos > cache_len).all())
    np.testing.assert_array_equal(teng.cache["layers"]["pos"].numpy(),
                                  np.asarray(jeng.cache["layers"]["pos"]))


def test_context_limit_retires_before_the_cache_overflows(models):
    cfg = models[0]
    jeng, jr, teng, tr = _both(models, _prompts(cfg, [10, 12], seed=5), 50,
                               max_batch=2, max_len=16, prefill_chunk=8)
    assert _streams(tr) == _streams(jr)
    assert [len(r.prompt) + len(r.tokens_out) for r in tr] == [16, 16]


@pytest.mark.parametrize("fused", [True, False])
def test_mamba_greedy_streams_equal_jax_engine_over_two_waves(mamba_models, fused):
    """Mamba-2: chunked admission of ragged prompts (padded chunks), slot
    reuse by a second wave, the same greedy streams and step counts."""
    cfg = mamba_models[0]
    prompts = _prompts(cfg, [9, 14, 5, 11, 7], seed=6)
    jeng, jr, teng, tr = _both(mamba_models, prompts, 8, waves=[[0, 1, 2], [3, 4]],
                               fused=fused, max_batch=2, max_len=32, prefill_chunk=8)
    assert _streams(tr) == _streams(jr)
    assert all(len(r.tokens_out) == 8 and r.done for r in tr)
    tm, jm = teng.metrics(), jeng.metrics()
    for key in ("steps", "decode_tokens", "requests_finished", "requests_rejected"):
        assert tm[key] == jm[key], key
    np.testing.assert_array_equal(teng.cache["pos"].numpy(), np.asarray(jeng.cache["pos"]))


def test_mamba_has_no_context_limit(mamba_models):
    """A recurrent model holds O(1) state: a 30-token prompt at max_len 16 is
    admitted (no rejection) and runs to max_new past the limit, as in the
    reference."""
    cfg = mamba_models[0]
    jeng, jr, teng, tr = _both(mamba_models, _prompts(cfg, [30], seed=7), 5,
                               max_batch=1, max_len=16, prefill_chunk=8)
    assert tr[0].done and len(tr[0].tokens_out) == 5
    assert teng.metrics()["requests_rejected"] == 0
    assert _streams(tr) == _streams(jr)


@pytest.mark.parametrize("opt", [dict(mesh=object()), dict(batched=False)])
def test_unported_options_raise(models, opt):
    """A device mesh on the slot-wise loop raises ``ValueError``, as the
    reference's engine does (mesh serving itself is ported:
    tests/test_torch_distributed.py). ``batched=False``, once refused here
    too, is the slot-wise loop now: its streams equal the JAX slot-wise
    engine's and the port's batched engine's on the same prompts. (CREST,
    once a case here, is ported: tests/test_torch_crest.py.)"""
    cfg, jm, jp, tm, tp = models
    if "mesh" in opt:
        with pytest.raises(ValueError, match="mesh serving requires the batched"):
            tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(batched=False),
                                mesh=opt["mesh"], device="cpu")
        return
    prompts = _prompts(cfg, [7, 12, 9], seed=3)
    scfg = dict(max_batch=2, max_len=40, **opt)
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**scfg))
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**scfg), device="cpu")
    batched = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(max_batch=2, max_len=40),
                                  device="cpu")
    jr, tr, br = (_serve(e, mod, prompts, 8) for e, mod in
                  ((jeng, jengine), (teng, tengine), (batched, tengine)))
    assert teng.effective_mode == jeng.effective_mode == "slotwise-greedy"
    assert not teng.batched and teng.cache is None
    assert _streams(tr) == _streams(jr) == _streams(br)
    assert all(c is None for c in teng.caches)          # every retired slot let go
    for key in ("steps", "decode_tokens", "requests_finished"):
        assert teng.metrics()[key] == jeng.metrics()[key], key


def _musicgen_tokens(n_codebooks=4):
    """musicgen's smoke config fed tokens (``input_embeds=False``) with 4
    codebooks, as the full config has: the reference serves this variant
    slot-wise (its registry config, fed stub embeddings, it cannot serve)."""
    from repro.models.transformer import TransformerLM as JTransformerLM
    from repro_torch.models.transformer import TransformerLM as TTransformerLM
    cfg = dataclasses.replace(jregistry.get_config("musicgen-large", smoke=True),
                              input_embeds=False, n_codebooks=n_codebooks)
    jm = JTransformerLM(cfg)
    jp = jcascade.tree_to_serve_fp4(
        jm.init_params(jax.random.PRNGKey(0),
                       JCascadeConfig(mode="train", compute_dtype=jnp.float32)), J_FP4)
    tcfg = dataclasses.replace(registry.get_config("musicgen-large", smoke=True),
                               input_embeds=False, n_codebooks=n_codebooks)
    tm = TTransformerLM(tcfg)
    return cfg, jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_codebook0_stream(jm, jp, prompt, max_len, n):
    """A greedy stream of the JAX model picking codebook 0 at every step,
    admission included, as the port's slot-wise loop picks."""
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])}, J_FP4,
                               max_len=max_len)
    out = [int(jnp.argmax(logits[0, -1, 0]))]
    while len(out) < n:
        logits, cache = jm.decode_step(jp, {"tokens": jnp.asarray([[out[-1]]], jnp.int32)},
                                       cache, J_FP4)
        out.append(int(jnp.argmax(logits[0, -1, 0])))
    return out


def test_musicgen_token_input_variant_is_served_slotwise_as_in_jax():
    """The multi-codebook head downgrades to the slot-wise loop on both
    sides; the reference also downgrades fused, the port runs the loop
    through its kernels (plain versions on CPU tensors). A 4-D logits row
    picks codebook 0, at decode as in the reference and at admission too,
    where the reference's flat argmax over C * V ids can pass the
    vocabulary (a NaN embedding through ``jnp.take``). Every port stream
    equals the JAX model's greedy stream on codebook 0, and the JAX
    engine's but where its first id passes the vocabulary (here every
    request's: 77 of 32). On
    random smoke weights the streams prove little, so the decode logits of
    all 4 codebooks are held to JAX's too (atol/rtol 1e-4, f32)."""
    cfg, jm, jp, tm, tp = _musicgen_tokens()
    prompts = _prompts(cfg, [5, 9, 7])
    scfg = dict(max_batch=2, max_len=32, fused=True)
    with pytest.warns(RuntimeWarning, match="multi-codebook"):
        jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**scfg))
    with pytest.warns(RuntimeWarning, match="multi-codebook"):
        teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(**scfg), device="cpu")
    jr, tr = _serve(jeng, jengine, prompts, 6), _serve(teng, tengine, prompts, 6)
    assert jeng.effective_mode == "slotwise-greedy"
    assert teng.effective_mode == "slotwise-greedy-fused" and teng.fused
    assert [m.split(" -")[0] for m in teng.downgrades] \
        == [m.split(" —")[0] for m in jeng.downgrades if "fused" not in m]
    assert _streams(tr) == [_jax_codebook0_stream(jm, jp, p, 32, 6) for p in prompts]
    for t_toks, j_toks in zip(_streams(tr), _streams(jr)):
        assert t_toks == j_toks or j_toks[0] >= cfg.vocab
    assert all(len(r.tokens_out) == 6 for r in tr)
    toks = np.stack([p[:5] for p in prompts])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=8)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, T_FP4, max_len=8)
    nxt = toks[:, -1:]
    jl, _ = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
    tl, _ = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, tc, T_FP4)
    assert tl.shape == (3, 1, 4, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_slotwise_downgrades_warn_once_and_show_in_metrics():
    """As the reference's test_spec.py case: on a slot-wise engine
    speculation and pages each downgrade with one warning, listed in
    metrics()["downgrades"]; fused kernels do not (the loop runs them); a
    fully served config lists none."""
    cfg, _, _, tm, tp = _musicgen_tokens(n_codebooks=2)
    with pytest.warns(RuntimeWarning, match="multi-codebook"):
        eng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(max_batch=2, max_len=64),
                                  device="cpu")
    assert not eng.batched and eng.effective_mode == "slotwise-greedy"
    assert len(eng.metrics()["downgrades"]) == 1
    with pytest.warns(RuntimeWarning, match="speculative"):
        eng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
            max_batch=2, max_len=64, draft_len=4), device="cpu")
    assert not eng.spec and eng.effective_mode == "slotwise-greedy"
    assert len(eng.metrics()["downgrades"]) == 2
    with pytest.warns(RuntimeWarning) as rec:
        eng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
            max_batch=2, max_len=64, draft_len=4, fused=True, paged=True), device="cpu")
    msgs = eng.metrics()["downgrades"]
    assert len(rec) == len(msgs) == 3
    assert [any(k in m for m in msgs) for k in ("multi-codebook", "speculat", "fused", "paged")] \
        == [True, True, False, True]
    assert eng.effective_mode == "slotwise-greedy-fused" and eng.fused and not eng.paged
    assert eng.ccfg.use_kernel
    _, _, _, tm2, tp2 = _codeqwen_models_for_modes()
    eng2 = tengine.ServeEngine(tm2, tp2, T_FP4, tengine.ServeConfig(max_batch=2, max_len=64,
                                                                    draft_len=2), device="cpu")
    assert eng2.spec and eng2.effective_mode == "spec-greedy"
    assert not eng2.metrics()["downgrades"]


def _codeqwen_models_for_modes():
    cfg, tm = registry.load("codeqwen1.5-7b", smoke=True)
    return cfg, None, None, tm, tm.init_params(0, T_FP4, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_stub_embedding_configs_are_refused_at_construction(arch):
    """The engine takes token prompts; a model fed stub embeddings is
    refused when the engine is built (the reference's engine fails later,
    with a KeyError at its first prefill)."""
    _, tm = registry.load(arch, smoke=True)
    tp = tm.init_params(0, T_FP4, device="cpu")
    with pytest.raises(ValueError, match="token prompts"):
        tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(), device="cpu")


def test_fused_without_fp4_params_downgrades(models):
    _, _, _, tm, _ = models
    ccfg = CascadeConfig(mode="train", compute_dtype=torch.float32)
    params = tm.init_params(0, ccfg, device="cpu")
    with pytest.warns(RuntimeWarning, match="fused decode requested"):
        eng = tengine.ServeEngine(tm, params, ccfg, tengine.ServeConfig(fused=True),
                                  device="cpu")
    assert not eng.fused and eng.effective_mode == "batched-greedy"
