"""The port's serving engine on the MoE family against the JAX package's.

Greedy streams of the port's engine equal the JAX engine's token for token,
at f32 on the reference's FP4 weights carried across by
``convert.params_from_numpy`` (its ``dense_layers`` list included), at the
two MoE smoke sizes: deepseek-v2 (``FAMILY_SMOKE["moe"]``: MLA, a dense
first layer, a shared expert, capacity factor 2.0) and olmoe (MHA, 8
experts top-2). The port's engine runs its kernel routes (``fused=True``:
the grouped expert matmul and the other kernels' plain versions on the CPU);
the reference's fused path is bit-identical to its plain one, so it runs
plain. Runs: batched over two waves of admission; paged with prefix hits,
a copy-on-write and evictions (the same hits, lookups and evictions as the
JAX paged engine); speculative greedy (equal to the JAX speculative engine
and to plain greedy); and the reference's capacity-pressure case, 12 slots
of 8-token prompts, where drop-free dispatch keeps batched decode exact.
"""
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
from repro_torch.models.moe import MoELM
from repro_torch.serve import engine as tengine

jax.config.update("jax_platform_name", "cpu")

J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
ARCHS = ["deepseek-v2-236b", "olmoe-1b-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """An MoE smoke model's FP4 params drawn by the reference and carried
    across leaf by leaf."""
    cfg, jm = jregistry.load(request.param, smoke=True)
    jp = jax.jit(lambda k: jcascade.tree_to_serve_fp4(jm.init_params(k, J_TRAIN), J_FP4))(
        jax.random.PRNGKey(0))
    _, tm = registry.load(request.param, smoke=True)
    assert isinstance(tm, MoELM)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _prompts(vocab, lens, seed=0):
    """Half repetitive (a short pattern tiled, so drafts get accepted), half
    random."""
    rng = np.random.default_rng(seed)
    return [np.resize(rng.integers(0, vocab, 3), n).astype(np.int32) if i % 2 == 0
            else rng.integers(0, vocab, n).astype(np.int32) for i, n in enumerate(lens)]


def _serve(mod, eng, prompts, max_new):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.tokens_out) for r in reqs]


def _both(models, prompts, max_new, **scfg):
    """Streams of the JAX engine (plain) and the port's (kernel routes), and
    both engines."""
    cfg, jm, jp, tm, tp = models
    jeng = jengine.ServeEngine(jm, jp, J_FP4, jengine.ServeConfig(**scfg))
    teng = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(fused=True, **scfg),
                               device="cpu")
    return _serve(jengine, jeng, prompts, max_new), _serve(tengine, teng, prompts, max_new), \
        jeng, teng


def test_batched_greedy_streams_equal_jax_over_two_waves(models):
    cfg = models[0]
    js, ts, jeng, teng = _both(models, _prompts(cfg.vocab, [12, 9, 15, 6, 11]), 6,
                               max_batch=2, max_len=48, prefill_chunk=8)
    assert ts == js
    assert teng.effective_mode == "batched-greedy-fused"
    for key in ("steps", "decode_tokens", "requests_finished"):
        assert teng.metrics()[key] == jeng.metrics()[key], key


def test_capacity_pressure_twelve_slots_equal_jax(models):
    """The reference's ``test_moe_parity_under_expert_capacity_pressure``:
    12 slots of 8-token prompts through few experts, chunk 8."""
    cfg = models[0]
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab, 8).astype(np.int32)
               for i in range(12)]
    js, ts, _, _ = _both(models, prompts, 6, max_batch=12, max_len=64, prefill_chunk=8)
    assert ts == js


def _shared_prompts(vocab):
    """Three prompts sharing 20 tokens (2.5 pages of 8: two full pages and a
    copy-on-write tail), and two distinct ones that force evictions in a
    small pool."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, vocab, 20).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(0, vocab, 5).astype(np.int32)])
           for _ in range(3)]
    return out + [rng.integers(0, vocab, 22).astype(np.int32) for _ in range(2)]


@pytest.mark.parametrize("draft_len", [0, 3])
def test_paged_prefix_cache_streams_and_hits_equal_jax(models, draft_len):
    """The paged engine with the radix prefix cache, in a pool small enough
    to evict: the JAX paged engine's streams, prefix hits, lookups and
    evictions; greedy plain and speculative."""
    cfg = models[0]
    scfg = dict(max_batch=2, max_len=40, prefill_chunk=8, page_size=8, prefix_cache=True,
                num_pages=12, draft_len=draft_len)
    js, ts, jeng, teng = _both(models, _shared_prompts(cfg.vocab), 6, **scfg)
    assert ts == js
    assert teng.paged and not teng.downgrades
    tm_, jm_ = teng.metrics(), jeng.metrics()
    for key in ("prefix_hits", "prefix_lookups", "evictions", "pages_total", "steps",
                "decode_tokens", "draft_tokens_accepted"):
        assert tm_[key] == jm_[key], key
    assert tm_["prefix_hits"] > 16 and tm_["evictions"] > 0


def test_spec_greedy_streams_equal_jax_spec_and_plain_greedy(models):
    cfg, jm, jp, tm, tp = models
    scfg = dict(max_batch=2, max_len=40, prefill_chunk=8, draft_len=3)
    prompts = _prompts(cfg.vocab, [12, 9, 15, 6])
    js, ts, jeng, teng = _both(models, prompts, 8, **scfg)
    plain = tengine.ServeEngine(tm, tp, T_FP4, tengine.ServeConfig(
        fused=True, **dict(scfg, draft_len=0)), device="cpu")
    assert ts == js == _serve(tengine, plain, prompts, 8)
    assert teng.effective_mode == "spec-greedy-fused"
    for key in ("steps", "draft_tokens_accepted", "accepted_per_step"):
        assert teng.metrics()[key] == jeng.metrics()[key], key
    assert teng.metrics()["draft_tokens_accepted"] > 0
