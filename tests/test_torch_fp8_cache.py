"""An FP8 (e4m3) KV cache, ``CascadeConfig(kv_dtype=float8_e4m3fn)``, against
the JAX package's with ``kv_dtype=jnp.float8_e4m3fn``, on the CPU.

The reference serves such a cache (``tests/test_engine.py`` plumbs it, its
roofline's decode preset uses it): both Pallas attention kernels cast K/V
to f32 inside their bodies. The port's plain versions upcast the same way,
and its CUDA kernels convert the codes as they stage them (held bit for
bit to themselves on the cache upcast to bf16 in ``test_torch_gpu.py``).

* the dense model (codeqwen1.5-7b), Griffin's ring (recurrentgemma-2b) and
  MLA's latent cache (deepseek-v2-236b), smoke size, FP4 weights, f32
  compute: prefill, an extend chunk, two decode steps and a verify chunk
  give logits within ``TOL`` of the reference's, and every cache leaf the
  reference's codes (both sides round the same f32 rows to e4m3; a row
  whose f32 value differs in its last bits may round to the neighbouring
  code, so at most ``FLIPS`` of the codes may differ, each by one step);
* the engine's greedy streams equal the JAX engine's on the smoke dense
  config with the FP8 cache;
* the cache is stored in one byte a value.
"""
import functools

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

TOL = dict(atol=1e-4, rtol=1e-4)
FLIPS = 1e-3          # the share of cache codes that may differ by one e4m3 step
J_CFG = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32, kv_dtype=jnp.float8_e4m3fn)
T_CFG = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32,
                      kv_dtype=torch.float8_e4m3fn)
ARCHS = ["codeqwen1.5-7b", "recurrentgemma-2b", "deepseek-v2-236b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, jm = jregistry.load(request.param, smoke=True)
    # the reference's steps jitted: its eager op-by-op dispatch costs several times more
    init = jax.jit(lambda key: jcascade.tree_to_serve_fp4(jm.init_params(
        key, JCascadeConfig(mode="train", compute_dtype=jnp.float32)), J_CFG))
    jp = init(jax.random.PRNGKey(0))
    _, tm = registry.load(request.param, smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, dtype=np.float32), **TOL)


def _fp8_leaves(tc, jc, path=()):
    """(path, port leaf, reference leaf) of every float8 leaf of the caches."""
    if isinstance(tc, dict):
        for k in tc:
            yield from _fp8_leaves(tc[k], jc[k], path + (k,))
    elif isinstance(tc, torch.Tensor) and tc.dtype == torch.float8_e4m3fn:
        yield path, tc, jc


def _port_layout(tm, jc):
    """The reference's cache in the port's layout: Griffin's ({groups: {b0,
    b1, b2} stacked by group, tail: [...]}) as {layers: R blocks, attn: A
    blocks}; MLA's ({dense_layers: [...], layers: stacked}) with the dense
    layers' leaves stacked in front; the others' as they are."""
    if "dense_layers" in jc:
        lay = {k: np.asarray(v) for k, v in jc["layers"].items()}
        dense = [{k: np.asarray(v) for k, v in d.items()} for d in jc["dense_layers"]]
        return {"layers": {k: np.concatenate([np.stack([d[k] for d in dense]), v])
                           if dense else v for k, v in lay.items()}}
    if "groups" not in jc:
        return jc
    rec, att = [], []
    for g in range(tm.n_groups):
        for i, kind in enumerate(tm.group):
            leaf = jax.tree.map(lambda a: np.asarray(a)[g], jc["groups"][f"b{i}"])
            (rec if kind == "R" else att).append(leaf)
    rec += [jax.tree.map(np.asarray, c) for c in jc["tail"]]
    stack = lambda trees: {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return {"layers": stack(rec), "attn": stack(att)}


def _same_codes(tm, tc, jc):
    leaves = list(_fp8_leaves(tc, _port_layout(tm, jc)))
    assert leaves, "the cache holds no float8 leaf"
    for path, t, j in leaves:
        got = t.view(torch.uint8).numpy().astype(np.int32)
        want = np.asarray(j).view(np.uint8).astype(np.int32)
        assert got.shape == want.shape, path
        diff = got != want
        assert diff.mean() <= FLIPS, (path, int(diff.sum()), diff.size)
        # a flip is the neighbouring code of one sign (|code step| 1)
        assert np.all(np.abs(got - want)[diff] == 1), path


def test_prefill_extend_decode_and_verify_match_the_reference(pair):
    cfg, jm, jp, tm, tp = pair
    step = lambda fn, **kw: jax.jit(functools.partial(fn, ccfg=J_CFG, **kw))
    toks = _tokens(cfg, 2, 6, 0)
    jl, jc = step(jm.prefill, max_len=24)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, T_CFG, max_len=24)
        _close(tl, jl)
        _same_codes(tm, tc, jc)
        chunk = _tokens(cfg, 2, 4, 1)
        jl, jc = step(jm.prefill_extend)(jp, {"tokens": jnp.asarray(chunk)}, jc,
                                         n_valid=jnp.int32(3))
        tl, tc = tm.prefill_extend(tp, {"tokens": torch.from_numpy(chunk)}, tc, T_CFG,
                                   n_valid=3)
        _close(tl, jl)
        _same_codes(tm, tc, jc)
        for _ in range(2):
            nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
            jl, jc = step(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt)}, jc)
            tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, tc, T_CFG)
            _close(tl, jl)
            _same_codes(tm, tc, jc)
        draft = _tokens(cfg, 2, 3, 2)
        jout = step(jm.spec_verify)(jp, {"tokens": jnp.asarray(draft)}, jc)
        tout = tm.spec_verify(tp, {"tokens": torch.from_numpy(draft)}, tc, T_CFG)
        _close(tout[0], jout[0])
        _same_codes(tm, tout[1], jout[1])


def test_the_cache_holds_one_byte_a_value(pair):
    """Every K/V (or latent) leaf of the FP8 cache takes half the bf16 cache's bytes."""
    tm = pair[3]
    kv8 = [t for _, t in _walk(tm.init_cache(2, 16, dtype=torch.float8_e4m3fn, device="cpu"))
           if t.dtype == torch.float8_e4m3fn]
    kv16 = [t for _, t in _walk(tm.init_cache(2, 16, dtype=torch.bfloat16, device="cpu"))
            if t.dtype == torch.bfloat16]
    assert kv8 and len(kv8) == len(kv16)
    assert 2 * sum(t.numel() for t in kv8) == sum(t.numel() * t.element_size() for t in kv16)


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}")
    else:
        yield path, tree


def test_engine_greedy_streams_equal_the_reference_with_an_fp8_cache():
    cfg, jm = jregistry.load("codeqwen1.5-7b", smoke=True)
    jp = jcascade.tree_to_serve_fp4(
        jm.init_params(jax.random.PRNGKey(0),
                       JCascadeConfig(mode="train", compute_dtype=jnp.float32)), J_CFG)
    _, tm = registry.load("codeqwen1.5-7b", smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 4, 12)]
    streams = []
    for mod, eng in ((jengine, jengine.ServeEngine(jm, jp, J_CFG, jengine.ServeConfig(
            fused=True, max_batch=2, max_len=40, prefill_chunk=4))),
                     (tengine, tengine.ServeEngine(tm, tp, T_CFG, tengine.ServeConfig(
                         fused=True, max_batch=2, max_len=40, prefill_chunk=4),
                         device="cpu"))):
        reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        streams.append([list(r.tokens_out) for r in reqs])
    assert streams[1] == streams[0]
    assert all(len(s) == 8 for s in streams[1])
