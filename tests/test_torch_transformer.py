"""The port's TransformerLM against the JAX TransformerLM on the same weights.

Weights are the reference's own params, carried across leaf by leaf
through ``convert.params_from_numpy``. Logits and caches agree at
atol/rtol 1e-4 in f32: RoPE, softmax and matmul sums run in another order
on the two sides.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import cache_utils as jcache
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch.convert import params_from_numpy
from repro_torch.core import cascade as tcascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import cache_utils as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
T_TRAIN = CascadeConfig(mode="train", compute_dtype=torch.float32)


def _pair(arch, fp4=True):
    cfg, jm = jregistry.load(arch, smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0), J_TRAIN)
    if fp4:
        jp = jcascade.tree_to_serve_fp4(jp, J_FP4)
    _, tm = registry.load(arch, smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _close_cache(tc, jc):
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])
    np.testing.assert_array_equal(tc["layers"]["pos"].numpy(), np.asarray(jc["layers"]["pos"]))


@pytest.fixture(scope="module")
def codeqwen():
    return _pair("codeqwen1.5-7b")


def test_param_tree_carries_across_leaf_by_leaf(codeqwen):
    _, _, jp, _, tp = codeqwen
    jl = jax.tree_util.tree_leaves_with_path(jp)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jl}
    assert "['layers']['attn']['wq']['codes']" in flat
    assert "['layers']['attn']['wq']['b']" in flat

    def walk(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{path}['{k}']")
        else:
            yield path, node

    tflat = dict(walk(tp))
    assert tflat.keys() == flat.keys()
    for k, a in flat.items():
        assert str(tflat[k].dtype).endswith(str(a.dtype)), k
        np.testing.assert_array_equal(tflat[k].numpy(), a)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "qwen2.5-32b", "phi4-mini-3.8b",
                                  "nemotron-4-15b"])
@pytest.mark.parametrize("fp4", [True, False])
def test_forward_logits_match(arch, fp4):
    cfg, jm, jp, tm, tp = _pair(arch, fp4)
    toks = _tokens(cfg, 2, 9)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)}, J_FP4 if fp4 else J_TRAIN)
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, T_FP4 if fp4 else T_TRAIN)
    assert got.shape == (2, 9, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_and_decode_match(codeqwen):
    cfg, jm, jp, tm, tp = codeqwen
    toks = _tokens(cfg, 2, 7)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=16)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, T_FP4, max_len=16)
        _close(tl, jl)
        _close_cache(tc, jc)
        for step in range(3):
            nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
            jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
            tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, tc, T_FP4)
            _close(tl, jl)
            _close_cache(tc, jc)


@pytest.mark.parametrize("all_logits", [False, True])
def test_prefill_extend_with_padded_chunk_matches(codeqwen, all_logits):
    cfg, jm, jp, tm, tp = codeqwen
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for i, nv in enumerate((5, 3)):            # the second chunk is padded: 3 of 5
            toks = _tokens(cfg, 2, 5, seed=i)
            jl, jc = jm.prefill_extend(jp, {"tokens": jnp.asarray(toks)}, jc, J_FP4,
                                       n_valid=jnp.int32(nv), all_logits=all_logits)
            tl, tc = tm.prefill_extend(tp, {"tokens": torch.from_numpy(toks)}, tc, T_FP4,
                                       n_valid=nv, all_logits=all_logits)
            assert tl.shape == (2, 5 if all_logits else 1, cfg.vocab)
            _close(tl, jl)
            _close_cache(tc, jc)
    assert tc["layers"]["pos"].tolist() == [[8, 8], [8, 8]]


def test_decode_with_positions_past_the_cache_clamps_like_jax(codeqwen):
    """An idle slot's pos keeps advancing; past T the reference's
    dynamic_update_slice clamps the write to the last row, and so must the
    port (a plain index there would fault)."""
    cfg, jm, jp, tm, tp = codeqwen
    jc = jm.init_cache(3, 8, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    for name in ("k", "v"):
        jc["layers"][name] = jnp.asarray(
            rng.standard_normal(jc["layers"][name].shape).astype(np.float32))
    jc["layers"]["pos"] = jnp.asarray(np.array([[2, 8, 13]] * cfg.n_layers, np.int32))
    tc = params_from_numpy(_np_tree(jc), device="cpu")
    toks = _tokens(cfg, 3, 1)
    jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks)}, jc, J_FP4)
    with torch.no_grad():
        tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(toks)}, tc, T_FP4)
    _close(tl, jl)
    _close_cache(tc, jc)
    assert tc["layers"]["pos"][0].tolist() == [3, 9, 14]


def test_update_rows_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((4, 6, 2)).astype(np.float32)
    new = rng.standard_normal((4, 3, 2)).astype(np.float32)
    idx = np.array([0, 2, 5, 40], np.int32)
    want = jlayers.update_rows(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(idx))
    got = torch.from_numpy(buf.copy())
    tlayers.update_rows(got, torch.from_numpy(new), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_valid", [3, 1, 9, [2, 5, 1]])
def test_take_last_valid_matches_jax(n_valid):
    x = np.random.default_rng(1).standard_normal((3, 5, 4)).astype(np.float32)
    want = jcache.take_last_valid(jnp.asarray(x), jnp.asarray(n_valid, jnp.int32))
    nv = torch.tensor(n_valid) if isinstance(n_valid, list) else n_valid
    got = tcache.take_last_valid(torch.from_numpy(x), nv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_kinds_match(kind):
    jp = jlayers.mlp_init(jax.random.PRNGKey(1), 16, 24, kind, J_TRAIN)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 3, 16)).astype(np.float32)
    want = jlayers.mlp_apply(jp, jnp.asarray(x), kind, J_TRAIN)
    _close(tlayers.mlp_apply(tp, torch.from_numpy(x), kind, T_TRAIN), want)


def test_sinusoidal_positions_match():
    want = jlayers.sinusoidal_positions(7, 12, offset=3).astype(jnp.float32)
    got = tlayers.sinusoidal_positions(7, 12, offset=3, device="cpu").to(torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)   # bf16 output


def test_tree_to_serve_fp4_and_weight_bytes_match_reference():
    cfg, jm = jregistry.load("codeqwen1.5-7b", smoke=True)
    jdense = jm.init_params(jax.random.PRNGKey(0), J_TRAIN)
    jfp4 = jcascade.tree_to_serve_fp4(jdense, J_FP4)
    tfp4 = tcascade.tree_to_serve_fp4(params_from_numpy(_np_tree(jdense), device="cpu"), T_FP4)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jfp4):
        node = tfp4
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tcascade.num_weight_bytes(tfp4) == jcascade.num_weight_bytes(jfp4)


def test_cache_at_and_write_cache_address_the_slot_axis(codeqwen):
    _, _, _, tm, _ = codeqwen
    grid = tm.init_cache(3, 8, dtype=torch.float32, device="cpu")
    sub = tm.init_cache(1, 8, dtype=torch.float32, device="cpu")
    for name, leaf in sub["layers"].items():
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape).to(leaf.dtype) + 1)
    tm.write_cache(grid, sub, 1)
    view = tcache.cache_at(grid, 1)
    for name in ("k", "v", "pos"):
        assert torch.equal(view["layers"][name], sub["layers"][name])
        assert not grid["layers"][name][:, 0].any() and not grid["layers"][name][:, 2].any()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-v2-236b",
                                  "musicgen-large", "qwen2-vl-2b"])
def test_registry_names_the_roadmap_item_for_unported_families(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.load(arch, smoke=True)


def test_registry_builds_mamba2_whose_cache_has_the_stated_slot_axes():
    """The ssm family builds a Mamba2LM; every leaf of its cache carries the
    slot axis ``cache_utils`` states (``LAYER_SLOT_AXIS`` under ``layers``,
    ``TOP_SLOT_AXIS`` for ``pos`` beside it): the only axis that changes with
    the batch, and what ``cache_at``/``write_cache`` address."""
    from repro_torch.models.ssm import Mamba2LM
    cfg, model = registry.load("mamba2-370m", smoke=True)
    assert isinstance(model, Mamba2LM) and model.unbounded_context
    small = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
    big = model.init_cache(3, 8, dtype=torch.float32, device="cpu")
    assert set(big) == {"layers", "pos"} and set(big["layers"]) == {"conv", "state"}
    flat = [(("layers", "conv"), tcache.LAYER_SLOT_AXIS),
            (("layers", "state"), tcache.LAYER_SLOT_AXIS), (("pos",), tcache.TOP_SLOT_AXIS)]
    for path, ax in flat:
        a, b = small, big
        for key in path:
            a, b = a[key], b[key]
        assert [i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n] == [ax], path
    sub = model.init_cache(1, 8, dtype=torch.float32, device="cpu")
    for leaf in (*sub["layers"].values(), sub["pos"]):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape).to(leaf.dtype) + 1)
    model.write_cache(big, sub, 1)
    view = tcache.cache_at(big, 1)
    for name in ("conv", "state"):
        assert torch.equal(view["layers"][name], sub["layers"][name])
        assert not big["layers"][name][:, 0].any() and not big["layers"][name][:, 2].any()
    assert big["pos"].tolist() == [0, 1, 0] and torch.equal(view["pos"], sub["pos"])


def test_configs_match_reference_field_for_field():
    for arch in jregistry.ALIASES:
        for smoke in (False, True):
            j = jregistry.get_config(arch, smoke)
            t = registry.get_config(arch, smoke)
            assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
                   {f: getattr(j, f) for f in j.__dataclass_fields__}
    assert registry.FAMILY_SMOKE == jregistry.FAMILY_SMOKE
    assert registry.ALIASES == jregistry.ALIASES
