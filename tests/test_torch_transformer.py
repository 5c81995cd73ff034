"""The port's TransformerLM against the JAX TransformerLM on the same weights.

Weights are the reference's own params, carried across leaf by leaf
through ``convert.params_from_numpy``. Logits and caches agree at
atol/rtol 1e-4 in f32: RoPE, softmax and matmul sums run in another order
on the two sides.
"""
import dataclasses

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


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "qwen2.5-32b"])
def test_decode_kernel_route_gives_the_mask_route_logits_bit_for_bit(arch, monkeypatch):
    """The decode step's kernel route hands ``ops.decode_attention`` the
    rows' positions (``q_pos``) and builds no mask; on CPU tensors its logits
    are bit-equal to the route it replaced, which built the (B, T) mask
    ``arange(T) <= pos`` for every layer and passed that, at positions
    inside the cache and past it (MHA and GQA), and within 1e-4 of JAX."""
    cfg, jm, jp, tm, tp = _pair(arch)
    jc = jm.init_cache(3, 8, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    for name in ("k", "v"):
        jc["layers"][name] = jnp.asarray(
            rng.standard_normal(jc["layers"][name].shape).astype(np.float32))
    jc["layers"]["pos"] = jnp.asarray(np.array([[0, 5, 11]] * cfg.n_layers, np.int32))
    toks = _tokens(cfg, 3, 1, seed=2)
    kcfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32, use_kernel=True)
    from repro_torch.kernels import ops as tops
    routes, seen = {}, []
    with torch.no_grad():
        for route in ("q_pos", "mask"):
            if route == "mask":
                new_route = tops.decode_attention

                def mask_route(q, k, v, valid=None, *, scale=None, q_pos=None):
                    assert valid is None and q_pos is not None
                    rows = q_pos[:, None] + torch.arange(1, dtype=torch.int32)[None, :]
                    valid = torch.arange(k.shape[1])[None, None, :] <= rows[:, :, None]
                    seen.append(q_pos.tolist())
                    return new_route(q, k, v, valid[:, 0], scale=scale)
                monkeypatch.setattr(tops, "decode_attention", mask_route)
            tc = params_from_numpy(_np_tree(jc), device="cpu")
            routes[route], _ = tm.decode_step(tp, {"tokens": torch.from_numpy(toks)}, tc, kcfg)
    assert seen == [[0, 5, 11]] * cfg.n_layers
    assert torch.equal(routes["q_pos"], routes["mask"])
    jl, _ = jm.decode_step(jp, {"tokens": jnp.asarray(toks)}, jc, J_FP4)
    _close(routes["q_pos"], jl)


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


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "musicgen-large", "qwen2-vl-2b"])
def test_registry_names_the_roadmap_item_for_unported_families(arch):
    """Every family once refused here, naming its ROADMAP item, builds now:
    the hybrid family (recurrentgemma-2b) a GriffinLM, the audio and VLM
    families (musicgen-large, qwen2-vl-2b) a TransformerLM fed stub
    embeddings, at smoke size and at full size."""
    from repro_torch.models.transformer import TransformerLM
    if arch == "recurrentgemma-2b":
        from repro_torch.models.griffin import GriffinLM
        assert isinstance(registry.load(arch, smoke=True)[1], GriffinLM)
        return
    for smoke in (True, False):
        cfg, model = registry.load(arch, smoke=smoke)
        assert type(model) is TransformerLM and cfg.input_embeds
        assert model.attn_cfg.mrope_sections == cfg.mrope_sections


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


# ---------------------------------------------------------------------------
# the flash-attention route and speculative verify/rewind
# ---------------------------------------------------------------------------

def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


@pytest.mark.parametrize("mode", ["full", "prefill", "extend", "decode"])
def test_attn_apply_kernel_route_equals_plain_on_cpu(mode):
    """``use_kernel`` sends decode attention to ``ops.decode_attention`` and
    every multi-token attention to ``ops.flash_attention``; on CPU tensors
    their plain versions give the plain path's result (the same f32 sums
    grouped otherwise: atol/rtol 1e-5), per-row cache positions included."""
    cfg = tlayers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
    gen = torch.Generator().manual_seed(0)
    params = tlayers.attn_init(gen, cfg, T_TRAIN, device="cpu")
    s = 1 if mode == "decode" else 5
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, s, 32)).astype(np.float32))
    cache = None
    if mode in ("extend", "decode"):
        kv = rng.standard_normal((2, 3, 16, 2, 8)).astype(np.float32)
        cache = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1]),
                 "pos": torch.tensor([0, 5, 9], dtype=torch.int32)}
    outs = []
    for use_kernel in (False, True):
        ccfg = CascadeConfig(mode="train", compute_dtype=torch.float32, use_kernel=use_kernel)
        outs.append(tlayers.attn_apply(params, x, cfg, ccfg, None if cache is None else
                                       _copy(cache), mode=mode, max_len=8))
    (plain, pc), (kern, kc) = outs
    torch.testing.assert_close(kern, plain, atol=1e-5, rtol=1e-5)
    if pc is not None:
        for name in pc:
            torch.testing.assert_close(kc[name], pc[name], atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 5])
def test_extend_over_the_live_prefix_equals_the_whole_cache(s):
    """``kv_len`` = the largest row position plus s hands the flash route only
    the cache's live prefix: the same outputs as over the whole cache (the
    cut keys are masked; atol/rtol 1e-6, softmax sums over fewer zeros) and
    the same cache; a bound past T reads the whole cache."""
    cfg = tlayers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
    params = tlayers.attn_init(torch.Generator().manual_seed(4), cfg, T_TRAIN, device="cpu")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, s, 32)).astype(np.float32))
    kv = rng.standard_normal((2, 3, 40, 2, 8)).astype(np.float32)
    cache = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1]),
             "pos": torch.tensor([0, 7, 13], dtype=torch.int32)}
    kcfg = CascadeConfig(mode="train", compute_dtype=torch.float32, use_kernel=True)
    want, wc = tlayers.attn_apply(params, x, cfg, kcfg, _copy(cache), mode="extend")
    for live in (13 + s, 64):
        got, gc = tlayers.attn_apply(params, x, cfg, kcfg, _copy(cache), mode="extend",
                                     kv_len=live)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        for name in wc:
            torch.testing.assert_close(gc[name], wc[name], atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 5])
def test_extend_attention_through_the_kernel_route_matches_jax_extend(s):
    """One attention layer in mode ``extend`` at per-row cache positions
    (one past T - s, whose write is clamped): the port's flash route against
    the reference's jnp extend attention, on the same weights and cache."""
    jcfg = jlayers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
    jp = jlayers.attn_init(jax.random.PRNGKey(3), jcfg, J_TRAIN)
    tcfg = tlayers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, s, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 4, 16, 2, 8)).astype(np.float32)
    pos = np.array([0, 5, 11, 16 - s + 1], np.int32)
    jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()),
          "pos": torch.from_numpy(pos.copy())}
    want, wc = jlayers.attn_apply(jp, jnp.asarray(x), jcfg, J_TRAIN, cache=jc, mode="extend")
    kcfg = CascadeConfig(mode="train", compute_dtype=torch.float32, use_kernel=True)
    got, gc = tlayers.attn_apply(tp, torch.from_numpy(x), tcfg, kcfg, cache=tc, mode="extend")
    _close(got, want)
    for name in ("k", "v"):
        _close(gc[name], wc[name])
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


def test_forward_and_prefill_through_the_kernel_route_match_jax(codeqwen):
    cfg, jm, jp, tm, tp = codeqwen
    kcfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32, use_kernel=True)
    toks = _tokens(cfg, 2, 9, seed=5)
    with torch.no_grad():
        _close(tm.forward(tp, {"tokens": torch.from_numpy(toks)}, kcfg),
               jm.forward(jp, {"tokens": jnp.asarray(toks)}, J_FP4))
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, kcfg, max_len=16)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=16)
    _close(tl, jl)
    _close_cache(tc, jc)


def _slotted(cfg, jm, jp, tm, tp, lens, t=32):
    """JAX and port grids whose slots hold prompts of different lengths
    (rows at different positions)."""
    jc = jm.init_cache(len(lens), t, dtype=jnp.float32)
    tc = tm.init_cache(len(lens), t, dtype=torch.float32, device="cpu")
    for i, n in enumerate(lens):
        toks = _tokens(cfg, 1, n, seed=10 + i)
        _, jsub = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=t)
        jc = jm.write_cache(jc, jsub, i)
        with torch.no_grad():
            _, tsub = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, T_FP4, max_len=t)
        tm.write_cache(tc, tsub, i)
    return jc, tc


@pytest.mark.parametrize("use_kernel", [False, True])
def test_spec_verify_and_rewind_match_jax(codeqwen, use_kernel):
    """The verify pass (an all-logits extend at each slot's position, through
    the flash route with ``use_kernel``): logits, advanced cache and the row
    snapshot; then per-slot rewinds, a full one (keep = 0) included."""
    cfg, jm, jp, tm, tp = codeqwen
    jc, tc = _slotted(cfg, jm, jp, tm, tp, [5, 8, 3])
    chunk = _tokens(cfg, 3, 4, seed=7)
    tcc = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32, use_kernel=use_kernel)
    jl, jc2, jck = jm.spec_verify(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4)
    with torch.no_grad():
        tl, tc2, tck = tm.spec_verify(tp, {"tokens": torch.from_numpy(chunk)}, tc, tcc)
    assert tc2 is tc and tl.shape == (3, 4, cfg.vocab)
    _close(tl, jl)
    _close_cache(tc2, jc2)
    _close_cache(tck, jck)
    for keep in ([0, 2, 4], [1, 0, 3]):
        jr = jm.spec_rewind(jc2, jck, jnp.asarray(keep, jnp.int32))
        tr = tm.spec_rewind(_copy(tc2), tck, torch.tensor(keep))
        _close_cache(tr, jr)


def test_full_rewind_restores_the_cache_bit_exactly(codeqwen):
    cfg, jm, jp, tm, tp = codeqwen
    _, tc = _slotted(cfg, jm, jp, tm, tp, [5, 8, 3])
    before = _copy(tc)
    chunk = torch.from_numpy(_tokens(cfg, 3, 4, seed=8))
    with torch.no_grad():
        _, after, ckpt = tm.spec_verify(tp, {"tokens": chunk}, tc, T_FP4)
        # a checkpoint passed back in is refilled, not reallocated
        _, after, ckpt2 = tm.spec_verify(tp, {"tokens": chunk}, tm.spec_rewind(
            after, ckpt, torch.zeros(3, dtype=torch.int64)), T_FP4, ckpt=ckpt)
    assert ckpt2["layers"]["k"] is ckpt["layers"]["k"]
    rewound = tm.spec_rewind(after, ckpt2, torch.zeros(3, dtype=torch.int64))
    for name in ("k", "v", "pos"):
        assert torch.equal(rewound["layers"][name], before["layers"][name]), name


def test_seq_rows_primitives_match_jax():
    """Snapshot (rows clamped at the cache end), in-place restore and the
    per-slot row slice, on (L, B, T, ...) stacks, equal to the reference's."""
    rng = np.random.default_rng(4)
    kv = rng.standard_normal((2, 2, 3, 10, 2, 4)).astype(np.float32)
    pos = np.array([[1, 6, 9], [0, 4, 7]], np.int32)
    jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()),
          "pos": torch.from_numpy(pos.copy())}
    jsnap = jcache.seq_rows_snapshot(jc, 3)
    tsnap = tcache.seq_rows_snapshot(tc, 3)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(tsnap[name].numpy(), np.asarray(jsnap[name]))
    # restore after a "verify" rewrote every row, at positions with headroom
    pos = np.array([[1, 6, 7], [0, 4, 7]], np.int32)
    jc["pos"], tc["pos"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
    jsnap, tsnap = jcache.seq_rows_snapshot(jc, 3), tcache.seq_rows_snapshot(tc, 3)
    new = rng.standard_normal((2,) + kv.shape[1:]).astype(np.float32)
    jc = {"k": jnp.asarray(new[0]), "v": jnp.asarray(new[1]), "pos": jnp.asarray(pos + 3)}
    tc = {"k": torch.from_numpy(new[0].copy()), "v": torch.from_numpy(new[1].copy()),
          "pos": torch.from_numpy(pos + 3)}
    keep = np.array([0, 2, 3], np.int32)
    jr = jcache.seq_rows_restore(jc, jsnap, jnp.asarray(keep))
    tr = tcache.seq_rows_restore(tc, tsnap, torch.from_numpy(keep))
    assert tr is tc
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(tr[name].numpy(), np.asarray(jr[name]))
    ck = rng.standard_normal((2, 3, 6, 5)).astype(np.float32)
    for n in (1, 3):
        np.testing.assert_array_equal(
            tcache.slice_rows_per_slot(torch.from_numpy(ck), torch.from_numpy(keep), 1, n).numpy(),
            np.asarray(jcache.slice_rows_per_slot(jnp.asarray(ck), jnp.asarray(keep), 1, n)))


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(4,), (4, 5), (2, 3, 2)])
def test_norm_apply_kernel_route_on_cpu_is_the_plain_route(norm_type, dtype, lead):
    """``norm_apply(..., use_kernel=True)`` sends a CPU tensor to the norm
    kernel's plain version: bit-equal to the route without the kernel,
    ``LAUNCHES["norm"]`` unmoved, and within 1e-4 of the reference's
    ``norm_apply`` (f32; bf16 within one bf16 step)."""
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(len(lead))
    d = 24
    jp = jlayers.norm_init(d, norm_type)
    jp = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.standard_normal(d).astype(np.float32))
          for k, v in jp.items()}
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    x = torch.from_numpy(rng.standard_normal(lead + (d,)).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    tops.reset_launch_counts()
    kernel = tlayers.norm_apply(tp, x, norm_type, use_kernel=True)
    assert tops.LAUNCHES["norm"] == 0
    assert torch.equal(kernel, tlayers.norm_apply(tp, x, norm_type))
    want = jlayers.norm_apply(jp, jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)),
                              norm_type)
    tol = TOL if dtype == "float32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(kernel.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **tol)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_every_norm_of_a_step_takes_the_configs_kernel_route(codeqwen, use_kernel, monkeypatch):
    """Each norm of a decode step is called with ``use_kernel`` as the
    cascade config sets it: layer 0's ln1 as a plain norm, every later ln1
    as an add-norm (the previous layer's MLP output added inside it), every
    ln2 as an add-norm (the attention output), the final norm as an
    add-norm (the last MLP output)."""
    cfg, jm, jp, tm, tp = codeqwen
    seen = []

    def spy(name):
        fn = getattr(tlayers, name)

        def call(*a, **kw):
            seen.append((name, kw.get("use_kernel", False)))
            return fn(*a, **kw)
        monkeypatch.setattr(tlayers, name, call)
    for name in ("norm_apply", "add_norm_apply", "gated_norm_apply"):
        spy(name)
    tc = tm.init_cache(2, 8, dtype=torch.float32, device="cpu")
    ccfg = dataclasses.replace(T_FP4, use_kernel=use_kernel)
    with torch.no_grad():
        tm.decode_step(tp, {"tokens": torch.from_numpy(_tokens(cfg, 2, 1))}, tc, ccfg)
    want = ["norm_apply"] + ["add_norm_apply"] * (2 * cfg.n_layers)
    assert seen == [(name, use_kernel) for name in want]


def _eager_norm_routes(monkeypatch):
    """Send ``add_norm_apply`` back to the route it replaced: the eager add,
    then ``norm_apply``."""
    norm_apply = tlayers.norm_apply

    def add_norm(params, x, r, norm_type="rmsnorm", eps=1e-6, *, use_kernel=False):
        s = x + r
        return norm_apply(params, s, norm_type, eps, use_kernel=use_kernel), s
    monkeypatch.setattr(tlayers, "add_norm_apply", add_norm)


def _serve_modes(m, p, ccfg, toks, chunk, nxt, draft):
    """Logits of a prefill, a padded extend chunk (3 of its tokens valid), a
    decode step and a verify pass, in that order on one cache."""
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        lp, c = m.prefill(p, {"tokens": t(toks)}, ccfg, max_len=24)
        le, c = m.prefill_extend(p, {"tokens": t(chunk)}, c, ccfg, n_valid=3)
        ld, c = m.decode_step(p, {"tokens": t(nxt)}, c, ccfg)
        lv, c, _ = m.spec_verify(p, {"tokens": t(draft)}, c, ccfg)
    return {"prefill": lp, "extend": le, "decode": ld, "verify": lv}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_norms_give_the_eager_routes_logits_bit_for_bit(codeqwen, use_kernel, monkeypatch):
    """The residual adds folded into the next norm (add-norm) leave a
    codeqwen smoke model's logits bit-equal to the eager add-then-norm route
    on the CPU, in prefill, extend, decode and verify, f32 and bf16, with and
    without the kernel route; the f32 logits stay within 1e-4 of JAX's."""
    cfg, jm, jp, tm, tp = codeqwen
    toks, chunk, nxt, draft = (_tokens(cfg, 2, n, seed=20 + n) for n in (5, 4, 1, 3))
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=dtype, use_kernel=use_kernel)
        fused = _serve_modes(tm, tp, ccfg, toks, chunk, nxt, draft)
        with monkeypatch.context() as mp:
            _eager_norm_routes(mp)
            eager = _serve_modes(tm, tp, ccfg, toks, chunk, nxt, draft)
        for mode in fused:
            assert torch.equal(fused[mode], eager[mode]), (dtype, mode)
        got[dtype] = fused
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4, max_len=24)
    want = {"prefill": jl}
    want["extend"], jc = jm.prefill_extend(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4,
                                           n_valid=jnp.int32(3))
    want["decode"], jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
    want["verify"], _, _ = jm.spec_verify(jp, {"tokens": jnp.asarray(draft)}, jc, J_FP4)
    for mode, w in want.items():
        _close(got[torch.float32][mode], w)
