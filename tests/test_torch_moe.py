"""The port's MoE family (``core/cascade.py``'s expert linears,
``models/moe.py``) against the JAX package, layer by layer, at f32.

* Expert linears, the MoE FFN (drop-free and with capacity drops), MLA
  (prefill, decode and extend, dense and paged) and the whole ``MoELM``
  (forward, prefill, decode, extend, speculative verify and rewind, dense
  and paged) agree with the reference within atol/rtol 1e-4, as the dense
  transformer's tests (matmul, softmax and RoPE sums run in another order
  on the two sides). The reference's cache ``{"dense_layers": [...],
  "layers": ...}`` is compared with the port's one stack of all layers by
  concatenating its parts.
* Integer work is exact: each token's experts (ties to the lower index, as
  ``lax.top_k``), the dispatch rows, what capacity drops, and FP4 codes.
* The grouped kernel's plain version equals per-expert calls bit for bit
  and gives exact zeros past each expert's routed rows; on the CPU the
  wrapper counts no launch.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from repro.core import cascade as jcascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro_torch.convert import params_from_numpy
from repro_torch.core import cascade as tcascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.kernels import cascade_matmul as tcm
from repro_torch.kernels import ops
from repro_torch.models import cache_utils as tcache
from repro_torch.models import moe as tmoe
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)
T_FP4_KERNEL = dataclasses.replace(T_FP4, use_kernel=True)
ARCHS = ["deepseek-v2-236b", "olmoe-1b-7b"]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """An MoE smoke model's FP4 params drawn by the reference and carried
    across leaf by leaf (the ``dense_layers`` list included)."""
    cfg, jm = jregistry.load(request.param, smoke=True)
    jp = jax.jit(lambda k: jcascade.tree_to_serve_fp4(jm.init_params(k, J_TRAIN), J_FP4))(
        jax.random.PRNGKey(0))
    _, tm = registry.load(request.param, smoke=True)
    return cfg, jm, jp, tm, _carry(jp)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """The reference function jitted (its configs static): one compile a
    shape instead of op-by-op dispatch, which costs the CPU far more."""
    return jax.jit(fn, static_argnums=static)


# ---------------------------------------------------------------------------
# expert linears and the grouped kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,use_kernel", [("serve_fp4", False), ("serve_fp4", True),
                                             ("train", False)])
def test_expert_linear_apply_matches_jax(mode, use_kernel):
    jcfg = JCascadeConfig(mode=mode, compute_dtype=jnp.float32)
    p = jcascade.expert_linear_init(jax.random.PRNGKey(1), 4, 40, 24, jcfg)
    x = np.random.default_rng(0).standard_normal((4, 8, 40)).astype(np.float32)
    want = np.asarray(jcascade.expert_linear_apply(p, jnp.asarray(x), jcfg))
    tcfg = CascadeConfig(mode=mode, compute_dtype=torch.float32, use_kernel=use_kernel)
    got = tcascade.expert_linear_apply(_carry(p), _t(x), tcfg)
    assert got.shape == (4, 8, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_linear_weight_matches_jax():
    for mode in ("serve_fp4", "train"):
        jcfg = JCascadeConfig(mode=mode, compute_dtype=jnp.float32)
        p = jcascade.linear_init(jax.random.PRNGKey(2), 24, 40, jcfg)
        want = np.asarray(jcascade.linear_weight(p, jcfg))
        got = tcascade.linear_weight(_carry(p), CascadeConfig(mode=mode,
                                                              compute_dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy(), want)


def test_expert_linear_init_quantizes_each_expert():
    gen = torch.Generator().manual_seed(0)
    p = tcascade.expert_linear_init(gen, 5, 40, 24, T_FP4, device="cpu")
    assert p["codes"].shape == (5, 20, 24) and p["codes"].dtype == torch.uint8
    assert p["scale"].shape == (5, 1, 24) and p["scale"].dtype == torch.float32
    assert not torch.equal(p["codes"][0], p["codes"][1])     # each expert its own draw


def test_grouped_plain_equals_per_expert_calls_and_zeros_past_the_routed_rows():
    """Rows below ``rows[e]`` are bit for bit the per-expert call's; the rest
    (an expert with no row, one with all C) are exact zeros, whatever x holds
    there. On the CPU the wrapper runs the plain version and counts nothing."""
    from repro_torch.core import quant
    gen = torch.Generator().manual_seed(3)
    e, c, k, n = 4, 8, 40, 24
    ws = [quant.quantize_weight(torch.randn((k, n), generator=gen), 0) for _ in range(e)]
    codes, scales = torch.stack([w[0] for w in ws]), torch.stack([w[1] for w in ws])
    x = torch.randn((e, c, k), generator=gen)
    rows = torch.tensor([0, 3, c, 5], dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.cascade_matmul_grouped(x, codes, scales, rows)
    assert ops.LAUNCHES["cascade_matmul_grouped"] == 0 and got.shape == (e, c, n)
    for i in range(e):
        want = tcm.cascade_matmul_plain(x[i], codes[i], scales[i])
        r = int(rows[i])
        assert torch.equal(got[i, :r], want[:r])
        assert not got[i, r:].any()
    assert torch.equal(ops.cascade_matmul_grouped(x, codes, scales),
                       torch.stack([tcm.cascade_matmul_plain(x[i], codes[i], scales[i])
                                    for i in range(e)]))


# (E, N): olmoe's gate/up and down, deepseek-v2's, and the card tests' (N
# off the column tile; E = 3, 5, 6, 8)
GROUPED_PLAN_SHAPES = [(64, 1024), (64, 2048), (160, 1536), (160, 5120), (5, 301), (3, 40),
                       (6, 136), (8, 256)]


@pytest.mark.parametrize("e,n", GROUPED_PLAN_SHAPES)
def test_grouped_plan_fits_two_blocks_an_sm_and_covers_n(e, n):
    """The grouped launch's plan: its shared memory leaves room for two
    blocks an SM, its column tiles cover N with none past it, and it follows
    from the shapes alone."""
    pl = tcm.plan_grouped(e, n)
    assert 2 * (pl["smem_bytes"] + tcm.BLOCK_RESERVED_SMEM) <= tcm.SM_SMEM_BYTES
    assert pl["smem_bytes"] % 16 == 0
    assert pl["col_tiles"] * pl["col_tile"] >= n > (pl["col_tiles"] - 1) * pl["col_tile"]
    assert (pl["col_tile"], pl["stages"], pl["steps_a_stage"], pl["threads"]) == (128, 3, 8, 256)
    assert pl == tcm.plan_grouped(e, n)
    bigger = tcm.plan_grouped(e + 8, n)
    assert bigger["smem_bytes"] > pl["smem_bytes"]                # the experts' prefix
    assert {k: v for k, v in bigger.items() if k != "smem_bytes"} == \
        {k: v for k, v in pl.items() if k != "smem_bytes"}


# (E, C, K, N, group, rows): olmoe-like stacks at a decode step's C, an odd K
# (the zero activation column), groups on and off the 16-row step, and an
# expert at no row, one at all C and one past C
GROUPED_PAIR_CASES = [(4, 8, 40, 24, 0, [0, 3, 8, 5]), (3, 17, 33, 20, 0, [17, 0, 9]),
                      (2, 6, 64, 16, 32, [6, 2]), (3, 5, 48, 12, 24, [1, 5, 7])]


@pytest.mark.parametrize("e,c,k,n,group,rows", GROUPED_PAIR_CASES)
def test_grouped_pair_plain_route_equals_two_grouped_calls(e, c, k, n, group, rows):
    """On the CPU the pair (gate and up in one launch on the card) is two
    plain grouped calls: each output bit for bit the single call's, exact
    zeros past each expert's rows whatever x holds there, no launch
    counted; ``expert_linear_pair_apply`` gives each linear's own output."""
    from repro_torch.core import quant
    gen = torch.Generator().manual_seed(e * 100 + k)
    stacks = []
    for _ in range(2):
        ws = [quant.quantize_weight(torch.randn((k, n), generator=gen), group) for _ in range(e)]
        stacks.append((torch.stack([w[0] for w in ws]), torch.stack([w[1] for w in ws])))
    x = torch.randn((e, c, k), generator=gen)
    r = torch.tensor(rows, dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.cascade_matmul_grouped_pair(x, stacks[0], stacks[1], r)
    assert ops.LAUNCHES["cascade_matmul_grouped"] == 0 and len(got) == 2
    live = torch.arange(c)[None, :] < r.clamp(max=c)[:, None]
    for out, (codes, scales) in zip(got, stacks):
        assert torch.equal(out, ops.cascade_matmul_grouped(x, codes, scales, r))
        assert not out[~live].any()
    params = [{"codes": p, "scale": s} for p, s in stacks]
    pair = tcascade.expert_linear_pair_apply(params[0], params[1], x, T_FP4_KERNEL, r)
    for out, p in zip(pair, params):
        assert torch.equal(out, tcascade.expert_linear_apply(p, x, T_FP4_KERNEL, r))


def test_tree_to_serve_fp4_takes_stacked_experts_and_lists():
    """Stacked experts (L, E, K, N) and a list of layers quantize to the
    reference's codes and scales exactly."""
    rng = np.random.default_rng(5)
    tree = {"dense_layers": [{"mlp": {"w": rng.standard_normal((6, 4)).astype(np.float32)}}],
            "layers": {"wg": {"w": rng.standard_normal((2, 3, 6, 4)).astype(np.float32)},
                       "router": rng.standard_normal((6, 3)).astype(np.float32)}}
    want = jcascade.tree_to_serve_fp4(jax.tree.map(jnp.asarray, tree), J_FP4)
    got = tcascade.tree_to_serve_fp4(jax.tree.map(_t, tree), T_FP4)
    assert isinstance(got["dense_layers"], list)
    assert got["layers"]["wg"]["codes"].shape == (2, 3, 3, 4)
    flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(
        jax.tree.map(lambda a: a.numpy(), got, is_leaf=lambda a: isinstance(a, torch.Tensor)))
    assert len(flat_w) == len(flat_g)
    for a, b in zip(flat_w, flat_g):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert tcascade.num_weight_bytes(got) == jcascade.num_weight_bytes(want)


# ---------------------------------------------------------------------------
# routing, dispatch and the MoE FFN
# ---------------------------------------------------------------------------

def _jax_dispatch(idx, e, cap):
    """The reference's dispatch arithmetic (``moe_ffn_apply``)."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, flat_e[:, None], axis=1)[:, 0]
    keep = pos < cap
    return jnp.where(keep, flat_e * cap + pos, e * cap), keep


@pytest.mark.parametrize("cap", [8, 16])
def test_routing_and_dispatch_integer_work_equals_jax(models, cap):
    cfg, jm, jp, tm, tp = models
    lp = _layer(jp["layers"], 0)["moe"]
    x = np.random.default_rng(7).standard_normal((40, cfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.dot(jnp.asarray(x), lp["router"]), axis=-1)
    jg, jidx = lax.top_k(probs, cfg.moe_top_k)
    gates, idx = tmoe.route(tcache.layer_view(tp["layers"], 0)["moe"], _t(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if cfg.moe_renorm:
        jg = jg / jnp.sum(jg, axis=-1, keepdims=True)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), **TOL)
    jdst, jkeep = _jax_dispatch(jidx, cfg.n_experts, cap)
    dst, keep, rows = tmoe.dispatch(idx, cfg.n_experts, cap)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    counts = np.bincount(np.asarray(jidx).reshape(-1), minlength=cfg.n_experts)
    np.testing.assert_array_equal(rows.numpy(), np.minimum(counts, cap))
    assert rows.dtype == torch.int32


def test_top_k_ties_go_to_the_lower_expert_as_lax_top_k():
    """Duplicated router columns tie exactly: the port picks the lower
    index first, as ``lax.top_k`` does."""
    cfg = registry.get_config("olmoe-1b-7b", smoke=True)
    router = np.random.default_rng(8).standard_normal((cfg.d_model, cfg.n_experts))
    router = router.astype(np.float32) * 0.02
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    x = np.random.default_rng(9).standard_normal((16, cfg.d_model)).astype(np.float32)
    _, jidx = lax.top_k(jax.nn.softmax(jnp.dot(jnp.asarray(x), jnp.asarray(router))), 2)
    _, idx = tmoe.route({"router": _t(router)}, _t(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_router_rows_round_alike_at_any_row_count():
    """A row's logits are the same bits in a decode step's 8 rows, an
    admission chunk's 32 and a verify pass's 40 (one M for all three)."""
    gen = torch.Generator().manual_seed(10)
    x, router = torch.randn((40, 64), generator=gen), torch.randn((64, 8), generator=gen)
    whole = tmoe.router_logits(x, router)
    for m in (1, 8, 32):
        assert torch.equal(tmoe.router_logits(x[:m], router), whole[:m])


@pytest.mark.parametrize("no_drop", [True, False])
@pytest.mark.parametrize("ccfg", [T_FP4, T_FP4_KERNEL], ids=["plain", "kernel"])
def test_moe_ffn_apply_matches_jax(models, no_drop, ccfg):
    """Drop-free (serving) and with capacity drops (``forward``): tokens
    near one direction all pick the same experts, past their capacity."""
    cfg, jm, jp, tm, tp = models
    rng = np.random.default_rng(11)
    base = rng.standard_normal((1, 1, cfg.d_model))
    x = (base + 0.05 * rng.standard_normal((2, 16, cfg.d_model))).astype(np.float32)
    jl, tl = _layer(jp["layers"], 0)["moe"], tcache.layer_view(tp["layers"], 0)["moe"]
    want = np.asarray(_jit(jmoe.moe_ffn_apply, 2, 3, 4)(jl, jnp.asarray(x), cfg, J_FP4, no_drop))
    got = tmoe.moe_ffn_apply(tl, _t(x), cfg, ccfg, no_drop=no_drop)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    cap = 32 if no_drop else tmoe._capacity(32, cfg)
    _, idx = tmoe.route(tl, _t(x).reshape(32, -1), cfg)
    _, keep, _ = tmoe.dispatch(idx, cfg.n_experts, cap)
    assert bool(keep.all()) == no_drop                       # drops happen without no_drop


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    cfg = registry.get_config("deepseek-v2-236b", smoke=True)
    jp = _jit(jmoe.mla_init, 1, 2)(jax.random.PRNGKey(3), cfg, J_FP4)
    return cfg, jp, _carry(jp)


def _mla_both(mla, x, jcache, tcache_, mode, **kw):
    cfg, jp, tp = mla
    jo, jc = _jit(jmoe.mla_apply, 2, 3, 5, 6)(jp, jnp.asarray(x), cfg, J_FP4, jcache, mode,
                                               kw.get("max_len"), kw.get("n_valid"))
    tkw = {k: _t(v) if isinstance(v, jax.Array) else v for k, v in kw.items()}
    to, tc = tmoe.mla_apply(tp, _t(x), cfg, T_FP4, tcache_, mode, **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    return jc, tc


def _close_latents(tc, jc, pages=False):
    for name in ("c_kv", "k_rope"):
        a, b = tc[name].numpy(), np.asarray(jc[name])
        np.testing.assert_allclose(a[1:] if pages else a, b[1:] if pages else b, **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_mla_prefill_decode_and_extend_match_jax(mla):
    cfg = mla[0]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jc, tc = _mla_both(mla, x, None, None, "prefill", max_len=16)
    _close_latents(tc, jc)
    _mla_both(mla, x, None, None, "full")
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jc, tc = _mla_both(mla, x1, jc, tc, "decode")
    _close_latents(tc, jc)
    x4 = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    nv = np.array([4, 2], np.int32)
    jc, tc = _mla_both(mla, x4, jc, tc, "extend", n_valid=jnp.asarray(nv))
    _close_latents(tc, jc)


def test_mla_paged_matches_jax_and_equals_the_dense_branch_bit_for_bit(mla):
    """MLA's 3-D latent pools page as they are: an extend and a decode
    through a block table agree with the reference's paged MLA, and equal
    the port's dense cache bit for bit (the gathered view has its T)."""
    cfg, jp, tp = mla
    ps, npages = 4, 9
    bt = np.array([[2, 5, 7, 0], [1, 8, 3, 6]], np.int32)
    pos = np.array([0, 3], np.int32)
    jc = dict(jmoe.mla_cache_init_paged(2, npages, ps, cfg, jnp.float32), pos=jnp.asarray(pos))
    pc = tmoe.mla_cache_init_paged(2, npages, ps, cfg, torch.float32)
    dc = tmoe.mla_cache_init(2, 4 * ps, cfg, torch.float32)
    pc["pos"].copy_(_t(pos))
    dc["pos"].copy_(_t(pos))
    rng = np.random.default_rng(13)
    for mode, s, nv in (("extend", 5, np.array([5, 3], np.int32)), ("decode", 1, None)):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        jkw, tkw = ({}, {}) if nv is None else ({"n_valid": jnp.asarray(nv)}, {"n_valid": _t(nv)})
        jo, jc = _jit(jmoe.mla_apply, 2, 3, 5, 6)(jp, jnp.asarray(x), cfg, J_FP4,
                                                   dict(jc, block_table=jnp.asarray(bt)), mode,
                                                   None, jkw.get("n_valid"))
        po, _ = tmoe.mla_apply(tp, _t(x), cfg, T_FP4, dict(pc, block_table=_t(bt)), mode, **tkw)
        do, _ = tmoe.mla_apply(tp, _t(x), cfg, T_FP4, dc, mode, **tkw)
        assert torch.equal(po, do)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    _close_latents(pc, jc, pages=True)
    assert torch.equal(pc["pos"], dc["pos"])
    for name in ("c_kv", "k_rope"):
        view = tcache.paged_gather(pc[name], _t(bt), ps)
        for b, n in enumerate(dc["pos"].tolist()):
            assert torch.equal(view[b, :n], dc[name][b, :n])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _stack(jcache):
    """The reference's ``{"dense_layers": [...], "layers": ...}`` cache as the
    port's one stack, dense layers first."""
    parts = [jax.tree.map(lambda a: np.asarray(a)[None], c) for c in jcache["dense_layers"]]
    parts.append(jax.tree.map(np.asarray, jcache["layers"]))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _close_cache(tc, jc, pages=False):
    want = _stack(jc)
    assert set(tc["layers"]) == set(want)
    for name, w in want.items():
        g = tc["layers"][name].numpy()
        if name == "pos":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g[:, 1:] if pages else g, w[:, 1:] if pages else w, **TOL)


def test_param_tree_carries_across_with_the_dense_layers_list(models):
    cfg, jm, jp, tm, tp = models
    assert isinstance(tp["dense_layers"], list)
    assert len(tp["dense_layers"]) == cfg.first_dense_layers
    assert tp["layers"]["moe"]["wg"]["codes"].shape == (
        cfg.n_layers - cfg.first_dense_layers, cfg.n_experts, cfg.d_model // 2, cfg.moe_d_ff)
    mine = tm.init_params(0, T_FP4, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t,
                                    is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert shapes(mine) == shapes(tp)


@pytest.mark.parametrize("ccfg", [T_FP4, T_FP4_KERNEL], ids=["plain", "kernel"])
def test_model_steps_match_jax(models, ccfg):
    """forward, prefill, decode, a padded extend chunk, then a speculative
    verify chunk and its rewind."""
    cfg, jm, jp, tm, tp = models
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    want = _jit(jm.forward, 2)(jp, {"tokens": jnp.asarray(toks)}, J_FP4)
    got = tm.forward(tp, {"tokens": _t(toks)}, ccfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jl, jc = _jit(jm.prefill, 2, 3)(jp, {"tokens": jnp.asarray(toks)}, J_FP4, 24)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, ccfg, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    jl, jc = _jit(jm.decode_step, 3)(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
    tl, tc = tm.decode_step(tp, {"tokens": _t(nxt)}, tc, ccfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    chunk = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    nv = np.array([6, 4], np.int32)
    jl, jc = _jit(jm.prefill_extend, 3)(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4,
                                        jnp.asarray(nv))
    tl, tc = tm.prefill_extend(tp, {"tokens": _t(chunk)}, tc, ccfg, n_valid=_t(nv), kv_len=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)
    draft = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    jl, jc, jck = _jit(jm.spec_verify, 3)(jp, {"tokens": jnp.asarray(draft)}, jc, J_FP4)
    tl, tc, tck = tm.spec_verify(tp, {"tokens": _t(draft)}, tc, ccfg, kv_len=24)
    assert tl.shape == (2, 4, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    keep = np.array([3, 1], np.int32)
    jc = jm.spec_rewind(jc, jck, jnp.asarray(keep))
    tc = tm.spec_rewind(tc, tck, _t(keep))
    _close_cache(tc, jc)


def test_paged_model_steps_match_jax(models):
    """Two slots over a shared 9-page pool (page 4): a padded extend chunk at
    positions 0 and 3, a decode step, a verify chunk and its rewind. Pools
    agree on every page but the trash page, ``pos`` exactly; the checkpoint
    carries the table it wrote through."""
    cfg, jm, jp, tm, tp = models
    ps, npages = 4, 9
    bt = np.array([[2, 5, 7, 0], [1, 8, 3, 6]], np.int32)
    jc = jm.init_paged_cache(2, npages, ps, dtype=jnp.float32)
    pos = jnp.asarray([0, 3], jnp.int32)
    jc = {"dense_layers": [dict(c, pos=pos) for c in jc["dense_layers"]],
          "layers": dict(jc["layers"], pos=jnp.tile(pos, (cfg.n_layers - cfg.first_dense_layers,
                                                         1)))}
    tc = tm.init_paged_cache(2, npages, ps, dtype=torch.float32, device="cpu")
    tc["layers"]["pos"].copy_(torch.tensor([[0, 3]] * cfg.n_layers, dtype=torch.int32))
    rng = np.random.default_rng(15)

    def both(jfn, tfn, toks):
        jb = {"tokens": jnp.asarray(toks), "block_table": jnp.asarray(bt)}
        tb = {"tokens": _t(toks), "block_table": _t(bt)}
        return jfn(jb), tfn(tb)

    nv = np.array([6, 4], np.int32)
    (jl, jc), (tl, tc) = both(
        lambda b: _jit(jm.prefill_extend, 3)(jp, b, jc, J_FP4, jnp.asarray(nv)),
        lambda b: tm.prefill_extend(tp, b, tc, T_FP4_KERNEL, n_valid=_t(nv)),
        rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc, pages=True)
    (jl, jc), (tl, tc) = both(lambda b: _jit(jm.decode_step, 3)(jp, b, jc, J_FP4),
                              lambda b: tm.decode_step(tp, b, tc, T_FP4_KERNEL),
                              rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    (jl, jc, jck), (tl, tc, tck) = both(lambda b: _jit(jm.spec_verify, 3)(jp, b, jc, J_FP4),
                                        lambda b: tm.spec_verify(tp, b, tc, T_FP4_KERNEL),
                                        rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tck["block_table"].numpy(), bt)
    keep = np.array([2, 1], np.int32)
    jc = jm.spec_rewind(jc, jck, jnp.asarray(keep))
    tc = tm.spec_rewind(tc, tck, _t(keep))
    _close_cache(tc, jc, pages=True)
    src = 5
    tm.paged_copy_page(tc, src, 4)
    for name, buf in tc["layers"].items():
        if name != "pos":
            assert torch.equal(buf[:, 4], buf[:, src])


def test_registry_builds_moelm_whose_cache_is_one_stack_of_every_layer(models):
    """Both MoE configs build a ``MoELM``; its cache stacks all n_layers
    attention caches (dense layers first) with the slot axis where
    ``cache_utils`` states it, dense and paged."""
    cfg, jm, jp, tm, tp = models
    assert isinstance(tm, tmoe.MoELM) and tm.paged_attention
    assert registry.load(registry.FAMILY_SMOKE["moe"], smoke=True)[1].use_mla
    small = tm.init_cache(2, 8, dtype=torch.float32, device="cpu")
    big = tm.init_cache(3, 8, dtype=torch.float32, device="cpu")
    names = {"c_kv", "k_rope", "pos"} if tm.use_mla else {"k", "v", "pos"}
    assert set(big) == {"layers"} and set(big["layers"]) == names
    for name in names:
        a, b = small["layers"][name], big["layers"][name]
        assert a.shape[0] == cfg.n_layers
        assert [i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n] == \
            [tcache.LAYER_SLOT_AXIS]
    paged = tm.init_paged_cache(3, 5, 4, dtype=torch.float32, device="cpu")
    assert all(v.shape[:3] == (cfg.n_layers, 5, 4) for k, v in paged["layers"].items()
               if k != "pos")
