"""The port's Mamba-2 (``repro_torch.models.ssm``) against the JAX package's.

Inputs come from numpy seeds; model weights are the reference's own params,
carried across leaf by leaf through ``convert.params_from_numpy``. Everything
runs in f32 at the smoke size (2 layers, d_model 64, 4 heads of 32, N=16,
vocab 256). Tolerances:

* SSD primitives (``ssd_chunked``, ``ssd_decode_step``) and the conv
  helpers: atol/rtol 1e-5. The same f32 operations; einsums and the conv's
  shifted adds sum in another order, and exp may differ by an ulp.
* Model logits and caches: atol/rtol 1e-4, as the transformer tests hold
  them: two layers of those differences, through norms and FP4 matmuls.
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
from repro.models import ssm as jssm
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.models import registry
from repro_torch.models import ssm as tssm
from repro_torch.models.ssm import Mamba2LM

jax.config.update("jax_platform_name", "cpu")

PRIM_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
J_FP4 = JCascadeConfig(mode="serve_fp4", compute_dtype=jnp.float32)
T_FP4 = CascadeConfig(mode="serve_fp4", compute_dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _close_cache(tc, jc):
    for name in ("conv", "state"):
        _close(tc["layers"][name], jc["layers"][name])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _pair(groups=1):
    """(cfg, JAX model, JAX FP4 params, port model, port params) at smoke size."""
    cfg = dataclasses.replace(jregistry.get_config("mamba2-370m", smoke=True),
                              ssm_groups=groups)
    jm = jssm.Mamba2LM(cfg)
    jp = jcascade.tree_to_serve_fp4(jm.init_params(jax.random.PRNGKey(0), J_TRAIN), J_FP4)
    tm = Mamba2LM(dataclasses.replace(registry.get_config("mamba2-370m", smoke=True),
                                      ssm_groups=groups))
    return cfg, jm, jp, tm, _to_torch(jp)


@pytest.fixture(scope="module", params=[1, 2], ids=["G1", "G2"])
def mamba(request):
    return _pair(request.param)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# SSD primitives and the conv helpers
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, D, s0


@pytest.mark.parametrize("s,chunk,g", [(21, 8, 1), (16, 8, 2), (5, 16, 1)])
@pytest.mark.parametrize("with_initial", [False, True])
def test_ssd_chunked_matches_jax(s, chunk, g, with_initial):
    """The dual form, padded to a chunk multiple (s=21 at chunk 8), with and
    without an initial state."""
    x, dt, A, B, C, D, s0 = _ssd_inputs(2, s, 4, 8, g, 16, seed=s + g)
    init = s0 if with_initial else None
    wy, ws = jssm.ssd_chunked(*[jnp.asarray(a) for a in (x, dt, A, B, C, D)], chunk,
                              initial_state=None if init is None else jnp.asarray(init))
    gy, gs = tssm.ssd_chunked(*[_t(a) for a in (x, dt, A, B, C, D)], chunk,
                              initial_state=None if init is None else _t(init))
    assert gy.shape == (2, s, 4, 8) and gs.shape == (2, 4, 8, 16)
    _close(gy, wy, PRIM_TOL)
    _close(gs, ws, PRIM_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_jax(g):
    x, dt, A, B, C, D, s0 = _ssd_inputs(3, 1, 4, 8, g, 16, seed=40 + g)
    args = (x, dt, A, B, C, D, s0)
    wy, ws = jssm.ssd_decode_step(*[jnp.asarray(a) for a in args])
    gy, gs = tssm.ssd_decode_step(*[_t(a) for a in args])
    _close(gy, wy, PRIM_TOL)
    _close(gs, ws, PRIM_TOL)


def test_conv_helpers_match_jax():
    rng = np.random.default_rng(5)
    b, s, dim, width = 2, 7, 12, 4
    x = rng.standard_normal((b, s, dim)).astype(np.float32)
    w = (rng.standard_normal((width, dim)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(dim).astype(np.float32)
    st = rng.standard_normal((b, width - 1, dim)).astype(np.float32)
    J, T = (lambda *a: [jnp.asarray(v) for v in a]), (lambda *a: [_t(v) for v in a])

    _close(tssm._causal_conv(*T(x, w, bias)), jssm._causal_conv(*J(x, w, bias)), PRIM_TOL)

    wy, ws = jssm._conv_decode(*J(x[:, :1], st, w, bias))
    gy, gs = tssm._conv_decode(*T(x[:, :1], st, w, bias))
    _close(gy, wy, PRIM_TOL)
    _close(gs, ws, PRIM_TOL)

    for nv in (None, 3, s):
        wy, ws, wf = jssm._conv_extend(*J(x, st, w, bias), n_valid=nv)
        gy, gs, gf = tssm._conv_extend(*T(x, st, w, bias), n_valid=nv)
        _close(gy, wy, PRIM_TOL)
        _close(gs, ws, PRIM_TOL)
        _close(gf, wf, PRIM_TOL)

    for n in (2, s):                     # shorter than the receptive field, and longer
        _close(tssm.conv_prefill_state(_t(x[:, :n]), width),
               jssm.conv_prefill_state(jnp.asarray(x[:, :n]), width), PRIM_TOL)


def test_conv_state_is_stored_in_the_cache_dtype():
    """A bf16 conv cache: the input is rounded through the cache dtype and
    the advanced state is stored back in it, as the reference does."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    st = rng.standard_normal((2, 3, 8)).astype(np.float32)
    wy, ws = jssm._conv_decode(jnp.asarray(x), jnp.asarray(st).astype(jnp.bfloat16),
                               jnp.asarray(w), jnp.zeros(8))
    gy, gs = tssm._conv_decode(_t(x), _t(st).to(torch.bfloat16), _t(w), torch.zeros(8))
    assert gs.dtype == torch.bfloat16
    np.testing.assert_array_equal(gs.float().numpy(), np.asarray(ws.astype(jnp.float32)))
    _close(gy, wy, PRIM_TOL)


# ---------------------------------------------------------------------------
# Mamba2LM
# ---------------------------------------------------------------------------

def test_forward_matches_jax(mamba):
    cfg, jm, jp, tm, tp = mamba
    toks = _tokens(cfg, 2, 13)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)}, J_FP4)
    got = tm.forward(tp, {"tokens": _t(toks)}, T_FP4)
    assert got.shape == (2, 13, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_and_decode_match_jax(mamba):
    """prefill's logits and cache, then three decode steps (state updated in
    place) through the plain recurrence and through the kernel wrapper."""
    cfg, jm, jp, tm, tp = mamba
    toks = _tokens(cfg, 3, 11, seed=1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, T_FP4)
    _close(tl, jl)
    _close_cache(tc, jc)
    for use_kernel in (False, True):
        jcc = dataclasses.replace(J_FP4, use_kernel=use_kernel)
        tcc = dataclasses.replace(T_FP4, use_kernel=use_kernel)
        jcache, tcache = jc, _to_torch(jc)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        for _ in range(3):
            jl2, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jcache, jcc)
            tl2, tcache2 = tm.decode_step(tp, {"tokens": _t(nxt)}, tcache, tcc)
            assert tcache2 is tcache                  # updated in place
            _close(tl2, jl2)
            _close_cache(tcache, jcache)
            nxt = np.asarray(jnp.argmax(jl2[:, -1], axis=-1))[:, None].astype(np.int32)


def test_prefill_extend_matches_jax(mamba):
    """Chunked admission: a full chunk, then a right-padded one (n_valid <
    chunk, whose padded steps leave the state untouched), then a decode."""
    cfg, jm, jp, tm, tp = mamba
    toks = _tokens(cfg, 1, 16, seed=2)
    jc = jm.init_cache(1, 32, dtype=jnp.float32)
    tc = tm.init_cache(1, 32, dtype=torch.float32, device="cpu")
    for lo, nv in ((0, 8), (8, 5)):
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :nv] = toks[0, lo:lo + nv]
        jl, jc = jm.prefill_extend(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4, n_valid=nv)
        tl, tc2 = tm.prefill_extend(tp, {"tokens": _t(chunk)}, tc, T_FP4, n_valid=nv)
        assert tc2 is tc and tl.shape == (1, 1, cfg.vocab)
        _close(tl, jl)
        _close_cache(tc, jc)
    # the padded chunk left the state where a 13-token prefill leaves it
    _, pc = tm.prefill(tp, {"tokens": _t(toks[:, :13])}, T_FP4)
    _close(tc["layers"]["state"], pc["layers"]["state"].detach().numpy())
    nxt = np.array([[7]], np.int32)
    jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
    tl, tc = tm.decode_step(tp, {"tokens": _t(nxt)}, tc, T_FP4)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_unbounded_context_flag():
    assert Mamba2LM.unbounded_context and jssm.Mamba2LM.unbounded_context


# ---------------------------------------------------------------------------
# speculative verify and rewind
# ---------------------------------------------------------------------------

def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def test_ssd_chunked_chunk_states_match_jax():
    """At chunk 1 the chunk states are the state before every token: the
    per-token checkpoints of the verify pass."""
    x, dt, A, B, C, D, s0 = _ssd_inputs(2, 5, 4, 8, 2, 16, seed=9)
    wy, ws, wst = jssm.ssd_chunked(*[jnp.asarray(a) for a in (x, dt, A, B, C, D)], 1,
                                   initial_state=jnp.asarray(s0), return_chunk_states=True)
    gy, gs, gst = tssm.ssd_chunked(*[_t(a) for a in (x, dt, A, B, C, D)], 1,
                                   initial_state=_t(s0), return_chunk_states=True)
    assert gst.shape == (2, 5, 4, 8, 16)
    for g, w in ((gy, wy), (gs, ws), (gst, wst)):
        _close(g, w, PRIM_TOL)


def _slotted(cfg, jm, jp, tm, tp, lens):
    jc = jm.init_cache(len(lens), 32, dtype=jnp.float32)
    tc = tm.init_cache(len(lens), 32, dtype=torch.float32, device="cpu")
    for i, n in enumerate(lens):
        toks = _tokens(cfg, 1, n, seed=10 + i)
        _, jsub = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4)
        jc = jm.write_cache(jc, jsub, i)
        _, tsub = tm.prefill(tp, {"tokens": _t(toks)}, T_FP4)
        tm.write_cache(tc, tsub, i)
    return jc, tc


@pytest.mark.parametrize("use_kernel", [False, True])
def test_spec_verify_and_rewind_match_jax(mamba, use_kernel):
    """The verify pass checkpoints the conv window and the SSD state after
    every chunk token, through the reference's chunk-1 dual form or, with
    ``use_kernel``, one ``ops.ssd_decode`` per token (the recurrence of plain
    decode); logits, advanced cache and checkpoints agree with the
    reference's, and so does every per-slot rewind (keep = 0 included). The
    port's state stack is (L, s+1, B, ...), the reference's (L, B, s+1, ...)."""
    cfg, jm, jp, tm, tp = mamba
    jc, tc = _slotted(cfg, jm, jp, tm, tp, [5, 8, 3])
    chunk = _tokens(cfg, 3, 4, seed=7)
    tcc = dataclasses.replace(T_FP4, use_kernel=use_kernel)
    jl, jc2, jck = jm.spec_verify(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4)
    with torch.no_grad():
        tl, tc2, tck = tm.spec_verify(tp, {"tokens": _t(chunk)}, tc, tcc)
    assert tc2 is tc and tl.shape == (3, 4, cfg.vocab)
    _close(tl, jl)
    _close_cache(tc2, jc2)
    _close(tck["layers"]["conv"], jck["layers"]["conv"])
    _close(tck["layers"]["state"].transpose(1, 2), jck["layers"]["state"])
    np.testing.assert_array_equal(tck["pos"].numpy(), np.asarray(jck["pos"]))
    for keep in ([0, 2, 4], [1, 0, 3]):
        jr = jm.spec_rewind(jc2, jck, jnp.asarray(keep, jnp.int32))
        tr = tm.spec_rewind(_copy(tc2), tck, torch.tensor(keep))
        _close_cache(tr, jr)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_full_rewind_restores_the_cache_bit_exactly(mamba, use_kernel):
    cfg, jm, jp, tm, tp = mamba
    _, tc = _slotted(cfg, jm, jp, tm, tp, [5, 8, 3])
    before = _copy(tc)
    tcc = dataclasses.replace(T_FP4, use_kernel=use_kernel)
    with torch.no_grad():
        _, after, ckpt = tm.spec_verify(tp, {"tokens": _t(_tokens(cfg, 3, 4, seed=8))}, tc, tcc)
    rewound = tm.spec_rewind(after, ckpt, torch.zeros(3, dtype=torch.int64))
    for name in ("conv", "state"):
        assert torch.equal(rewound["layers"][name], before["layers"][name]), name
    assert torch.equal(rewound["pos"], before["pos"])


def test_conv_steps_are_the_decode_conv_token_by_token():
    """The kernel route's verify conv: each chunk token's output equals a
    ``_conv_decode`` of that token on the window before it, bit for bit,
    also with a bf16 cache under an f32 chunk; the carried state and the
    raw window are ``_conv_extend``'s."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 5, 12)).astype(np.float32))
    w = _t((rng.standard_normal((4, 12)) * 0.1).astype(np.float32))
    bias = _t(rng.standard_normal(12).astype(np.float32))
    for cache_dtype in (torch.float32, torch.bfloat16):
        st = _t(rng.standard_normal((2, 3, 12)).astype(np.float32)).to(cache_dtype)
        y, new_state, full = tssm._conv_steps(x, st, w, bias)
        _, ws, wf = tssm._conv_extend(x, st, w, bias)
        assert torch.equal(new_state, ws) and torch.equal(full, wf)
        state = st
        for j in range(5):
            yj, state = tssm._conv_decode(x[:, j:j + 1], state, w, bias)
            assert torch.equal(y[:, j:j + 1], yj), (cache_dtype, j)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gated_and_layer_norms_take_the_configs_kernel_route(mamba, use_kernel, monkeypatch):
    """Each norm of a Mamba-2 decode step is called with ``use_kernel`` as
    the cascade config sets it: layer 0's input norm as a plain norm, every
    later input norm as an add-norm (the previous mixer output added inside
    it), every layer's gated norm (the gate inside it), the final norm as
    an add-norm. On CPU tensors the kernel route is the plain versions, so
    no norm launch is counted and the logits stay within 1e-4 of JAX's."""
    from repro_torch.kernels import ops as tops
    from repro_torch.models import layers as tlayers
    cfg, jm, jp, tm, tp = mamba
    toks = _tokens(cfg, 2, 9, seed=3)
    seen = []

    def spy(name):
        fn = getattr(tlayers, name)

        def call(*a, **kw):
            seen.append((name, kw.get("use_kernel", False)))
            return fn(*a, **kw)
        monkeypatch.setattr(tlayers, name, call)
    ccfg = dataclasses.replace(T_FP4, use_kernel=use_kernel)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])}, J_FP4)
    _, tc = tm.prefill(tp, {"tokens": _t(toks[:, :4])}, T_FP4)
    for name in ("norm_apply", "add_norm_apply", "gated_norm_apply"):
        spy(name)
    tops.reset_launch_counts()
    with torch.no_grad():
        tl, _ = tm.decode_step(tp, {"tokens": _t(toks[:, 4:5])}, tc, ccfg)
    want = (["norm_apply", "gated_norm_apply"]
            + ["add_norm_apply", "gated_norm_apply"] * (cfg.n_layers - 1) + ["add_norm_apply"])
    assert seen == [(name, use_kernel) for name in want]
    assert tops.LAUNCHES["norm"] == 0
    jl2, _ = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 4:5])}, jc, J_FP4)
    _close(tl, jl2)


def _eager_norm_routes(monkeypatch):
    """Send ``add_norm_apply`` and ``gated_norm_apply`` back to the route the
    fused forms replaced: the eager add or gate, then ``norm_apply``."""
    import torch.nn.functional as F
    from repro_torch.models import layers as tlayers
    norm_apply = tlayers.norm_apply

    def add_norm(params, x, r, norm_type="rmsnorm", eps=1e-6, *, use_kernel=False):
        s = x + r
        return norm_apply(params, s, norm_type, eps, use_kernel=use_kernel), s

    def gated_norm(params, y, z, eps=1e-6, *, use_kernel=False):
        return norm_apply(params, (y * F.silu(z.to(torch.float32))).to(y.dtype), eps=eps,
                          use_kernel=use_kernel)
    monkeypatch.setattr(tlayers, "add_norm_apply", add_norm)
    monkeypatch.setattr(tlayers, "gated_norm_apply", gated_norm)


def _serve_modes(m, p, ccfg, toks, chunk, nxt, draft):
    """Logits of a prefill, a padded extend chunk (3 of its tokens valid), a
    decode step and a verify pass, in that order on one cache."""
    with torch.no_grad():
        lp, c = m.prefill(p, {"tokens": _t(toks)}, ccfg)
        le, c = m.prefill_extend(p, {"tokens": _t(chunk)}, c, ccfg, n_valid=3)
        ld, c = m.decode_step(p, {"tokens": _t(nxt)}, c, ccfg)
        lv, c, _ = m.spec_verify(p, {"tokens": _t(draft)}, c, ccfg)
    return {"prefill": lp, "extend": le, "decode": ld, "verify": lv}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_norms_give_the_eager_routes_logits_bit_for_bit(mamba, use_kernel, monkeypatch):
    """The residual adds folded into the next norm (add-norm) and the gate
    folded into the gated norm leave a Mamba-2 smoke model's logits
    bit-equal to the eager route (the add or gate, then the norm) on the
    CPU, in prefill, extend, decode and verify, f32 and bf16, with and
    without the kernel route; the f32 logits stay within 1e-4 of JAX's."""
    cfg, jm, jp, tm, tp = mamba
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
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, J_FP4)
    want = {"prefill": jl}
    want["extend"], jc = jm.prefill_extend(jp, {"tokens": jnp.asarray(chunk)}, jc, J_FP4,
                                           n_valid=3)
    want["decode"], jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, J_FP4)
    want["verify"], _, _ = jm.spec_verify(jp, {"tokens": jnp.asarray(draft)}, jc, J_FP4)
    for mode, w in want.items():
        _close(got[torch.float32][mode], w)
