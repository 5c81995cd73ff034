"""QAT and the bit-accurate path in the port against the JAX package.

* Integer work on a float carrier is exact: ``fake_quant_fp4`` (f32 and
  bf16, per-column and group-32 scales, a group that does not divide K, 2-D
  and 3-D weights, an expert stack), ``fake_quant_fp8_e4m3`` (past +/-448,
  NaN and inf included), and ``linear_apply`` under ``precision_sim`` at
  f32 all equal the reference bit for bit. The straight-through gradients
  equal ``jax.grad``'s.
* Float work: the QAT logits and the loss gradients of five smoke configs
  (phi4-mini, codeqwen, mamba2-370m, recurrentgemma-2b, olmoe) agree with
  ``jax.value_and_grad`` within atol/rtol 1e-4 at f32 (the matmuls, softmax
  and scans sum in another order on the two sides; the fake-quantized
  weights themselves are bit-equal).
* In the port, every family's gradients with ``remat`` under each policy
  equal those without, bit for bit; on the CPU the wrappers count no launch.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import cascade as jcascade
from repro.core import quant as jq
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import registry as jregistry
from repro.train import loop as jloop
from repro_torch import tree as T
from repro_torch.convert import params_from_numpy
from repro_torch.core import cascade as tcascade
from repro_torch.core import quant as tq
from repro_torch.core.cascade import CascadeConfig
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.train import loop as tloop

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
J_QAT = JCascadeConfig(mode="train", qat=True, compute_dtype=jnp.float32)
T_QAT = CascadeConfig(mode="train", qat=True, compute_dtype=torch.float32)
ARCHS = ["phi4-mini-3.8b", "codeqwen1.5-7b", "mamba2-370m", "recurrentgemma-2b", "olmoe-1b-7b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its uint16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _assert_bits(got: torch.Tensor, want) -> None:
    """Bit for bit, but any NaN equals any NaN (an inf * 0 makes a NaN whose
    sign and payload the two libraries choose otherwise)."""
    g, w = _np(got), _jbits(want)
    gf = got.detach().float().numpy()
    wf = np.asarray(want, np.float32)
    same = (g == w) | (np.isnan(gf) & np.isnan(wf))
    assert same.all(), f"{(~same).sum()} of {same.size} differ, first at {np.argwhere(~same)[:3]}"


def _weights(shape, seed, specials=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if specials:
        flat = w.reshape(-1, shape[-1])
        flat[:, 0] = 0.0                               # an all-zero column: scale 1
        flat[0, 1], flat[1, 1] = 6.0, 2.5              # q exactly on a midpoint (ties to even)
        flat[3, 2] = np.nan                            # a NaN column (absmax NaN: scale 1)
        flat[5, 3] = -np.inf
    return w


# ---------------------------------------------------------------------------
# fake quantization: forward bit for bit, straight-through gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", [((64, 48), 0), ((64, 48), 32), ((96, 40), 64),
                                         ((2, 32, 24), 0), ((3, 2, 32, 16), 32)])
def test_fake_quant_fp4_forward_and_ste_gradient_equal_jax(dtype, shape, group):
    w = _weights(shape, seed=len(shape) + group, specials=True)
    jw = jnp.asarray(w).astype(dtype)
    tw = _t(w).to(getattr(torch, dtype)).requires_grad_(True)
    want = jq.fake_quant_fp4(jw, group)
    got = ops.fake_quant_fp4(tw, group)
    assert got.dtype == tw.dtype and got.shape == tw.shape
    _assert_bits(got, want)
    _assert_bits(tq.fake_quant_fp4_plain(tw.detach(), group), want)
    # straight-through: d/dw sum(c * fq(w)^2) = 2 c fq(w) (NaN-free rows only)
    c = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    finite = np.isfinite(w)
    c = np.where(finite, c, 0.0).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.where(finite, jnp.asarray(c) * jq.fake_quant_fp4(
        a, group).astype(jnp.float32) ** 2, 0.0)))(jw)
    (torch.where(_t(finite), _t(c) * ops.fake_quant_fp4(tw, group).float() ** 2,
                 torch.zeros(()))).sum().backward()
    np.testing.assert_allclose(np.asarray(tw.grad.float()), np.asarray(jg, np.float32),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_stack_fake_quant_equals_per_expert_calls(dtype):
    """An (E, K, N) stack with ``experts``: each expert its own scales, as
    the reference's vmap; the result equals E separate calls."""
    w = _weights((4, 32, 24), seed=3, specials=True)
    jw = jnp.asarray(w).astype(dtype)
    want = jax.vmap(lambda a: jq.fake_quant_fp4(a, 16))(jw)
    got = ops.fake_quant_fp4(_t(w).to(getattr(torch, dtype)), 16, experts=True)
    _assert_bits(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_fp8_forward_and_gradient_equal_jax(dtype):
    x = np.concatenate([np.linspace(-600, 600, 4001, dtype=np.float32),
                        np.array([464.0, -464.0, 465.0, 447.9, np.inf, -np.inf, np.nan, -np.nan,
                                  0.0, -0.0, 1e-3, 2.0 ** -10], np.float32)])
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype)).requires_grad_(True)
    want = jq.fake_quant_fp8_e4m3(jx)
    got = tq.fake_quant_fp8_e4m3(tx)
    _assert_bits(got, want)
    jg = jax.grad(lambda a: jnp.sum(jnp.asarray(np.arange(x.size, dtype=np.float32))
                                    * jq.fake_quant_fp8_e4m3(a).astype(jnp.float32)))(jx)
    (_t(np.arange(x.size, dtype=np.float32)) * got.float()).sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), _jbits(jg))


# ---------------------------------------------------------------------------
# linear_apply: precision_sim and QAT, abstract params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_linear_apply_precision_sim_bit_for_bit(bias, use_kernel):
    """FP4 activations under one scale over all rows, per-column FP4
    weights, FP5 products, FP8 sums, the scales and the bias: the
    reference's bits at f32 (``use_kernel`` takes the wrapper, which on the
    CPU runs the plain version)."""
    jcfg = JCascadeConfig(mode="serve_fp4", precision_sim=True, compute_dtype=jnp.float32)
    p = jcascade.linear_init(jax.random.PRNGKey(0), 48, 20, jcfg, use_bias=bias)
    if bias:
        p["b"] = jnp.linspace(-1, 1, 20, dtype=jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 3, 48)).astype(np.float32)
    want = jcascade.linear_apply(p, jnp.asarray(x), jcfg)
    tcfg = CascadeConfig(mode="serve_fp4", precision_sim=True, use_kernel=use_kernel,
                         compute_dtype=torch.float32)
    ops.reset_launch_counts()
    got = tcascade.linear_apply(params_from_numpy(jax.tree.map(np.asarray, p), device="cpu"),
                                _t(x), tcfg)
    np.testing.assert_array_equal(_np(got), _jbits(want))
    assert ops.LAUNCHES["cascade_matmul_exact"] == 0


@pytest.mark.parametrize("group", [0, 16])
def test_linear_apply_qat_and_expert_qat_equal_jax(group):
    jcfg = dataclasses.replace(J_QAT, group_size=group)
    tcfg = dataclasses.replace(T_QAT, group_size=group)
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(np.float32)
    p = jcascade.linear_init(jax.random.PRNGKey(1), 32, 24, jcfg, use_bias=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    np.testing.assert_allclose(tcascade.linear_apply(tp, _t(x), tcfg).numpy(),
                               np.asarray(jcascade.linear_apply(p, jnp.asarray(x), jcfg)), **TOL)
    pe = jcascade.expert_linear_init(jax.random.PRNGKey(2), 3, 32, 24, jcfg)
    xe = np.random.default_rng(4).standard_normal((3, 4, 32)).astype(np.float32)
    tpe = params_from_numpy(jax.tree.map(np.asarray, pe), device="cpu")
    np.testing.assert_allclose(tcascade.expert_linear_apply(tpe, _t(xe), tcfg).numpy(),
                               np.asarray(jcascade.expert_linear_apply(pe, jnp.asarray(xe),
                                                                       jcfg)), **TOL)


@pytest.mark.parametrize("mode,bias", [("train", True), ("serve_fp4", False), ("serve_fp4", True)])
def test_linear_abstract_matches_linear_init(mode, bias):
    jcfg = JCascadeConfig(mode=mode, group_size=16, compute_dtype=jnp.bfloat16)
    want = jcascade.linear_abstract(64, 40, jcfg, use_bias=bias)
    tcfg = CascadeConfig(mode=mode, group_size=16, compute_dtype=torch.bfloat16)
    got = tcascade.linear_abstract(64, 40, tcfg, use_bias=bias)
    made = tcascade.linear_init(torch.Generator().manual_seed(0), 64, 40, tcfg, use_bias=bias,
                                device="cpu")
    assert set(got) == set(want) == set(made)
    for k in got:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape) == tuple(made[k].shape)
        assert got[k].dtype == made[k].dtype
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


# ---------------------------------------------------------------------------
# whole models: QAT logits and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's smoke params (f32) and its jitted QAT value-and-grad
    of the mean token cross entropy."""
    cfg, jm = jregistry.load(arch, smoke=True)
    jp = jax.jit(lambda k: jm.init_params(k, J_QAT))(jax.random.PRNGKey(0))

    def loss(p, toks, labels):
        logits = jm.forward(p, {"tokens": toks}, J_QAT)
        return jloop.cross_entropy(logits, labels), logits

    return cfg, jp, jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_qat_logits_and_loss_gradients_equal_jax(arch):
    cfg, jp, vg = _reference(arch)
    toks = _tokens(cfg, 2, 12)
    labels = _tokens(cfg, 2, 12, seed=1)
    (jloss, jlogits), jgrads = vg(jp, jnp.asarray(toks), jnp.asarray(labels))
    _, tm = registry.load(arch, smoke=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for leaf in T.leaves(tp):
        leaf.requires_grad_(True)
    ops.reset_launch_counts()
    logits = tm.forward(tp, {"tokens": _t(toks)}, dataclasses.replace(T_QAT, use_kernel=True))
    loss = tloop.cross_entropy(logits, _t(labels))
    grads = torch.autograd.grad(loss, T.leaves(tp))
    assert not any(ops.LAUNCHES.values())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = T.leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), device="cpu"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        scale = float(w.abs().max()) + 1e-6
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-v2-236b"])
def test_remat_gradients_equal_the_unchecked_ones_bit_for_bit(arch):
    """Each layer checkpointed under each policy: the same loss and the same
    gradients, bit for bit, as the forward without remat."""
    cfg, tm = registry.load(arch, smoke=True)
    tp = tm.init_params(0, T_QAT, device="cpu")
    for leaf in T.leaves(tp):
        leaf.requires_grad_(True)
    batch = {"tokens": _t(_tokens(cfg, 2, 10))}
    labels = _t(_tokens(cfg, 2, 10, seed=1))

    def grads(**kw):
        loss = tloop.cross_entropy(tm.forward(tp, batch, T_QAT, **kw), labels)
        return [loss] + list(torch.autograd.grad(loss, T.leaves(tp)))

    want = grads()
    for policy in ("dots", "none", "save_all"):
        got = grads(remat=True, remat_policy=policy)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), policy
    with pytest.raises(ValueError):
        grads(remat=True, remat_policy="everything")


@pytest.fixture
def kernel_route_on_cpu(monkeypatch):
    """The wrappers' kernel route taken on the CPU, each kernel replaced by
    its plain version: what a card run does around its kernels (the
    straight-through and plain-gradient functions, the launch counts)."""
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import norm as nrm
    monkeypatch.setattr(ops, "_route", lambda t: "cuda")
    monkeypatch.setattr(fq, "fake_quant_fp4_cuda", fq.fake_quant_fp4_plain)
    monkeypatch.setattr(fa, "flash_attention_cuda", fa.flash_attention_plain)
    for name in ("norm", "add_norm", "gated_norm"):
        monkeypatch.setattr(nrm, f"{name}_cuda", getattr(nrm, f"{name}_plain"))
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("policy", [None, "dots", "none"])
def test_kernel_route_gradients_and_launches_per_step(kernel_route_on_cpu, policy):
    """Smoke phi4-mini through the wrappers' kernel route: the loss equals
    the plain route's bit for bit and the gradients within 1e-5 of each
    leaf's largest (the norm and attention gradients are their plain
    versions', summed into the residual stream in another order), and a
    step launches the fake quantization 7 times a layer, twice over under
    remat (the recompute)."""
    cfg, tm = registry.load("phi4-mini-3.8b", smoke=True)
    tp = tm.init_params(0, T_QAT, device="cpu")
    for leaf in T.leaves(tp):
        leaf.requires_grad_(True)
    batch = {"tokens": _t(_tokens(cfg, 2, 10))}
    labels = _t(_tokens(cfg, 2, 10, seed=1))
    kw = {} if policy is None else {"remat": True, "remat_policy": policy}

    def run(ccfg):
        loss = tloop.cross_entropy(tm.forward(tp, batch, ccfg, **kw), labels)
        return [loss] + list(torch.autograd.grad(loss, T.leaves(tp)))

    want = run(T_QAT)
    assert not any(ops.LAUNCHES.values())
    got = run(dataclasses.replace(T_QAT, use_kernel=True))
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    passes = 1 if policy is None else 2
    assert ops.LAUNCHES["fake_quant_fp4"] == passes * 7 * cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == passes * cfg.n_layers
    assert ops.LAUNCHES["norm"] == passes * 2 * cfg.n_layers + 1


def test_plain_gradients_run_inside_their_profiler_range(kernel_route_on_cpu):
    """Each norm and flash-attention call autograd recorded on the kernel
    route gives its gradient inside ``ops.PLAIN_GRADIENT`` (its plain
    forward's recompute inside the ``.recompute`` range), once a call, so a
    profiled train step reads their device time apart."""
    from torch.profiler import ProfilerActivity, profile
    cfg, tm = registry.load("phi4-mini-3.8b", smoke=True)
    tp = tm.init_params(0, T_QAT, device="cpu")
    for leaf in T.leaves(tp):
        leaf.requires_grad_(True)
    ccfg = dataclasses.replace(T_QAT, use_kernel=True)
    loss = tloop.cross_entropy(tm.forward(tp, {"tokens": _t(_tokens(cfg, 2, 10))}, ccfg),
                               _t(_tokens(cfg, 2, 10, seed=1)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(loss, T.leaves(tp))
    counts = {ev.key: ev.count for ev in prof.key_averages()
              if ev.key.startswith(ops.PLAIN_GRADIENT)}
    calls = cfg.n_layers + 2 * cfg.n_layers + 1      # flash, two norms a layer, the final
    assert counts == {ops.PLAIN_GRADIENT: calls, ops.PLAIN_GRADIENT + ".recompute": calls}
