"""``AttnConfig.softmax_scale`` through every attention route of the port,
against the reference's ``attn_apply`` at the same scale.

The reference scales the logits by ``cfg.softmax_scale or 1/sqrt(head_dim)``:
a scale of 0.0 (as None) takes the default. One attention layer, on the
reference's weights, runs a chain of calls on each side, each side carrying
its own cache: a prefill of 6 tokens, an extend of 3, a decode step and a
verify chunk of 3 (the speculative verify pass's attention: an extend of
K + 1 tokens). It runs on a full-attention config and on a windowed one
(the ring cache, ``_ring_attend``), on the plain route (``_sdpa``,
``_masked_attention``) and on the kernel route (``ops.flash_attention`` and
``ops.decode_attention``, whose plain versions run on CPU tensors). Outputs
and caches agree within ``TOL`` (f32 atol/rtol 1e-4, as the port's other
model tests: RoPE, softmax and matmul sums run in another order on the two
sides). The chunked prefill (``_chunked_causal_sdpa``) and a decode on a
cache banded over its time axis (``time_band_attend``, on a gloo world of
one rank) are held the same way.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import layers as jlayers
from repro_torch.convert import params_from_numpy
from repro_torch.core.cascade import CascadeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers as tlayers

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-4, rtol=1e-4)
J_TRAIN = JCascadeConfig(mode="train", compute_dtype=jnp.float32)
DIMS = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
SCALE = 0.37                     # not 1/sqrt(8) = 0.354
#: (mode, tokens) of the chain after the prefill
CHAIN = (("extend", 3), ("decode", 1), ("verify", 3))
PROMPT, MAX_LEN = 6, 16


def _pair(window: int, scale, q_chunk: int = 0):
    jcfg = jlayers.AttnConfig(**DIMS, window=window, softmax_scale=scale, q_chunk=q_chunk)
    tcfg = tlayers.AttnConfig(**DIMS, window=window, softmax_scale=scale, q_chunk=q_chunk)
    jp = jlayers.attn_init(jax.random.PRNGKey(5), jcfg, J_TRAIN)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    n = PROMPT + sum(s for _, s in CHAIN)
    return rng.standard_normal((2, n, DIMS["d_model"])).astype(np.float32)


def _ccfg(use_kernel: bool) -> CascadeConfig:
    return CascadeConfig(mode="train", compute_dtype=torch.float32, use_kernel=use_kernel)


@functools.lru_cache(maxsize=None)
def _chain(window: int, scale, use_kernel: bool):
    """Each call's (port, reference) outputs and caches (read only)."""
    jcfg, jp, tcfg, tp = _pair(window, scale)
    x = _inputs()
    ccfg = _ccfg(use_kernel)
    want, jc = jlayers.attn_apply(jp, jnp.asarray(x[:, :PROMPT]), jcfg, J_TRAIN, mode="prefill",
                                  max_len=MAX_LEN)
    got, tc = tlayers.attn_apply(tp, torch.from_numpy(x[:, :PROMPT].copy()), tcfg, ccfg,
                                 mode="prefill", max_len=MAX_LEN)
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    out = [("prefill", got, want, snap(tc), jc)]
    lo = PROMPT
    for mode, s in CHAIN:
        m = "extend" if mode == "verify" else mode
        chunk = x[:, lo:lo + s]
        want, jc = jlayers.attn_apply(jp, jnp.asarray(chunk), jcfg, J_TRAIN, cache=jc, mode=m)
        got, tc = tlayers.attn_apply(tp, torch.from_numpy(chunk.copy()), tcfg, ccfg, cache=tc,
                                     mode=m)
        out.append((mode, got, want, snap(tc), jc))
        lo += s
    return out


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("scale", [SCALE, 0.0], ids=["scale", "zero"])
@pytest.mark.parametrize("window", [0, 4], ids=["full", "window"])
def test_softmax_scale_matches_the_reference_in_every_mode(window, scale, use_kernel):
    for mode, got, want, tc, jc in _chain(window, scale, use_kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=mode, **TOL)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       err_msg=f"{mode}/{name}", **TOL)


@pytest.mark.parametrize("window", [0, 4], ids=["full", "window"])
def test_a_zero_scale_is_the_default_and_another_scale_is_not(window):
    """0.0 falls back to 1/sqrt(head_dim), as the reference's ``or`` does: the
    port's chain bit for bit with None's; the non-default scale moves every
    output."""
    default = _chain(window, None, True)
    for (_, got, *_), (_, ref, *_) in zip(_chain(window, 0.0, True), default):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    for (mode, got, *_), (_, ref, *_) in zip(_chain(window, SCALE, True), default):
        assert not torch.allclose(got, ref, atol=1e-3), mode


def test_chunked_prefill_takes_the_scale():
    """``q_chunk`` (long prefill over query chunks, ``_chunked_causal_sdpa``)
    at the non-default scale, full and windowed, against the reference."""
    x = _inputs(1)[:, :8]
    for window in (0, 4):
        jcfg, jp, tcfg, tp = _pair(window, SCALE, q_chunk=2)
        want, _ = jlayers.attn_apply(jp, jnp.asarray(x), jcfg, J_TRAIN, mode="full")
        got, _ = tlayers.attn_apply(tp, torch.from_numpy(x.copy()), tcfg, _ccfg(False),
                                    mode="full")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def time_banded_policy():
    """A gloo world of this process alone, and a policy whose k/v cache is
    banded over its time axis (here one band: ``time_band_attend`` and the
    bands' merge run as on a wider mesh)."""
    import torch.distributed as dist
    meshlib.init_world(0, 1, meshlib.free_port())
    pol = sharding.ActivationPolicy(meshlib.make_mesh((1, 1), ("data", "model")), "cascade")
    pol._cache_bands = {"k": -3, "v": -3}
    yield pol
    dist.destroy_process_group()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
def test_decode_on_a_time_banded_cache_takes_the_scale(time_banded_policy, use_kernel):
    jcfg, jp, tcfg, tp = _pair(0, SCALE)
    x = _inputs(2)
    _, jc = jlayers.attn_apply(jp, jnp.asarray(x[:, :PROMPT]), jcfg, J_TRAIN, mode="prefill",
                               max_len=MAX_LEN)
    tc = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jc.items()}
    step = x[:, PROMPT:PROMPT + 1]
    want, jc = jlayers.attn_apply(jp, jnp.asarray(step), jcfg, J_TRAIN, cache=jc, mode="decode")
    with sharding.activation_policy(time_banded_policy):
        got, tc = tlayers.attn_apply(tp, torch.from_numpy(step.copy()), tcfg, _ccfg(use_kernel),
                                     cache=tc, mode="decode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


def test_the_field_sits_where_the_reference_has_it():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(tlayers.AttnConfig) == names(jlayers.AttnConfig)
