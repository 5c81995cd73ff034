"""The port's kernel modules against the JAX kernels and their oracles.

On the CPU the plain versions are held to ``repro.kernels.ops`` (Pallas in
interpret mode) and ``repro.kernels.ref`` at atol/rtol 1e-5 in f32: the
same products summed in another order. ``test_torch_gpu.py`` holds each
CUDA kernel to its plain version on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cascade_matmul as tcm
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-5, rtol=1e-5)

# (M, K, N, group, bias): odd K, N and K tails off every tile, G > 1 (with an
# odd group size), no bias
MATMUL_CASES = [
    (3, 64, 48, 0, True),
    (5, 63, 37, 0, False),
    (4, 96, 100, 24, True),
    (1, 130, 70, 65, False),
    (7, 258, 301, 0, True),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _fp4_case(m, k, n, group, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    # unit-variance outputs, as the model's 1/sqrt(d_in) init gives
    x = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    packed, scales = jq.quantize_weight(jnp.asarray(w), group)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    return x, np.asarray(packed), np.asarray(scales), bias


@pytest.mark.parametrize("m,k,n,group,with_bias", MATMUL_CASES)
def test_cascade_matmul_plain_matches_jax(m, k, n, group, with_bias):
    x, packed, scales, bias = _fp4_case(m, k, n, group, with_bias)
    jb = None if bias is None else jnp.asarray(bias)
    want_kernel = np.asarray(jops.cascade_matmul(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jb,
        out_dtype=jnp.float32, interpret=True, exact_dequant=True))
    want_ref = np.asarray(jref.cascade_matmul_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jb))
    got = tops.cascade_matmul(_t(x), _t(packed), _t(scales),
                              None if bias is None else _t(bias), out_dtype=torch.float32)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_cascade_matmul_wrapper_flattens_leading_dims_and_counts_no_cpu_launch():
    x, packed, scales, bias = _fp4_case(6, 63, 20, 0, True)
    tops.reset_launch_counts()
    x3 = _t(x).reshape(2, 3, 63)
    got = tops.cascade_matmul(x3, _t(packed), _t(scales), _t(bias), out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 20) and got.dtype == torch.bfloat16
    xp = torch.nn.functional.pad(_t(x), (0, 1))
    want = tcm.cascade_matmul_plain(xp, _t(packed), _t(scales), _t(bias), torch.bfloat16)
    assert torch.equal(got.reshape(6, 20), want)
    assert tops.LAUNCHES == {"cascade_matmul": 0, "decode_attention": 0}


def _attn_case(b, hq, hkv, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, b)
    lens[0] = t                                  # one full row
    lens[-1] = 1                                 # one row live only at t=0
    mask = np.arange(t)[None, :] < lens[:, None]  # ragged, fully masked tails
    mask[1 % b, ::3] = False                     # holes inside a row too
    mask[1 % b, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("b,hq,hkv,t,d", [(3, 8, 2, 700, 16), (2, 4, 4, 37, 32),
                                          (4, 8, 1, 513, 16)])
def test_decode_attention_plain_matches_jax(b, hq, hkv, t, d):
    q, k, v, mask = _attn_case(b, hq, hkv, t, d)
    args = [jnp.asarray(a) for a in (q, k, v, mask)]
    want_kernel = np.asarray(jops.decode_attention(*args, interpret=True))
    want_ref = np.asarray(jref.decode_attention_ref(*args))
    got = tops.decode_attention(_t(q), _t(k), _t(v), _t(mask))
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_decode_attention_fully_masked_row_averages_like_reference():
    q, k, v, mask = _attn_case(2, 4, 2, 9, 16)
    mask[0] = False
    want = np.asarray(jref.decode_attention_ref(*[jnp.asarray(a) for a in (q, k, v, mask)]))
    got = tda.decode_attention_plain(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_refuse_devices_without_a_route():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        tops.cascade_matmul(x, torch.zeros(2, 3, dtype=torch.uint8, device="meta"),
                            torch.ones(1, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tcm.cascade_matmul_cuda(torch.zeros(2, 4), torch.zeros(2, 3, dtype=torch.uint8),
                                torch.ones(1, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_cuda(torch.zeros(1, 2, 4), torch.zeros(1, 3, 2, 4),
                                  torch.zeros(1, 3, 2, 4), torch.ones(1, 3, dtype=torch.bool))
