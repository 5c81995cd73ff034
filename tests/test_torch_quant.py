"""The port's FP4 codec and PTQ against the JAX reference: exact equality."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import quant as jq
from repro_torch.core import quant as tq

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_decode_all_16_codes_exact():
    codes = np.arange(16, dtype=np.uint8)
    ref = np.asarray(jq.fp4_decode(jnp.asarray(codes)))
    out = tq.fp4_decode(_t(codes)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(tq.fp4_encode(_t(out)).numpy(), codes)


def _grid_inputs():
    mags = np.array(jq.FP4_VALUES, np.float32)
    mids = (mags[1:] + mags[:-1]) / 2
    eps = np.float32(1e-3)
    pts = np.concatenate([mags, mids, mids + eps, mids - eps, [7.0, 100.0, 1e30]])
    pts = pts.astype(np.float32)
    return np.concatenate([pts, -pts, np.linspace(-8, 8, 1001, dtype=np.float32),
                           np.array([0.0, -0.0], np.float32)])


def test_encode_and_round_match_reference_on_every_midpoint():
    x = _grid_inputs()
    np.testing.assert_array_equal(tq.fp4_encode(_t(x)).numpy(),
                                  np.asarray(jq.fp4_encode(jnp.asarray(x))))
    np.testing.assert_array_equal(tq.fp4_round(_t(x)).numpy(),
                                  np.asarray(jq.fp4_round(jnp.asarray(x))))
    # ties go to the even code
    assert tq.fp4_round(_t(np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0],
                                    np.float32))).tolist() == [0.0, 1.0, 1.0, 2.0, 2.0, 4.0, 4.0]


def test_round_keeps_nan_like_reference_grid_rounding(monkeypatch):
    """The reference's grid-rounding fallback (taken when jax lacks
    float4_e2m1fn) saturates like the port on +/-inf and large values; on NaN
    it keeps NaN, where the port follows the native cast the reference takes
    on current jax (NaN -> -0, see the test below)."""
    monkeypatch.setattr(jq, "HAS_NATIVE_FP4", False)
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 6.5, -1e9, 0.3], np.float32)
    want = np.asarray(jq.fp4_round(jnp.asarray(x)))
    got = tq.fp4_round(_t(x)).numpy()
    np.testing.assert_array_equal(got[2:], want[2:])
    assert np.isnan(want[:2]).all()
    assert (got[:2] == 0).all() and np.signbit(got[:2]).all()


def test_round_and_encode_match_reference_as_installed_on_nan_and_inf():
    """E2M1 has no NaN: the reference's native ``float4_e2m1fn`` cast rounds
    a NaN of either sign to -0, and ``fp4_encode`` then takes the sign bit of
    the input (+NaN -> code 0, -NaN -> code 8). Held against the reference as
    it runs here, and against the pinned values whatever jax is installed."""
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 7.0, -7.0, 0.0, -0.0], np.float32)
    got_round = tq.fp4_round(_t(x)).numpy()
    got_code = tq.fp4_encode(_t(x)).numpy()
    want_round = np.array([-0.0, -0.0, 6.0, -6.0, 6.0, -6.0, 0.0, -0.0], np.float32)
    np.testing.assert_array_equal(got_round, want_round)
    np.testing.assert_array_equal(np.signbit(got_round), np.signbit(want_round))
    np.testing.assert_array_equal(got_code, [0, 8, 7, 15, 7, 15, 0, 8])
    if jq.HAS_NATIVE_FP4:
        ref_round = np.asarray(jq.fp4_round(jnp.asarray(x)))
        np.testing.assert_array_equal(got_round, ref_round)
        np.testing.assert_array_equal(np.signbit(got_round), np.signbit(ref_round))
        np.testing.assert_array_equal(got_code, np.asarray(jq.fp4_encode(jnp.asarray(x))))


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (10, 7)).astype(np.uint8)
    packed = tq.pack_fp4(_t(codes)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jq.pack_fp4(jnp.asarray(codes))))
    assert (packed & 0xF).tolist() == codes[0::2].tolist()     # low nibble = even row
    np.testing.assert_array_equal(tq.unpack_fp4(_t(packed)).numpy(), codes)


@pytest.mark.parametrize("k,n,group", [(64, 48, 0), (63, 37, 0), (1, 5, 0),
                                       (64, 33, 16), (96, 20, 32), (12, 10, 3)])
def test_quantize_weight_matches_reference(k, n, group):
    rng = np.random.default_rng(k * 1000 + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0                                    # an all-zero column: scale 1
    pj, sj = jq.quantize_weight(jnp.asarray(w), group)
    pt, st = tq.quantize_weight(_t(w), group)
    assert pt.dtype == torch.uint8 and st.dtype == torch.float32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tq.dequantize_weight(pt, st, torch.float32).numpy(),
        np.asarray(jq.dequantize_weight(pj, sj, jnp.float32)))


def test_quantize_rejects_odd_k_with_groups():
    with pytest.raises(ValueError):
        tq.quantize_weight(torch.zeros(7, 4), group_size=7)


# ---------------------------------------------------------------------------
# the CASCADE oracles and QAT fake quantization: bit for bit
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _special_f32() -> np.ndarray:
    """Random normals at many scales, subnormals, +/-0, +/-inf and NaNs of
    both signs, some with payloads only in the low mantissa bits."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4000) * np.exp2(rng.integers(-30, 30, 4000))).astype(np.float32)
    sub = (rng.integers(1, 1 << 23, 200, dtype=np.uint32)
           | (rng.integers(0, 2, 200, dtype=np.uint32) << 31)).view(np.float32)
    nans = np.array([0x7fc00000, 0xffc00000, 0x7f800001, 0xff800003, 0x7fa00000,
                     0x7f800100], np.uint32).view(np.float32)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, 448.0, -448.0, 449.0, 1e30, 2.0 ** -6,
                     2.0 ** -9, 2.0 ** -10], np.float32)
    return np.concatenate([x, sub, nans, edge])


def test_truncate_mantissa_matches_reference_bit_for_bit_at_every_width():
    x = _special_f32()
    for mbits in range(1, 23):
        want = jq.truncate_mantissa_f32(jnp.asarray(x), mbits)
        got = tq.truncate_mantissa_f32(_t(x), mbits)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"mbits={mbits}")


def test_fp5_products_exhaustive_16x16_bit_for_bit():
    vals = np.asarray(jq.fp4_decode(jnp.arange(16, dtype=jnp.uint8)))
    a, b = np.meshgrid(vals, vals, indexing="ij")
    want = jq.fp5_e3m1_product(jnp.asarray(a), jnp.asarray(b))
    got = tq.fp5_e3m1_product(_t(a), _t(b))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fp8_truncate_sweep_bit_for_bit():
    """Across +/-448 and past it, the subnormal range and its edge, NaN
    (payloads masked to +/-inf as in the reference) and inf."""
    sweep = np.concatenate([np.linspace(-600, 600, 24001, dtype=np.float32),
                            np.linspace(-2.0 ** -5, 2.0 ** -5, 4001, dtype=np.float32),
                            _special_f32()])
    want = jq.fp8_e4m3_truncate(jnp.asarray(sweep))
    got = tq.fp8_e4m3_truncate(_t(sweep))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", ["representable", "well_scaled", "bias_preload"])
def test_cascade_matmul_exact_reference_cases_bit_for_bit(case):
    """The reference's three oracle cases (tests/test_quant.py)."""
    if case == "representable":
        x4, w4, bias = np.ones((2, 16), np.float32), np.full((16, 3), 0.5, np.float32), None
    elif case == "well_scaled":
        x4 = np.asarray(jq.fp4_decode(jq.fp4_encode(
            jax.random.normal(jax.random.PRNGKey(0), (8, 64)) * 0.4)))
        w4 = np.asarray(jq.fp4_decode(jq.fp4_encode(
            jax.random.normal(jax.random.PRNGKey(1), (64, 16)) * 0.4)))
        bias = None
    else:
        x4, w4 = np.ones((2, 4), np.float32), np.ones((4, 3), np.float32)
        bias = np.broadcast_to(np.array([1.0, -1.0, 0.5], np.float32), (2, 3)).copy()
    want = jq.cascade_matmul_exact(jnp.asarray(x4), jnp.asarray(w4),
                                   None if bias is None else jnp.asarray(bias))
    got = tq.cascade_matmul_exact(_t(x4), _t(w4), None if bias is None else _t(bias))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _fp4_valued(rng, shape, scale):
    return np.asarray(jq.fp4_decode(jq.fp4_encode(
        jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)))))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("scale", [0.4, 3.0])
def test_cascade_matmul_exact_random_fp4_inputs_bit_for_bit(bias, scale):
    """Random FP4 operands, 3-D activations, with and without a bias; at scale 3
    the sums saturate at +/-448."""
    rng = np.random.default_rng(int(scale * 10) + bias)
    x4 = _fp4_valued(rng, (2, 3, 96), scale)
    w4 = _fp4_valued(rng, (96, 24), scale)
    b = (rng.standard_normal(24) * 5).astype(np.float32) if bias else None
    want = jq.cascade_matmul_exact(jnp.asarray(x4), jnp.asarray(w4),
                                   None if b is None else jnp.asarray(b))
    got = tq.cascade_matmul_exact(_t(x4), _t(w4), None if b is None else _t(b))
    assert got.shape == (2, 3, 24)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("init", [False, True])
def test_cascade_column_accumulate_bit_for_bit(init):
    """FP5 products summed in FP8 down (4, 5) columns of 40, from a preloaded
    bias or from zero."""
    rng = np.random.default_rng(9 + init)
    prods = np.asarray(jq.fp5_e3m1_product(jnp.asarray(_fp4_valued(rng, (4, 5, 40), 2.0)),
                                           jnp.asarray(_fp4_valued(rng, (4, 5, 40), 2.0))))
    start = (rng.standard_normal((4, 5)) * 3).astype(np.float32) if init else None
    want = jq.cascade_column_accumulate(jnp.asarray(prods),
                                        None if start is None else jnp.asarray(start))
    got = tq.cascade_column_accumulate(_t(prods), None if start is None else _t(start))
    np.testing.assert_array_equal(_bits(got), _bits(want))
