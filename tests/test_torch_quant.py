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
