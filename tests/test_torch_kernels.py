"""The port's kernel modules against the JAX kernels and their oracles.

On the CPU the plain versions are held to ``repro.kernels.ops`` (Pallas in
interpret mode) and ``repro.kernels.ref`` at atol/rtol 1e-5 in f32: the
same products summed in another order. Flash attention is also held, with a
per-row ``q_offset``, to the reference's own offset-causal attention
(``layers._chunked_causal_sdpa``) at the same tolerance. For the SSD scan the state update is
elementwise (the same f32 operations, exp to within an ulp) and only the
readout ``state @ C`` sums over N in another order, so it is held at
atol/rtol 1e-5 too, over up to 128 carried steps. The norm's plain version is
held to the reference's ``layers.norm_apply``: at 1e-5 in f32 (the mean
sums in another order), within one bf16 step when the rows are bf16.
``test_torch_gpu.py`` holds each CUDA kernel to its plain version on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.core import quant as tq
from repro_torch.kernels import cascade_exact as tce
from repro_torch.kernels import cascade_matmul as tcm
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import fake_quant as tfq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import norm as tnorm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-5, rtol=1e-5)

# (M, K, N, group, bias): odd K, N and K tails off every tile, G > 1 (with an
# odd group size), no bias; a verify pass's 40 rows, the 64 one block holds
# and 65, which takes a second block row (with groups of 24 rows, off the
# 16-row step)
MATMUL_CASES = [
    (3, 64, 48, 0, True),
    (5, 63, 37, 0, False),
    (4, 96, 100, 24, True),
    (1, 130, 70, 65, False),
    (7, 258, 301, 0, True),
    (40, 130, 70, 0, True),
    (64, 63, 37, 0, False),
    (65, 96, 100, 24, True),
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
    assert tops.LAUNCHES == {"cascade_matmul": 0, "cascade_matmul_exact": 0,
                             "cascade_matmul_grouped": 0, "decode_attention": 0,
                             "fake_quant_fp4": 0, "flash_attention": 0, "norm": 0,
                             "ssd_scan": 0}


def test_cascade_matmul_plan_holds_all_of_m_up_to_64_rows_in_one_block():
    """m-tiles of 16 rows a block and block rows, from the shapes alone: one
    scale group (the serving path) up to 4 m-tiles, so every call up to 64
    rows reads the weights once; more than one group up to 2."""
    ms = (1, 8, 16, 17, 32, 40, 48, 64, 65, 200)
    want_mt = (1, 1, 1, 2, 2, 3, 3, 4, 4, 4)
    want_y = (1, 1, 1, 1, 1, 1, 1, 1, 2, 4)
    for group in (0, 4096):
        got = [tcm.plan(m, 4096, 13440, group) for m in ms]
        assert [p["m_tiles"] for p in got] == list(want_mt)
        assert [p["grid"] for p in got] == [(420, y) for y in want_y]
    grouped = [tcm.plan(m, 96, 100, 24) for m in ms]
    assert [p["m_tiles"] for p in grouped] == [1, 1, 1, 2, 2, 2, 2, 2, 2, 2]
    assert [p["grid"][1] for p in grouped] == [1, 1, 1, 1, 1, 2, 2, 2, 3, 7]
    assert tcm.plan(8, 4096, 4096)["grid"] == (128, 1)
    assert tcm.plan(40, 2048, 1030)["grid"] == (33, 1)


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


def _q_pos_case(b, t, seed):
    """Per-row positions: past T (the clamped write: every row live), -1
    (nothing live), 0, and the rest spread over T."""
    q_pos = np.random.default_rng(seed).integers(0, t, b).astype(np.int32)
    q_pos[:3] = [t + 3, -1, 0]
    return q_pos


# (B, Hq, Hkv, T, D): MHA, G = 3 (phi4-mini's group), G = 5 (qwen2.5-32b's)
Q_POS_CASES = [(4, 4, 4, 40, 16), (5, 6, 2, 37, 16), (4, 10, 2, 70, 32)]


@pytest.mark.parametrize("b,hq,hkv,t,d", Q_POS_CASES)
@pytest.mark.parametrize("with_mask", [False, True])
def test_decode_attention_q_pos_matches_jax(b, hq, hkv, t, d, with_mask):
    """Key t live iff t <= q_pos[b] (and the mask, when given): the plain
    version and the wrapper against the reference oracle and the exact
    Pallas kernel fed the equivalent mask (every row), and against the
    streaming Pallas kernel on the rows with a live key (its 0/0 on a row
    with none is NaN; the reference averages v uniformly over T there)."""
    q, k, v, mask = _attn_case(b, hq, hkv, t, d, seed=hq)
    q_pos = _q_pos_case(b, t, seed=t)
    live = np.arange(t)[None, :] <= q_pos[:, None]
    if with_mask:
        live &= mask
        mask[0, 0] = False       # a hole in the row that q_pos leaves whole
        live[0, 0] = False
    args = [jnp.asarray(a) for a in (q, k, v, live)]
    want_ref = np.asarray(jref.decode_attention_ref(*args))
    want_exact = np.asarray(jops.decode_attention(*args, interpret=True))
    from repro.kernels.flash_attention import decode_attention_pallas
    want_stream = np.asarray(decode_attention_pallas(*args, block_t=16, interpret=True))
    tmask = _t(mask) if with_mask else None
    got = tda.decode_attention_plain(_t(q), _t(k), _t(v), tmask, q_pos=_t(q_pos))
    via_ops = tops.decode_attention(_t(q), _t(k), _t(v), tmask, q_pos=_t(q_pos))
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    assert torch.equal(via_ops, got)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got.numpy(), want_exact, **TOL)
    some = live.any(axis=1)
    assert not some[1] and some.sum() >= b - 1
    np.testing.assert_allclose(got.numpy()[some], want_stream[some], **TOL)
    # the row with nothing live averages v uniformly over all T
    g = hq // hkv
    np.testing.assert_allclose(got.numpy()[1], np.repeat(v[1].mean(0), g, axis=0), **TOL)
    # q_pos past T is every row: the mask alone (or no mask) gives the same
    whole = tda.decode_attention_plain(_t(q), _t(k), _t(v), tmask)
    torch.testing.assert_close(got[0], whole[0], atol=0, rtol=0)


def test_decode_attention_refuses_a_bad_q_pos():
    """q_pos must be a (B,) int32 tensor on q's device, on either route."""
    q, k, v = (torch.zeros(2, 4, 16), torch.zeros(2, 5, 2, 16), torch.zeros(2, 5, 2, 16))
    good = torch.tensor([1, 4], dtype=torch.int32)
    tops.decode_attention(q, k, v, q_pos=good)
    for bad, what in ((good.long(), "int32"), (good[:1], r"\(2,\)"),
                      (good[:, None], r"\(2,\)"), (good.to("meta"), "meta")):
        with pytest.raises(ValueError, match=what):
            tops.decode_attention(q, k, v, q_pos=bad)
        with pytest.raises(ValueError, match=what):
            tda.decode_attention_plain(q, k, v, None, None, bad)


def test_decode_attention_splits_and_heads_per_block_follow_the_shapes():
    """The split count comes from the shapes alone: one split where the
    (slot, kv head) blocks fill the card or T is short (the served decode
    step), several for a long cache over few blocks; a group over 8 query
    heads takes equal chunks of at most 8."""
    assert [tda.heads_per_block(g) for g in (1, 3, 5, 8, 10, 16, 17)] == [1, 3, 5, 8, 5, 8, 6]
    assert tda.choose_splits(8, 32, 1, 192) == 1           # codeqwen decode step
    assert tda.choose_splits(8, 8, 5, 192) == 1            # qwen2.5-32b heads, short T
    assert tda.choose_splits(8, 32, 1, 4096) == 9          # long context
    assert tda.choose_splits(2, 8, 5, 4096) == 16          # few blocks, long T
    assert tda.choose_splits(1, 1, 1, 1 << 20) == 32       # capped


# (b, k, n, group): the chip smoke's fake-quant weights (phi4-mini's q/o,
# k/v, gate/up, down; codeqwen's up; a group of 32; the olmoe expert stack)
# and the card tests' other cases (groups a cluster splits unevenly, groups
# that do not divide K, N off the 16-byte vector; groups taller than a
# cluster holds in one chunk: nemotron4-15b's and qwen2.5-32b's down
# projections at group 0, and one with one-element copies)
FQ_PLAN_PHI4 = [(1, 3072, 3072, 0), (1, 3072, 1024, 0), (1, 3072, 8192, 0), (1, 8192, 3072, 0)]
FQ_PLAN_CASES = FQ_PLAN_PHI4 + [
    (1, 4096, 13440, 0), (1, 3072, 8192, 32), (64, 2048, 1024, 0), (1, 3000, 1024, 0),
    (1, 3001, 200, 0), (1, 96, 40, 64), (1, 96, 24, 16), (1, 64, 37, 0), (1, 40, 5, 8),
    (1, 24576, 6144, 0), (1, 27648, 5120, 0), (1, 24576, 37, 0)]


@pytest.mark.parametrize("b,k,n,group", FQ_PLAN_CASES)
@pytest.mark.parametrize("elsize", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_fake_quant_plan_tiles_each_group_over_a_portable_cluster(b, k, n, group, elsize,
                                                                  aligned):
    """Each group's rows are split over at most 8 blocks of one cluster, in
    consecutive runs that tile them exactly (none empty), each within its
    threads' copies; a block's slab (one of its two shared-memory buffers)
    is at most 64 KB; the strips cover N; 16-byte copies only where a row
    is aligned; an item is a (strip, group, matrix); a group of up to
    16,384 rows is held in one chunk (read once), a taller one in chunks of
    at most 8 copies a thread (64 one-element ones) over a cluster of 8."""
    g = tq.fake_quant_groups(k, group)
    pl = tfq.plan(b, k, n, g, elsize, aligned)
    s, rows = pl["cluster"], pl["rows"]
    assert 1 <= s <= tfq.MAX_CLUSTER
    spans = [(q * rows, min(g, (q + 1) * rows)) for q in range(s)]
    assert spans[0][0] == 0 and spans[-1][1] == g
    assert all(lo < hi for lo, hi in spans) and all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    assert pl["lanes"] * pl["loads"] * pl["chunks"] >= rows
    assert pl["lanes"] * pl["tpr"] == tfq.THREADS
    if g <= 16384:
        assert pl["chunks"] == 1
    else:
        assert pl["chunks"] > 1 and s == tfq.MAX_CLUSTER
        assert pl["loads"] <= (tfq.LOADS_PREFERRED if pl["vec"] > 1 else tfq.SCALAR_LOADS_MAX)
    vec_ok = aligned and (n * elsize) % 16 == 0
    assert pl["vec"] == (16 // elsize if vec_ok else 1)
    assert pl["loads"] <= (tfq.LOADS_MAX if pl["vec"] > 1 else tfq.SCALAR_LOADS_MAX)
    assert pl["slab_bytes"] == tfq.THREADS * pl["loads"] * pl["vec"] * elsize <= 64 * 1024
    assert pl["cols"] <= 64 and (pl["strips"] - 1) * pl["cols"] < n <= pl["strips"] * pl["cols"]
    assert pl["items"] == pl["strips"] * (k // g) * b and pl["slabs"] == pl["items"] * s


@pytest.mark.parametrize("b,k,n,group", FQ_PLAN_PHI4 + [(1, 3072, 8192, 32)])
@pytest.mark.parametrize("elsize", [2, 4])
def test_fake_quant_plan_gives_phi4_mini_two_slabs_an_sm(b, k, n, group, elsize):
    """At phi4-mini's weights every SM gets at least two blocks' worth of
    work, in 16-byte copies of slabs of at most 8 copies a thread."""
    pl = tfq.plan(b, k, n, tq.fake_quant_groups(k, group), elsize)
    assert pl["slabs"] >= 2 * tfq.SMS and pl["vec"] == 16 // elsize and pl["loads"] <= 8


@pytest.mark.parametrize("m", [1, 8, 9, 20, 40, 128])
@pytest.mark.parametrize("n", [7, 1000, 4096])
def test_cascade_exact_plan_covers_every_output_once(m, n):
    """Every (row, column) of the output is one thread's, once: a block's
    warps take consecutive runs of ``rows`` rows over its 32 columns."""
    pl = tce.plan(m, n)
    gx, gy = pl["grid"]
    assert pl["threads"] == 32 * pl["warps"] <= 256 and pl["block_rows"] <= 32
    hits = np.zeros((m, n), dtype=np.int64)
    for by in range(gy):
        for warp in range(pl["warps"]):
            for r in range(pl["rows"]):
                row = by * pl["block_rows"] + warp * pl["rows"] + r
                if row < m:
                    hits[row, :] += 1
    assert (hits == 1).all() and gx * tce.COLS >= n > (gx - 1) * tce.COLS
    assert pl["rows"] == (1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8)


# the shapes of the reference's own flash kernel tests (tests/test_kernels.py):
# MHA, GQA (group 2) and MQA
FLASH_CASES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 64)]


@pytest.mark.parametrize("b,hq,hkv,s,d", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax(b, hq, hkv, s, d, causal):
    rng = np.random.default_rng(b * 7 + s)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    args = [jnp.asarray(a) for a in (q, k, v)]
    want_kernel = np.asarray(jops.flash_attention(*args, causal=causal, block_q=64,
                                                  block_k=64, interpret=True))
    want_ref = np.asarray(jref.flash_attention_ref(*args, causal=causal))
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (b, hq, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_flash_attention_returns_the_query_dtype():
    """bf16 in, bf16 out (the TPU kernel writes q's dtype): the f32 result
    rounded once, as the reference oracle rounds it."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 4, 16, 32)).astype(np.float32) for _ in range(3))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tops.flash_attention(*bf)
    want = jref.flash_attention_ref(*[jnp.asarray(a.float().numpy()) for a in bf])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.bfloat16),
                                                               dtype=np.float32), atol=1e-2)


@pytest.mark.parametrize("b,hq,hkv,s,t", [(4, 4, 2, 5, 40), (2, 4, 4, 8, 24), (3, 2, 1, 1, 9)])
def test_flash_attention_per_row_offset_matches_reference_extend(b, hq, hkv, s, t):
    """Query i of row b at cache position q_offset[b] + i sees keys <= it:
    the reference's extend attention, held row by row to its offset-causal
    ``_chunked_causal_sdpa``. Offsets span 0 to past T - s (rows whose
    mask is clipped at the cache end)."""
    rng = np.random.default_rng(b * 10 + s)
    d = 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)      # the model's (B, S, H, D)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)     # a (B, T, Hkv, D) cache
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    off = np.linspace(0, t - 1, b).astype(np.int32)
    scale = 1.0 / np.sqrt(d)
    want = np.concatenate([np.asarray(jlayers._chunked_causal_sdpa(
        jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1]), jnp.asarray(v[i:i + 1]), scale, s,
        0, q_offset=int(off[i]))) for i in range(b)])
    got = tops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                               _t(v).transpose(1, 2), scale=scale, q_offset=_t(off))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **TOL)
    # q_offset zero is the plain causal mask
    np.testing.assert_array_equal(
        tops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
                             q_offset=torch.zeros(b, dtype=torch.int32)).numpy(),
        tops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                             _t(v).transpose(1, 2)).numpy())


def test_flash_attention_plan_follows_the_shapes():
    """Heads per block, positions per block, query tiles and splits come from
    the shapes alone: a block holds 64 (position, head) rows over one KV
    head's query heads (a group over 16 in equal chunks); a grid under the
    card's 132 SMs over at least 256 keys splits each block's keys, up to
    two blocks an SM, each split at least 64 keys and 16 splits at most; a
    grid that fills the card, or fewer keys, keeps one split. T is the live
    cache prefix the engine hands in, so an admission chunk splits once its
    position passes 224."""
    assert [tfa.heads_per_block(g) for g in (1, 3, 5, 8, 16, 17, 20, 40)] == \
        [1, 3, 5, 8, 16, 9, 10, 14]
    cases = {   # (B, Hq, Hkv, S, T) -> (heads, positions, query tiles, splits)
        (8, 32, 32, 5, 192): (1, 64, 1, 1),       # codeqwen verify: 256 blocks
        (1, 32, 32, 32, 192): (1, 64, 1, 1),      # admission chunk, 192 live keys
        (1, 32, 32, 32, 255): (1, 64, 1, 1),
        (1, 32, 32, 32, 256): (1, 64, 1, 4),      # 4 splits of 64 keys
        (1, 32, 32, 32, 512): (1, 64, 1, 8),      # 256 blocks: two an SM
        (1, 32, 32, 32, 4096): (1, 64, 1, 8),
        (1, 32, 32, 2048, 2048): (1, 64, 32, 1),  # long prompt
        (1, 32, 32, 128, 128): (1, 64, 2, 1),     # 64 blocks, 128 keys
        (1, 24, 8, 512, 512): (3, 21, 25, 1),     # GQA 24/8: 200 blocks
        (8, 40, 8, 5, 192): (5, 12, 1, 1),        # qwen2.5-32b verify: 64 blocks
        (8, 40, 8, 5, 4096): (5, 12, 1, 4),       # ... late in a long cache
        (1, 40, 8, 32, 192): (5, 12, 3, 1),       # qwen2.5-32b admission chunk
        (1, 8, 8, 64, 4096): (1, 64, 1, 16),      # few blocks, long T: capped
        (2, 8, 2, 64, 2048): (4, 16, 4, 16),      # G = 4 over a 2048-row cache: 16 blocks
        (1, 1, 1, 1, 1 << 16): (1, 64, 1, 16),    # capped
        (2, 4, 2, 9, 24): (2, 32, 1, 1),          # T within one tile
    }
    for (b, hq, hkv, s, t), want in cases.items():
        pl = tfa.plan(b, hq, hkv, s, t)
        got = (pl["heads_per_block"], pl["positions_per_block"], pl["q_tiles"], pl["splits"])
        assert got == want, ((b, hq, hkv, s, t), pl)
        assert pl["blocks"] == b * hkv * -(-(hq // hkv) // got[0]) * got[2] * got[3]
        assert got[1] == 64 // got[0]
    assert tfa.plan(1, 8, 8, 64, 4096, sms=8)["splits"] == 1


# (B, Hq, Hkv, S, T, causal): one split's keys within a tile, G = 3 and 5 with
# positions off the 64-row block, MQA not causal, and two at the TPU kernel's
# own signature (T = S, offset 0)
SPLIT_CASES = [(2, 4, 2, 9, 24, True), (1, 6, 2, 70, 130, True), (3, 10, 2, 5, 200, True),
               (1, 8, 1, 48, 48, False), (2, 6, 2, 64, 64, True)]


@pytest.mark.parametrize("b,hq,hkv,s,t,causal", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, 3, 16])
def test_flash_attention_split_and_merge_matches_plain_and_jax(b, hq, hkv, s, t, causal, splits):
    """The kernel's split route in plain PyTorch (each block's visible keys
    cut into equal shares of 16-key tiles, partials merged with weights
    exp2(m_s - m); empty splits weigh 0) equals the unsplit plain version
    and the TPU kernel in interpret mode at f32, atol/rtol 1e-5: the same
    products, sums in another order. Per-row offsets where T > S."""
    rng = np.random.default_rng(b * 31 + s + splits)
    d = 16
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    off = np.linspace(0, t - s, b).astype(np.int32) if causal else np.zeros(b, np.int32)
    got = tfa.split_plain(_t(q), _t(k), _t(v), splits, causal, None, _t(off), keys_per_tile=16)
    want = tfa.flash_attention_plain(_t(q), _t(k), _t(v), causal, None, _t(off))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    if t == s:      # the TPU kernel's own signature (offset 0)
        jk = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, block_q=16, block_k=16,
                                             interpret=True))
        np.testing.assert_allclose(got.numpy(), jk, **TOL)


def test_flash_attention_merge_weighs_empty_and_masked_splits_zero():
    """A split with no tile (max -inf, sums 0) and one whose keys the row
    cannot see (max -1e30, sums 0) add nothing to the merge."""
    rng = np.random.default_rng(3)
    acc = _t(rng.standard_normal((2, 1, 4)).astype(np.float32))
    m = _t(np.array([[1.5], [-2.0]], np.float32))
    l = _t(np.array([[3.0], [0.5]], np.float32))
    want = acc[:, 0] / l
    zeros = torch.zeros((2, 1, 4))
    for dead in (-float("inf"), -1e30):
        got = tfa.merge_partials(torch.cat([acc, zeros], 1), torch.cat([m, torch.full_like(m, dead)], 1),
                                 torch.cat([l, torch.zeros_like(l)], 1))
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# (leading shape, d): decode's B rows, a verify pass's (B, s) rows, a
# prefill's (B, S) rows, a width off 16 bytes
NORM_CASES = [((8,), 64), ((2, 5), 48), ((3, 4), 128), ((1, 7), 36)]


@pytest.mark.parametrize("lead,d", NORM_CASES)
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_plain_matches_jax(lead, d, norm_type, dtype):
    """The norm kernel's plain version against the reference's
    ``layers.norm_apply``: f32 rows at atol/rtol 1e-5 (the mean and variance
    sum in another order); bf16 rows, both computed in f32 and rounded once,
    within one bf16 step (rtol 2^-7, atol 1e-6)."""
    rng = np.random.default_rng(d + len(lead))
    x = (rng.standard_normal(lead + (d,)) * 3 + 0.5).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    if norm_type == "layernorm":
        params["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    xt = _t(x).to(getattr(torch, dtype))
    got = tnorm.norm_plain(xt, _t(params["scale"]),
                           _t(params["bias"]) if "bias" in params else None, norm_type)
    jx = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = jlayers.norm_apply({k: jnp.asarray(v) for k, v in params.items()}, jx, norm_type)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want = np.asarray(want.astype(jnp.float32))
    tol = TOL if dtype == "float32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the wrapper sends a CPU tensor to the plain version and counts no launch
    tops.reset_launch_counts()
    routed = tops.norm(xt, _t(params["scale"]),
                       _t(params["bias"]) if "bias" in params else None, norm_type=norm_type)
    assert torch.equal(routed, got) and tops.LAUNCHES["norm"] == 0


def _norm_case(lead, d, norm_type, dtype, seed):
    """Rows x and r (or y and z), and norm params, from one numpy seed."""
    rng = np.random.default_rng(seed)
    x, r = ((rng.standard_normal(lead + (d,)) * 3 + 0.5).astype(np.float32) for _ in range(2))
    params = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    if norm_type == "layernorm":
        params["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    xt, rt = (_t(a).to(getattr(torch, dtype)) for a in (x, r))
    jx, jr = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)) for t in (xt, rt))
    tp = (_t(params["scale"]), _t(params["bias"]) if "bias" in params else None)
    return xt, rt, jx, jr, tp, {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("lead,d", NORM_CASES)
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_norm_plain_matches_jax(lead, d, norm_type, dtype):
    """The add-norm form's plain version against the reference's residual
    add ``x + r`` then ``layers.norm_apply``: the sum bit-equal (one
    correctly rounded add on both sides), the norm at the tolerances of
    ``test_norm_plain_matches_jax``; ``ops.add_norm`` sends CPU tensors to
    it and counts no launch."""
    xt, rt, jx, jr, (scale, bias), jp = _norm_case(lead, d, norm_type, dtype, d + 7)
    got, s = tnorm.add_norm_plain(xt, rt, scale, bias, norm_type)
    js = jx + jr
    want = jlayers.norm_apply(jp, js, norm_type)
    assert got.dtype == s.dtype == xt.dtype and got.shape == s.shape == xt.shape
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js.astype(jnp.float32)))
    tol = TOL if dtype == "float32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    tops.reset_launch_counts()
    routed = tops.add_norm(xt, rt, scale, bias, norm_type=norm_type)
    assert torch.equal(routed[0], got) and torch.equal(routed[1], s)
    assert tops.LAUNCHES["norm"] == 0


@pytest.mark.parametrize("lead,d", NORM_CASES)
@pytest.mark.parametrize("dtype,zdtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                          ("float32", "bfloat16")])
def test_gated_norm_plain_matches_jax(lead, d, dtype, zdtype):
    """The gated form's plain version against the reference's Mamba-2 gate
    ``(y * jax.nn.silu(z.f32)).astype(y.dtype)`` then ``layers.norm_apply``
    (RMSNorm), at the tolerances of ``test_norm_plain_matches_jax`` (silu is
    ``z / (1 + exp(-z))`` here and ``z * sigmoid(z)`` there: an f32 ulp
    apart), with z contiguous and as a column slice of a wider buffer, as
    Mamba-2 hands it over, and bf16 beside f32 y (its dual form's output);
    ``ops.gated_norm`` sends CPU tensors to it and counts no launch."""
    yt, zt, jy, _, (scale, _), jp = _norm_case(lead, d, "rmsnorm", dtype, d + 11)
    zt = zt.to(getattr(torch, zdtype))
    jz = jnp.asarray(zt.float().numpy()).astype(getattr(jnp, zdtype))
    want = jlayers.norm_apply(jp, (jy * jax.nn.silu(jz.astype(jnp.float32))).astype(jy.dtype))
    want = np.asarray(want.astype(jnp.float32))
    tol = TOL if dtype == "float32" else dict(atol=1e-6, rtol=2.0 ** -7)
    wide = torch.cat([zt, torch.ones_like(zt)[..., :5]], dim=-1)[..., :d]
    assert wide.reshape(-1, d).stride(0) == d + 5
    for z in (zt, wide):
        got = tnorm.gated_norm_plain(yt, z, scale)
        assert got.dtype == yt.dtype and got.shape == yt.shape
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
        tops.reset_launch_counts()
        assert torch.equal(tops.gated_norm(yt, z, scale), got)
        assert tops.LAUNCHES["norm"] == 0


def test_fused_norm_cuda_refuses_cpu_tensors():
    x, one = torch.zeros(2, 8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        tnorm.add_norm_cuda(x, x, one)
    with pytest.raises(ValueError, match="CUDA"):
        tnorm.gated_norm_cuda(x, x, one)
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        tops.add_norm(meta, meta, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel route"):
        tops.gated_norm(meta, meta, torch.ones(8, device="meta"))


def test_norm_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tnorm.norm_cuda(torch.zeros(2, 8), torch.ones(8))
    with pytest.raises(ValueError, match="no kernel route"):
        tops.norm(torch.zeros(2, 8, device="meta"), torch.ones(8, device="meta"))


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
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_cuda(torch.zeros(1, 1, 2, 4), torch.zeros(1, 1, 2), torch.zeros(2),
                           torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, 1, 4), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(torch.zeros(1, 2, 3, 16), torch.zeros(1, 2, 3, 16),
                                 torch.zeros(1, 2, 3, 16))
    with pytest.raises(ValueError, match="no kernel route"):
        tops.flash_attention(*(torch.zeros(1, 2, 3, 16, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="no kernel route"):
        tops.ssd_scan(torch.zeros(2, 3, 4, device="meta"), torch.zeros(2, 3, device="meta"),
                      torch.zeros(2, device="meta"), torch.zeros(2, 3, 4, device="meta"),
                      torch.zeros(2, 3, 4, device="meta"), torch.ones(2, device="meta"))


# ---------------------------------------------------------------------------
# SSD scan (Mamba-2)
# ---------------------------------------------------------------------------

def _scan_case(bh, s, p, n, seed):
    """The reference's ssd_scan test inputs (tests/test_kernels.py), from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32)   # softplus
    A = (-np.exp(rng.standard_normal(bh) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
    D = rng.standard_normal(bh).astype(np.float32)
    s0 = rng.standard_normal((bh, p, n)).astype(np.float32)
    return x, dt, A, B, C, D, s0


SCAN_CASES = [(2, 64, 8, 4, 16), (4, 128, 16, 8, 32), (1, 32, 32, 16, 32)]


@pytest.mark.parametrize("bh,s,p,n,chunk", SCAN_CASES)
def test_ssd_scan_plain_matches_jax(bh, s, p, n, chunk):
    x, dt, A, B, C, D, _ = _scan_case(bh, s, p, n, seed=bh * 31 + s)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C, D)]
    want_kernel = np.asarray(jops.ssd_scan(*args, chunk=chunk, interpret=True))
    want_ref = np.asarray(jax.vmap(lambda xx, dd, aa, bb, cc, ddk: jref.ssd_scan_ref(
        xx[:, None, :], dd[:, None], aa[None], bb[:, None, :], cc[:, None, :],
        ddk[None])[:, 0, :])(*args))
    got = tops.ssd_scan(*[_t(a) for a in (x, dt, A, B, C, D)])
    assert got.shape == (bh, s, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("bh,s,p,n,chunk", SCAN_CASES)
@pytest.mark.parametrize("with_initial", [False, True])
def test_ssd_scan_plain_carries_state_like_pallas(bh, s, p, n, chunk, with_initial):
    """Initial state in and final state out, against ssd_scan_pallas in
    interpret mode; and the state carried across a split of S gives the
    unsplit run."""
    from repro.kernels.ssd_scan import ssd_scan_pallas

    x, dt, A, B, C, D, s0 = _scan_case(bh, s, p, n, seed=bh * 7 + s)
    init = s0 if with_initial else None
    wy, ws = ssd_scan_pallas(*[jnp.asarray(a) for a in (x, dt, A, B, C, D)], chunk=chunk,
                             interpret=True, return_final_state=True,
                             initial_state=None if init is None else jnp.asarray(init))
    targs = [_t(a) for a in (x, dt, A, B, C, D)]
    tinit = None if init is None else _t(init)
    gy, gs = tops.ssd_scan(*targs, initial_state=tinit, return_final_state=True)
    assert gs.dtype == torch.float32 and gs.shape == (bh, p, n)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    half = s // 2
    xs, dts, bs, cs = targs[0], targs[1], targs[3], targs[4]
    y1, s1 = tops.ssd_scan(xs[:, :half], dts[:, :half], targs[2], bs[:, :half], cs[:, :half],
                           targs[5], initial_state=tinit, return_final_state=True)
    y2, s2 = tops.ssd_scan(xs[:, half:], dts[:, half:], targs[2], bs[:, half:], cs[:, half:],
                           targs[5], initial_state=s1, return_final_state=True)
    assert torch.equal(torch.cat([y1, y2], dim=1), gy) and torch.equal(s2, gs)
    if init is not None:                 # no final state asked: y alone, input untouched
        assert torch.equal(tops.ssd_scan(*targs, initial_state=tinit), gy)
        assert torch.equal(tinit, _t(s0))


def _decode_case(b, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, 1, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, 1, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, 1, g, n)) * 0.3).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, D, state


@pytest.mark.parametrize("b,h,p,g,n", [(3, 4, 16, 1, 8), (2, 4, 8, 2, 16), (8, 8, 64, 1, 128)])
def test_ssd_decode_matches_jax_over_carried_steps(b, h, p, g, n):
    """ops.ssd_decode (the serving decode step: the scan at S = 1 on the slot
    states) against the JAX ops.ssd_decode, carrying the state four steps;
    the in-place write equals the returned state."""
    x, dt, A, B, C, D, state = _decode_case(b, h, p, g, n, seed=b * 10 + g)
    jstate, tstate = jnp.asarray(state), _t(state)
    for _ in range(4):
        wy, ws = jops.ssd_decode(*[jnp.asarray(a) for a in (x, dt, A, B, C, D)], jstate,
                                 interpret=True)
        gy, gs = tops.ssd_decode(*[_t(a) for a in (x, dt, A, B, C, D)], tstate)
        assert gy.shape == (b, 1, h, p) and gs.shape == (b, h, p, n)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
        inplace = tstate.clone()
        gy2, gs2 = tops.ssd_decode(*[_t(a) for a in (x, dt, A, B, C, D)], inplace,
                                   out_state=inplace)
        assert gs2 is inplace and torch.equal(inplace, gs) and torch.equal(gy2, gy)
        jstate, tstate = ws, gs
    assert tops.LAUNCHES["ssd_scan"] == 0        # CPU tensors never launch
