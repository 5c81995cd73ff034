"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a Hopper card (the
kernels are built for sm_90a). This file imports torch only, so it runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quant
from repro_torch.core.cascade import CascadeConfig
from repro_torch.kernels import cascade_matmul as tcm
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import norm as tnorm
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import registry
from repro_torch.serve import engine

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_placement_ranks as R  # noqa: E402  (torch and the port only)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


# (M, K, N, group, bias): odd K, N and K tails off every tile, G > 1 (group
# sizes on and off the 16-row mma step, down to 1 and 2, so a step holds
# many group edges), no bias, and full-width codeqwen shapes; M from 1 to
# 100: 2, 3 and 4 m-tiles a block (a verify pass's 40, 48, 64), a second
# block row (65, 100), and grouped weights past their 2 m-tiles a block
MATMUL_CASES = [(3, 64, 48, 0, True), (5, 63, 37, 0, False), (4, 96, 100, 24, True),
                (1, 130, 70, 65, False), (7, 258, 301, 0, True), (9, 512, 72, 64, False),
                (17, 160, 45, 32, True), (2, 48, 33, 1, False), (6, 36, 20, 2, True),
                (8, 4096, 13440, 0, True), (33, 13440, 4096, 0, False),
                (40, 4096, 4096, 0, True), (40, 2048, 1024, 0, False), (48, 258, 301, 0, True),
                (64, 1024, 4384, 0, False), (64, 13440, 4096, 0, False),
                (65, 63, 37, 0, True), (100, 96, 100, 24, True), (40, 512, 72, 64, False),
                (65, 4096, 13440, 0, False),
                # qwen2-vl-2b (q/k/v with bias, k/v of 2 KV heads: N = 256; the
                # MLP; the 151,936-wide head) and musicgen-large (q/k/v/o, the
                # GELU MLP; its 4-codebook head is 2048 -> 8192, as w_up)
                (8, 1536, 1536, 0, True), (32, 1536, 256, 0, True), (40, 1536, 8960, 0, False),
                (8, 8960, 1536, 0, False), (8, 1536, 151936, 0, False),
                (8, 2048, 2048, 0, False), (32, 2048, 8192, 0, False), (8, 8192, 2048, 0, False)]


@pytest.mark.parametrize("m,k,n,group,with_bias", MATMUL_CASES)
@pytest.mark.parametrize("odtype", ["float32", "bfloat16"])
def test_cascade_matmul_cuda_matches_plain(cuda, m, k, n, group, with_bias, odtype):
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k)
    w = torch.randn((k, n), generator=gen, device=cuda)
    packed, scales = quant.quantize_weight(w, group)
    x = (torch.randn((m, k), generator=gen, device=cuda) / k ** 0.5).to(torch.bfloat16)
    bias = torch.randn((n,), generator=gen, device=cuda) if with_bias else None
    out_dtype = getattr(torch, odtype)
    ops.reset_launch_counts()
    got = ops.cascade_matmul(x, packed, scales, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cascade_matmul"] == 1 and got.dtype == out_dtype
    xp = torch.nn.functional.pad(x, (0, 2 * packed.shape[0] - k))
    want = tcm.cascade_matmul_plain(xp, packed, scales, bias, out_dtype)
    # the same exact products summed in f32 in another order (+ one bf16
    # rounding of the result when the output is bf16)
    tol = dict(atol=1e-4, rtol=1e-4) if odtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)


# (K, N, group, bias): codeqwen's q/k/v/o (bias) and down shapes, mamba's
# in_proj, a K tail with N off the 32-column tile, groups of 24 rows
ROWS_ACROSS_M_CASES = [(4096, 4096, 0, True), (13440, 4096, 0, False), (1024, 4384, 0, False),
                       (258, 301, 0, True), (1032, 1000, 24, True),
                       # qwen2-vl-2b's and musicgen-large's weight shapes
                       (1536, 1536, 0, True), (1536, 256, 0, True), (1536, 8960, 0, False),
                       (8960, 1536, 0, False), (2048, 2048, 0, False), (2048, 8192, 0, False),
                       (8192, 2048, 0, False)]


@pytest.mark.parametrize("k,n,group,with_bias", ROWS_ACROSS_M_CASES)
@pytest.mark.parametrize("odtype", ["float32", "bfloat16"])
def test_cascade_matmul_rows_equal_bit_for_bit_at_any_m(cuda, k, n, group, with_bias, odtype):
    """One weight matrix and one set of 65 rows: the kernel over the leading
    1, 8, 16, 17, 40, 64 and 65 rows (1 to 4 m-tiles a block, one or two
    block rows) gives each row the same bits as over all 65. A row is summed
    in one order fixed by K, N and the group size, so a verify pass's rows
    round as a decode step's."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    w = torch.randn((k, n), generator=gen, device=cuda)
    packed, scales = quant.quantize_weight(w, group)
    x = (torch.randn((65, k), generator=gen, device=cuda) / k ** 0.5).to(torch.bfloat16)
    bias = torch.randn((n,), generator=gen, device=cuda) if with_bias else None
    out_dtype = getattr(torch, odtype)
    whole = ops.cascade_matmul(x, packed, scales, bias, out_dtype=out_dtype)
    differ = {}
    for m in (1, 8, 16, 17, 40, 64):
        got = ops.cascade_matmul(x[:m].contiguous(), packed, scales, bias, out_dtype=out_dtype)
        rows = [i for i in range(m) if not torch.equal(got[i], whole[i])]
        if rows:
            differ[m] = rows
    torch.cuda.synchronize()
    assert not differ, f"rows that round otherwise than at M = 65, by M: {differ}"


def test_cascade_matmul_launcher_refuses_a_plan_that_does_not_fit_m(cuda):
    """The C side checks the m-tiles it is handed against M and launches
    nothing on a mismatch."""
    packed, scales = quant.quantize_weight(torch.randn((64, 32), device=cuda), 0)
    x = torch.zeros((40, 64), device=cuda, dtype=torch.bfloat16)
    out = torch.full((40, 32), 7.0, device=cuda)
    lib = tcm._library()
    stream = torch.cuda.current_stream().cuda_stream
    for mt in (0, 1, 2, 4, 5):
        rc = lib.cascade_matmul_launch(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                       None, out.data_ptr(), 40, 64, 32, 64, 0, mt, stream)
        assert rc != 0, mt
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert tcm.plan(40, 64, 32)["m_tiles"] == 3
    assert lib.cascade_matmul_launch(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                     None, out.data_ptr(), 40, 64, 32, 64, 0, 3, stream) == 0
    torch.cuda.synchronize()
    assert bool((out == 0).all())


# (B, Hq, Hkv, T, D): GQA with groups of 4 and 8 at D = 16 and 256, the
# served codeqwen step, T = 1; G = 3 (phi4-mini) and G = 5 (qwen2.5-32b) at
# the served T; T = 4096 with B * Hkv = 256 and 16 (< 132 SMs), so T is
# split and the merge runs; G = 10 (two blocks of 5 heads per kv head); D = 80,
# whose 16-byte chunks per row do not divide the block's 128 lanes
DECODE_CASES = [(3, 8, 2, 700, 16), (8, 32, 32, 192, 128), (4, 8, 1, 513, 256),
                (2, 4, 4, 1, 64), (8, 24, 8, 192, 128), (8, 40, 8, 192, 128),
                (8, 32, 32, 4096, 128), (2, 40, 8, 4096, 128), (4, 20, 2, 300, 64),
                (2, 6, 2, 300, 80),
                # musicgen-large's decode step (32 MHA heads of 64) and
                # qwen2-vl-2b's (12 over 2 KV heads: G = 6)
                (8, 32, 32, 192, 64), (8, 12, 2, 192, 128)]


@pytest.mark.parametrize("b,hq,hkv,t,d", DECODE_CASES)
@pytest.mark.parametrize("live", ["mask", "q_pos", "q_pos_and_mask"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_attention_cuda_matches_plain(cuda, b, hq, hkv, t, d, live, dtype):
    """Kernel vs plain version on the same inputs, f32 out, within atol/rtol
    1e-4: the same f32 products, an online softmax against a two-pass one
    and sums in another order (and, with T split, partials merged by
    exp(m_s - m)). Rows: one with q_pos past T (the clamped write: all T
    live), one with q_pos = -1 or an all-false mask (no live key: v averaged
    over all T), the rest ragged."""
    gen = torch.Generator(device=cuda).manual_seed(b * 100 + t + hq)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(dt)
    # a layer view of a stacked (L, B, T, Hkv, D) cache: read through strides
    kc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(dt)
    vc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(dt)
    mask = q_pos = None
    if live != "q_pos":
        lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
        mask = torch.arange(t, device=cuda)[None, :] < lens[:, None]
        mask[:, ::7] = True              # holes and islands past the ragged end
        if b > 1:
            mask[-1] = False             # a row with no live key
    if live != "mask":
        q_pos = torch.randint(0, t, (b,), generator=gen, device=cuda).to(torch.int32)
        q_pos[0] = t + 5                 # past T: every row
        if b > 1:
            q_pos[1] = -1                # no live key
    ops.reset_launch_counts()
    got = ops.decode_attention(q, kc[1], vc[1], mask, q_pos=q_pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1
    want = tda.decode_attention_plain(q, kc[1], vc[1], mask, q_pos=q_pos)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    splits = tda.choose_splits(b, hkv, hq // hkv, t)
    assert splits > 1 or t < 512
    if splits > 1:                       # one block along T gives the same function
        one = tda.decode_attention_cuda(q, kc[1], vc[1], mask, None, q_pos, splits=1)
        torch.cuda.synchronize()
        torch.testing.assert_close(one, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,t,d", [(8, 40, 8, 2048, 128), (8, 10, 1, 1024, 256),
                                           (3, 8, 2, 700, 16), (4, 12, 2, 192, 128)])
@pytest.mark.parametrize("live", ["mask", "q_pos"])
@pytest.mark.parametrize("splits", [None, 1])
def test_decode_attention_lse_matches_plain(cuda, b, hq, hkv, t, d, live, splits):
    """``return_lse``: the output bit-equal to the call without it (one
    split and several: the merge kernel writes lse there), the lse within
    1e-4 of the plain version's, -inf on the rows with no live key; the
    shapes of a time band (qwen2.5-32b's 40/8 heads over a 2,048-row band,
    recurrentgemma-2b's ring band at D = 256) and ragged ones."""
    gen = torch.Generator(device=cuda).manual_seed(b * 7 + t + hq)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    kc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    vc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    mask = q_pos = None
    if live == "mask":
        mask = torch.rand((b, t), generator=gen, device=cuda) > 0.4
        mask[-1] = False                 # a row with no live key
        dead = ~mask.any(dim=1)
    else:
        q_pos = torch.randint(0, t, (b,), generator=gen, device=cuda).to(torch.int32)
        q_pos[0], q_pos[-1] = t + 5, -1  # every row; no row
        dead = q_pos < 0
    kw = {} if splits is None else {"splits": splits}
    o, lse = tda.decode_attention_cuda(q, kc[1], vc[1], mask, None, q_pos, return_lse=True, **kw)
    alone = tda.decode_attention_cuda(q, kc[1], vc[1], mask, None, q_pos, **kw)
    want, want_lse = tda.decode_attention_plain(q, kc[1], vc[1], mask, None, q_pos,
                                                return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, alone)
    torch.testing.assert_close(o, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(torch.isneginf(lse), dead[:, None].expand_as(lse))
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=1e-4, rtol=1e-5)


def test_decode_attention_time_bands_merge_to_the_whole(cuda):
    """Four bands of a 4,096-row cache, each through the kernel with its
    lse, merged in rank order (``sharding.merge_time_bands``): the whole
    call's output within 1e-4."""
    from repro_torch.distributed.sharding import merge_time_bands
    gen = torch.Generator(device=cuda).manual_seed(29)
    b, hq, hkv, t, d, m = 8, 40, 8, 4096, 128, 4
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([5, 1000, 1023, 1024, 2500, 3071, 4000, 4095], dtype=torch.int32,
                       device=cuda)
    whole = ops.decode_attention(q, k, v, q_pos=pos)
    tb = t // m
    parts = []
    for r in range(m):
        o, lse = ops.decode_attention(q, k[:, r * tb:(r + 1) * tb], v[:, r * tb:(r + 1) * tb],
                                      q_pos=pos - r * tb, return_lse=True)
        parts.append(torch.cat([o, lse[..., None]], dim=-1))
    torch.testing.assert_close(merge_time_bands(torch.stack(parts)), whole,
                               atol=1e-4, rtol=1e-4)


def test_decode_attention_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((2, 4, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((2, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    pos = torch.zeros((2,), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported"):            # D > 256
        z = torch.zeros((2, 8, 2, 264), device=cuda, dtype=torch.bfloat16)
        ops.decode_attention(torch.zeros((2, 4, 264), device=cuda, dtype=torch.bfloat16), z, z,
                             q_pos=pos)
    with pytest.raises(ValueError, match="share bf16 or f32"):
        ops.decode_attention(q.half(), kv.half(), kv.half(), q_pos=pos)
    with pytest.raises(ValueError, match="unit-stride"):
        ops.decode_attention(q, kv.transpose(2, 3).contiguous().transpose(2, 3), kv, q_pos=pos)
    with pytest.raises(ValueError, match="16 bytes"):
        flat = torch.zeros(kv.numel() + 4, device=cuda, dtype=torch.bfloat16)
        ops.decode_attention(q, flat[4:].view(kv.shape), kv, q_pos=pos)
    for bad, what in ((pos.long(), "int32"), (pos[:1], r"\(2,\)"), (pos.cpu(), "cpu")):
        with pytest.raises(ValueError, match=what):
            ops.decode_attention(q, kv, kv, q_pos=bad)


def test_wrapper_raises_instead_of_falling_back(cuda):
    packed = torch.zeros((32, 8), device=cuda, dtype=torch.uint8)
    for dtype in (torch.float16, torch.float32):   # the kernel takes bf16 activations
        with pytest.raises(ValueError, match="not supported"):
            ops.cascade_matmul(torch.zeros((2, 64), device=cuda, dtype=dtype), packed,
                               torch.ones((1, 8), device=cuda))
    with pytest.raises(ValueError, match="unsupported"):
        ops.decode_attention(torch.zeros((1, 3, 8), device=cuda),
                             torch.zeros((1, 4, 2, 8), device=cuda),
                             torch.zeros((1, 4, 2, 8), device=cuda),
                             torch.ones((1, 4), device=cuda, dtype=torch.bool))


# (Bt, S, H, P, G, N, carry): the serving decode step (8 slots x 32 heads of
# P=64, N=128, state carried), G > 1, S > 1 with and without an initial
# state, P off the 8-warp row split and N below a warp's 128 columns
SCAN_CASES = [(8, 1, 32, 64, 1, 128, True), (4, 1, 8, 64, 2, 128, True),
              (2, 37, 4, 32, 1, 16, True), (2, 37, 4, 32, 1, 16, False),
              (3, 5, 6, 48, 3, 64, True)]


def _scan_inputs(cuda, bt, s, h, p, g, n, dtype, seed):
    """x, B and C as strided views of one (Bt, S, H*P + 2*G*N) buffer, as the
    model hands them over from its conv output."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    xbc = torch.randn((bt, s, h * p + 2 * g * n), generator=gen, device=cuda).to(dt_)
    x = xbc[..., :h * p].reshape(bt, s, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(bt, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(bt, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((bt, s, h), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((h,), generator=gen, device=cuda) * 0.3)
    D = torch.randn((h,), generator=gen, device=cuda)
    state = torch.randn((bt, h, p, n), generator=gen, device=cuda)
    return x, dt, A, B, C, D, state


@pytest.mark.parametrize("bt,s,h,p,g,n,carry", SCAN_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_scan_cuda_matches_plain(cuda, bt, s, h, p, g, n, carry, dtype):
    """The state update is the same elementwise f32 arithmetic (no FMA
    contraction, expf as torch.exp): state within 1e-5. The readout sums
    over N in another order: y within 1e-5 in f32, and within one bf16
    step (2^-7 relative) when y is bf16."""
    x, dt, A, B, C, D, state = _scan_inputs(cuda, bt, s, h, p, g, n, dtype, bt * 100 + s)
    init = state if carry else None
    ops.reset_launch_counts()
    gy, gs = tssd.ssd_scan_cuda(x, dt, A, B, C, D, init, True)
    torch.cuda.synchronize()
    wy, ws = tssd.ssd_scan_plain(x, dt, A, B, C, D, init, True)
    assert gy.dtype == x.dtype and gy.shape == (bt, s, h, p) and gs.shape == (bt, h, p, n)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=1e-5)
    ytol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-5, rtol=2 ** -7)
    torch.testing.assert_close(gy.float(), wy.float(), **ytol)
    # the state written in place over the initial one equals the out-of-place result
    if carry:
        inplace = state.clone()
        y2, s2 = ops.ssd_decode(x, dt, A, B, C, D, inplace, out_state=inplace) if s == 1 \
            else tssd.ssd_scan_cuda(x, dt, A, B, C, D, inplace, True, inplace)
        torch.cuda.synchronize()
        assert s2 is inplace and torch.equal(inplace, gs) and torch.equal(y2, gy)
    assert ops.LAUNCHES["ssd_scan"] == (1 if carry and s == 1 else 0)


def test_ssd_scan_wrapper_matches_reference_layout(cuda):
    """ops.ssd_scan takes the reference's (BH, S, P) layout with per-head A,
    D, B and C and launches the kernel."""
    x, dt, A, B, C, D, state = _scan_inputs(cuda, 6, 9, 1, 64, 1, 128, "float32", 5)
    ops.reset_launch_counts()
    y, fin = ops.ssd_scan(x[:, :, 0], dt[:, :, 0], A.expand(6), B[:, :, 0], C[:, :, 0],
                          D.expand(6), initial_state=state[:, 0], return_final_state=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    wy, ws = tssd.ssd_scan_plain(x, dt, A, B, C, D, state, True)
    torch.testing.assert_close(y, wy[:, :, 0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(fin, ws[:, 0], atol=1e-5, rtol=1e-5)


def test_ssd_scan_raises_on_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C, D, state = _scan_inputs(cuda, 2, 1, 4, 64, 1, 128, "bfloat16", 6)
    with pytest.raises(ValueError, match="unsupported"):           # P > 64
        big = torch.zeros((2, 1, 4, 65), device=cuda, dtype=torch.bfloat16)
        ops.ssd_decode(big, dt, A, B, C, D, torch.zeros((2, 4, 65, 128), device=cuda))
    with pytest.raises(ValueError, match="unsupported"):           # N not a multiple of 4
        odd = torch.zeros((2, 1, 1, 126), device=cuda, dtype=torch.bfloat16)
        ops.ssd_decode(x, dt, A, odd, odd, D, torch.zeros((2, 4, 64, 126), device=cuda))
    with pytest.raises(ValueError, match="share bf16 or f32"):
        ops.ssd_decode(x.half(), dt, A, B.half(), C.half(), D, state)
    with pytest.raises(ValueError, match="contiguous f32"):
        ops.ssd_decode(x, dt, A, B, C, D, state.transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(state.numel() + 1, device=cuda)
        ops.ssd_decode(x, dt, A, B, C, D, flat[1:].view(state.shape))
    with pytest.raises(ValueError, match="dt must be f32"):
        ops.ssd_decode(x, dt.bfloat16(), A, B, C, D, state)


# the kernels each smoke model's fused path launches
PATH_KERNELS = {"codeqwen1.5-7b": {"cascade_matmul", "decode_attention", "flash_attention",
                                   "norm"},
                "mamba2-370m": {"cascade_matmul", "norm", "ssd_scan"}}


def test_fused_engine_streams_equal_plain_engine_on_the_card(cuda, monkeypatch):
    """At bf16 on the card the fused engine (CUDA kernels) emits the greedy
    streams of the same engine with its wrappers sent to the kernels' plain
    versions, on the dense and the Mamba-2 smoke configs, and launches
    exactly the kernels of each path."""
    for arch, kernels in PATH_KERNELS.items():
        cfg, model = registry.load(arch, smoke=True)
        ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
        params = model.init_params(0, ccfg, device=cuda)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (10, 23, 7)]
        streams = {}
        for route in ("kernel", "plain"):
            if route == "plain":
                monkeypatch.setattr(tcm, "cascade_matmul_cuda", tcm.cascade_matmul_plain)
                monkeypatch.setattr(tda, "decode_attention_cuda", tda.decode_attention_plain)
                monkeypatch.setattr(tfa, "flash_attention_cuda", tfa.flash_attention_plain)
                monkeypatch.setattr(tssd, "ssd_scan_cuda", tssd.ssd_scan_plain)
                monkeypatch.setattr(tnorm, "norm_cuda", tnorm.norm_plain)
                monkeypatch.setattr(tnorm, "add_norm_cuda", tnorm.add_norm_plain)
                monkeypatch.setattr(tnorm, "gated_norm_cuda", tnorm.gated_norm_plain)
            eng = engine.ServeEngine(model, params, ccfg,
                                     engine.ServeConfig(max_batch=2, max_len=40,
                                                        prefill_chunk=8, fused=True),
                                     device=cuda)
            reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=12)
                    for i, p in enumerate(prompts)]
            ops.reset_launch_counts()
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            streams[route] = [r.tokens_out for r in reqs]
            if route == "kernel":
                assert {k for k, n in ops.LAUNCHES.items() if n > 0} == kernels, \
                    (arch, ops.LAUNCHES)
        monkeypatch.undo()
        assert streams["kernel"] == streams["plain"], arch


# (name, B, Hq, Hkv, S, T, D, causal, offsets): the TPU kernel's own
# signature (T = S, offset 0) at 128 and 2048, and not causal; GQA at
# phi4-mini's heads; an admission chunk of 32 at each of its offsets in a
# 192-row cache; the verify pass (8 rows of 5 at offsets over 0-187)
FLASH_CASES = [("causal128", 1, 32, 32, 128, 128, 128, True, [0]),
               ("causal2048", 1, 32, 32, 2048, 2048, 128, True, [0]),
               ("full128", 1, 32, 32, 128, 128, 128, False, [0]),
               ("gqa512", 1, 24, 8, 512, 512, 128, True, [0]),
               ("admit0", 1, 32, 32, 32, 192, 128, True, [0]),
               ("admit32", 1, 32, 32, 32, 192, 128, True, [32]),
               ("admit64", 1, 32, 32, 32, 192, 128, True, [64]),
               ("admit96", 1, 32, 32, 32, 192, 128, True, [96]),
               ("verify", 8, 32, 32, 5, 192, 128, True, [0, 27, 53, 80, 107, 133, 160, 187]),
               ("smoke_d16", 2, 4, 2, 9, 24, 16, True, [3, 15]),
               # GQA 40/8 (G = 5): qwen2.5-32b's verify pass and admission chunk
               ("g5_verify", 8, 40, 8, 5, 192, 128, True, [0, 27, 53, 80, 107, 133, 160, 187]),
               ("g5_admit", 1, 40, 8, 32, 192, 128, True, [96]),
               # G = 3 at S = 65 (two query tiles of 21 positions and a ragged
               # one), G = 8 at S = 1 against T = 4096, MQA at S = 64
               ("g3_s65", 2, 24, 8, 65, 300, 64, True, [0, 200]),
               ("g8_s1_t4096", 4, 64, 8, 1, 4096, 128, True, [0, 1000, 2500, 4095]),
               ("mqa_s64", 2, 8, 1, 64, 64, 32, True, [0, 0]),
               # a long chunk into a long cache; D = 96 and D = 32; G = 20
               # (two blocks of 10 heads per KV head)
               ("s2048_t4096", 1, 8, 8, 2048, 4096, 64, True, [2048]),
               ("d96_full", 2, 6, 2, 65, 65, 96, False, [0, 0]),
               ("d32_s5", 3, 4, 4, 5, 40, 32, True, [0, 17, 35]),
               ("g20", 1, 40, 2, 7, 50, 16, True, [30]),
               # musicgen-large at D = 64: its 128-token prefill (8 rows) and
               # an admission chunk of 32 over a 160-row cache; qwen2-vl-2b's
               # prefill (GQA 12/2 at D = 128)
               ("musicgen_prefill", 8, 32, 32, 128, 128, 64, True, [0] * 8),
               ("musicgen_admit", 1, 32, 32, 32, 160, 64, True, [128]),
               ("qwen2vl_prefill", 8, 12, 2, 128, 128, 128, True, [0] * 8)]


def flash_tolerance(want, v):
    """Kernel vs plain, both bf16 out: one bf16 step of the result
    (2^-7 |plain|), plus 2^-12 max|v| for p carried as two bf16 terms
    (~2^-18 relative) and f32 sums in another order."""
    return 2.0 ** -7 * want.float().abs() + 2.0 ** -12 * float(v.float().abs().max())


@pytest.mark.parametrize("name,b,hq,hkv,s,t,d,causal,offsets", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_cuda_matches_plain(cuda, name, b, hq, hkv, s, t, d, causal, offsets):
    gen = torch.Generator(device=cuda).manual_seed(s * 7 + t)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    # k/v: a layer view of a stacked (L, B, T, Hkv, D) cache, read in place
    kc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    vc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    args = (q.transpose(1, 2), kc[1].transpose(1, 2), vc[1].transpose(1, 2))
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention(*args, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    want = tfa.flash_attention_plain(*args, causal=causal, q_offset=off)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, s, d)
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_tolerance(want, vc[1])).all()), float(err.max())
    # the same call on contiguous copies gives the same bits
    same = ops.flash_attention(*(a.contiguous() for a in args), causal=causal, q_offset=off)
    assert torch.equal(same, got)


# (name, B, Hq, Hkv, S, T, D, offsets): the admission chunk in a 192-row
# cache, G = 5 at S = 65 into a 1,024-row cache, and the admission chunk over
# its live prefix (T = offset + 32) where the plan first splits it and at
# the end of a 4,096-row cache
SPLIT_CASES = [("admit96", 1, 32, 32, 32, 192, 128, [96]),
               ("g5_s65", 2, 40, 8, 65, 1024, 64, [0, 900]),
               ("admit224_live", 1, 32, 32, 32, 256, 128, [224]),
               ("admit4064_live", 1, 32, 32, 32, 4096, 128, [4064])]


@pytest.mark.parametrize("name,b,hq,hkv,s,t,d,offsets", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 7, 16])
def test_flash_attention_forced_splits_match_plain(cuda, name, b, hq, hkv, s, t, d, offsets,
                                                   splits):
    """Any split count (1-16; splits past a block's tiles are empty and
    weigh 0 in the merge) stays within the kernel's tolerance of the plain
    version, on strided views."""
    gen = torch.Generator(device=cuda).manual_seed(s + t + splits)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    kc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    vc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    args = (q.transpose(1, 2), kc[1].transpose(1, 2), vc[1].transpose(1, 2))
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = tfa.flash_attention_cuda(*args, True, None, off, splits=splits)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(*args, causal=True, q_offset=off)
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_tolerance(want, vc[1])).all()), float(err.max())


# (leading shape, d): mamba2-370m's norms (1,024 and the gated 2,048) and
# codeqwen's (4,096) at a decode step's 8 rows and a verify pass's (8, 5);
# 8,192; a width off 16 bytes; recurrentgemma-2b's 2,560 (its first block's
# norm) at a decode step, a verify pass and an admission chunk
NORM_CASES = [((8,), 1024), ((8, 5), 2048), ((8, 1), 4096), ((40,), 4096), ((3, 2), 8192),
              ((5,), 1000), ((2, 3), 36), ((8, 1), 2560), ((8, 5), 2560), ((1, 32), 2560),
              # musicgen-large's 2,048 (a decode step, (8, 5) and 32 rows) and
              # qwen2-vl-2b's 1,536
              ((8, 1), 2048), ((32,), 2048), ((8, 1), 1536), ((8, 128), 1536)]


@pytest.mark.parametrize("lead,d", NORM_CASES)
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norm_cuda_matches_plain(cuda, lead, d, norm_type, dtype):
    """The kernel against its plain version on the same rows: both in f32,
    sums in another order and rsqrt to within an ulp, so f32 rows agree at
    atol/rtol 1e-5 and bf16 rows within one bf16 step (2^-7 |plain|), plus
    2^-20 max|plain| where LayerNorm's bias add cancels to near 0 and the
    last f32 bits of terms as large as the row's outputs show."""
    gen = torch.Generator(device=cuda).manual_seed(d + len(lead))
    x = (3 * torch.randn(lead + (d,), generator=gen, device=cuda) + 0.5).to(getattr(torch, dtype))
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=cuda)
    bias = 0.1 * torch.randn((d,), generator=gen, device=cuda) if norm_type == "layernorm" \
        else None
    ops.reset_launch_counts()
    got = ops.norm(x, scale, bias, norm_type=norm_type)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["norm"] == 1 and got.dtype == x.dtype and got.shape == x.shape
    want = tnorm.norm_plain(x, scale, bias, norm_type)
    err = (got.float() - want.float()).abs()
    tol = (1e-5 * (1 + want.float().abs()) if dtype == "float32"
           else 2.0 ** -7 * want.float().abs() + 2.0 ** -20 * float(want.float().abs().max()))
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("d,norm_type", [(4096, "rmsnorm"), (1024, "rmsnorm"),
                                         (2048, "layernorm"), (4096, "layernorm"),
                                         (2560, "rmsnorm")])
def test_norm_kernel_rows_round_alike_in_any_number_of_rows(cuda, d, norm_type):
    """The norm kernel over (8, 5, d) bf16 rows (a verify chunk) gives each
    token's rows what it gives over that token's (8, 1, d) rows (a decode
    step), bit for bit: codeqwen's width, mamba2-370m's and
    recurrentgemma-2b's, RMSNorm and LayerNorm, 100 draws of 40 rows."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(d)
    params = {"scale": 1 + 0.1 * torch.randn((d,), generator=gen, device=cuda)}
    if norm_type == "layernorm":
        params["bias"] = 0.1 * torch.randn((d,), generator=gen, device=cuda)
    differing = 0
    ops.reset_launch_counts()
    for _ in range(100):
        x = torch.randn((8, 5, d), generator=gen, device=cuda).to(torch.bfloat16)
        whole = L.norm_apply(params, x, norm_type, use_kernel=True)
        per_token = torch.cat([L.norm_apply(params, x[:, j:j + 1].contiguous(), norm_type,
                                            use_kernel=True) for j in range(5)], dim=1)
        differing += int((whole != per_token).any(dim=-1).sum())
    assert ops.LAUNCHES["norm"] == 100 * 6
    assert differing == 0, f"{differing} of {100 * 40} rows round otherwise"


def test_norm_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 64), device=cuda, dtype=torch.bfloat16)
    one = torch.ones((64,), device=cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.norm(x.half(), one)
    with pytest.raises(ValueError, match="width"):
        ops.norm(torch.zeros((2, 20000), device=cuda, dtype=torch.bfloat16),
                 torch.ones((20000,), device=cuda))
    with pytest.raises(ValueError, match="scale"):
        ops.norm(x, torch.ones((32,), device=cuda))
    with pytest.raises(ValueError, match="bias"):
        ops.norm(x, one, None, norm_type="layernorm")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
        ops.norm(flat[1:].view(2, 64), one)


# (form, leading shape, d, norm type): the fused forms at the served shapes:
# add-norm at codeqwen's 4,096 (a decode step's 8 rows, a verify pass's
# (8, 5), an admission chunk's (1, 32)) and mamba2-370m's 1,024, LayerNorm;
# the gated form at mamba2-370m's 2,048, z a column slice of in_proj's
# (..., 4384) output; widths off 16 bytes; add-norm at recurrentgemma-2b's
# 2,560 (a decode step, a verify pass, an admission chunk)
FUSED_NORM_CASES = [("add", (8, 1), 4096, "rmsnorm"), ("add", (8, 5), 4096, "rmsnorm"),
                    ("add", (1, 32), 4096, "rmsnorm"), ("add", (8, 1), 1024, "rmsnorm"),
                    ("add", (8, 5), 1024, "rmsnorm"), ("add", (8, 1), 4096, "layernorm"),
                    ("add", (5,), 1000, "layernorm"), ("gated", (8, 1), 2048, "rmsnorm"),
                    ("gated", (8, 5), 2048, "rmsnorm"), ("gated", (3, 2), 36, "rmsnorm"),
                    ("add", (8, 1), 2560, "rmsnorm"), ("add", (8, 5), 2560, "rmsnorm"),
                    ("add", (1, 32), 2560, "rmsnorm"),
                    # musicgen-large's add-layernorm with bias at 2,048;
                    # qwen2-vl-2b's add-rmsnorm at 1,536
                    ("add", (8, 1), 2048, "layernorm"), ("add", (8, 5), 2048, "layernorm"),
                    ("add", (32,), 2048, "layernorm"), ("add", (8, 1), 1536, "rmsnorm")]


def _fused_inputs(cuda, form, lead, d, norm_type, dtype, seed):
    """x and r (add), or y and z (gated; z a column slice of a wider buffer
    whose rows are in_proj's 4,384 wide at Mamba-2's width), scale, bias."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (3 * torch.randn(lead + (d,), generator=gen, device=cuda) + 0.5).to(dt)
    if form == "gated":
        wide = 4384 if d == 2048 else d + 8
        r = (3 * torch.randn(lead + (wide,), generator=gen, device=cuda)).to(dt)[..., :d]
    else:
        r = (3 * torch.randn(lead + (d,), generator=gen, device=cuda)).to(dt)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=cuda)
    bias = 0.1 * torch.randn((d,), generator=gen, device=cuda) if norm_type == "layernorm" \
        else None
    return x, r, scale, bias


def _eager_then_norm(form, x, r, scale, bias, norm_type):
    """The route the fused forms replaced: the eager add or gate, then the
    norm kernel."""
    import torch.nn.functional as F
    v = x + r if form == "add" else (x * F.silu(r.to(torch.float32))).to(x.dtype)
    return ops.norm(v, scale, bias, norm_type=norm_type), v


@pytest.mark.parametrize("form,lead,d,norm_type", FUSED_NORM_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_norms_equal_the_eager_route_bit_for_bit(cuda, form, lead, d, norm_type, dtype):
    """add-norm gives the bits of the eager ``x + r`` then the norm kernel
    (the normed rows and the written sum); the gated norm those of the eager
    ``(y * silu(z.f32)).to(y.dtype)`` then the norm kernel, z read in place
    through its row stride. One launch each."""
    x, r, scale, bias = _fused_inputs(cuda, form, lead, d, norm_type, dtype, d + len(lead))
    ops.reset_launch_counts()
    if form == "add":
        got, s = ops.add_norm(x, r, scale, bias, norm_type=norm_type)
    else:
        got = ops.gated_norm(x, r, scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["norm"] == 1 and got.dtype == x.dtype and got.shape == x.shape
    want, v = _eager_then_norm(form, x, r, scale, bias, norm_type)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    if form == "add":
        assert s.dtype == x.dtype and torch.equal(s, v)


@pytest.mark.parametrize("lead", [(1, 32), (8, 5)])
def test_gated_norm_takes_f32_rows_beside_a_bf16_gate(cuda, lead):
    """Mamba-2's dual form (prefill, admission chunks) hands the gated norm
    f32 y beside bf16 z (a column slice of in_proj's output): the kernel
    gives the eager route's bits, f32 out, z read 8 bytes at a time."""
    y, _, scale, _ = _fused_inputs(cuda, "gated", lead, 2048, "rmsnorm", "float32", 9)
    _, z, _, _ = _fused_inputs(cuda, "gated", lead, 2048, "rmsnorm", "bfloat16", 10)
    assert z.dtype == torch.bfloat16 and z.stride(-2) == 4384
    got = ops.gated_norm(y, z, scale)
    want, _ = _eager_then_norm("gated", y, z, scale, None, "rmsnorm")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want), \
        float((got - want).abs().max())


@pytest.mark.parametrize("offset,width", [(1, 2048 + 8), (0, 2048 + 1), (3, 2048 + 5)])
@pytest.mark.parametrize("zdtype", ["bfloat16", "float32"])
def test_gated_norm_reads_a_misaligned_z_one_element_a_load(cuda, offset, width, zdtype):
    """A z whose offset or row stride breaks the wide load (an in_proj
    output width that is not a multiple of 8, as at the smoke configs) is
    read one element a load, with the bits of the same z copied to aligned
    rows."""
    y, _, scale, _ = _fused_inputs(cuda, "gated", (8, 5), 2048, "rmsnorm", "bfloat16", 3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    buf = (3 * torch.randn((8, 5, width + offset), generator=gen, device=cuda)) \
        .to(getattr(torch, zdtype))
    z = buf[..., offset:offset + 2048]
    got = ops.gated_norm(y, z, scale)
    want = ops.gated_norm(y, z.contiguous(), scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("form,d", [("add", 4096), ("add", 1024), ("gated", 2048)])
def test_fused_norm_rows_round_alike_in_any_number_of_rows(cuda, form, d):
    """The fused forms over (8, 5, d) bf16 rows (a verify chunk) give each
    token's rows what they give over that token's (8, 1, d) rows (a decode
    step), bit for bit: 100 draws of 40 rows."""
    differing = 0
    ops.reset_launch_counts()
    for i in range(100):
        x, r, scale, _ = _fused_inputs(cuda, form, (8, 5), d, "rmsnorm", "bfloat16", i)
        fn = (lambda a, b: ops.add_norm(a, b, scale)) if form == "add" \
            else (lambda a, b: (ops.gated_norm(a, b, scale), a))
        whole = fn(x, r)
        parts = [fn(x[:, j:j + 1], r[:, j:j + 1]) for j in range(5)]
        for k in range(2):
            per_token = torch.cat([p[k] for p in parts], dim=1)
            differing += int((whole[k] != per_token).any(dim=-1).sum())
    assert ops.LAUNCHES["norm"] == 100 * 6
    assert differing == 0, f"{differing} rows round otherwise"


@pytest.mark.parametrize("d,norm_type", [(2048, "layernorm"), (1536, "rmsnorm")])
def test_add_norm_rows_round_alike_in_any_number_of_rows_at_the_stub_widths(cuda, d, norm_type):
    """musicgen-large's add-layernorm (with bias) at 2,048 and qwen2-vl-2b's
    add-rmsnorm at 1,536: each token's rows of an (8, 5) call and of a
    32-row call equal, bit for bit, one-token calls over the same rows."""
    differing = 0
    for i in range(20):
        for lead in ((8, 5), (1, 32)):
            x, r, scale, bias = _fused_inputs(cuda, "add", lead, d, norm_type, "bfloat16", i)
            whole = ops.add_norm(x, r, scale, bias, norm_type=norm_type)
            parts = [ops.add_norm(x[:, j:j + 1], r[:, j:j + 1], scale, bias,
                                  norm_type=norm_type) for j in range(lead[1])]
            for k in range(2):
                per_token = torch.cat([p[k] for p in parts], dim=1)
                differing += int((whole[k] != per_token).any(dim=-1).sum())
    assert differing == 0, f"{differing} rows round otherwise"


def _plain_routes(monkeypatch):
    """Send every wrapper's CUDA tensors to its kernel's plain version."""
    for mod, name, plain in ((tcm, "cascade_matmul_cuda", tcm.cascade_matmul_plain),
                             (tda, "decode_attention_cuda", tda.decode_attention_plain),
                             (tfa, "flash_attention_cuda", tfa.flash_attention_plain),
                             (tnorm, "norm_cuda", tnorm.norm_plain),
                             (tnorm, "add_norm_cuda", tnorm.add_norm_plain)):
        monkeypatch.setattr(mod, name, plain)


def _vl_positions(b, grid, n_text, start=0):
    """(3, B, grid^2 + n_text): a t = 1 image of grid x grid patches at its
    (t, h, w) positions, then text from the grid's largest position + 1."""
    hh, ww = torch.meshgrid(torch.arange(grid), torch.arange(grid), indexing="ij")
    img = torch.stack([torch.zeros(grid * grid, dtype=torch.int64), hh.flatten(), ww.flatten()])
    text = (img.max() + 1 + torch.arange(n_text))[None].expand(3, n_text)
    pos = torch.cat([img, text], dim=1)[:, start:]
    return pos[:, None].expand(3, b, pos.shape[1]).to(torch.int32)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_stub_backbone_depth2_logits_through_the_kernels_match_plain(cuda, arch, monkeypatch):
    """The model cut to 2 layers at full width, fed seeded stub embeddings:
    a 128-token prefill (qwen2-vl: an 8 x 8 image's M-RoPE positions, then
    text) and one decode step (musicgen: ``pos_offset``), through the
    kernels and through their plain versions on the card. Logits (musicgen's
    4 codebooks too) within codeqwen's parity limits: relative L2 2^-6 and
    every logit within 2 bf16 steps of max|plain|."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(3, ccfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    emb = torch.randn((8, 129, cfg.d_model), generator=gen, device=cuda)
    pre, dec = {"inputs_embeds": emb[:, :128]}, {"inputs_embeds": emb[:, 128:]}
    if cfg.mrope_sections:
        pos = _vl_positions(8, 8, 65).to(cuda)
        pre["positions"], dec["positions"] = pos[:, :, :128], pos[:, :, 128:]
    else:
        dec["pos_offset"] = 128
    out = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            _plain_routes(monkeypatch)
        ops.reset_launch_counts()
        with torch.no_grad():
            l1, cache = model.prefill(params, pre, ccfg, max_len=160)
            l2, _ = model.decode_step(params, dec, cache, ccfg)
        torch.cuda.synchronize()
        if route == "kernel":
            assert ops.LAUNCHES["flash_attention"] == 2 and ops.LAUNCHES["decode_attention"] == 2
        out[route] = (l1, l2)
    if cfg.n_codebooks:
        assert out["kernel"][1].shape == (8, 1, cfg.n_codebooks, cfg.vocab)
    for a, b in zip(out["kernel"], out["plain"]):
        assert bool(torch.isfinite(a).all())
        rel = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        absmax = float(b.abs().max())
        steps = float((a - b).abs().max()) / 2.0 ** (np.floor(np.log2(absmax)) - 7)
        assert rel <= 2.0 ** -6 and steps <= 2, (rel, steps)


def test_fused_norms_raise_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 64), device=cuda, dtype=torch.bfloat16)
    one = torch.ones((64,), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.add_norm(x, x.float(), one)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.gated_norm(x, x.half(), one)
    with pytest.raises(ValueError, match="shape"):
        ops.add_norm(x, x[:1], one)
    buf = torch.zeros((2, 4384), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):            # r's offset
        ops.add_norm(x, buf.view(-1)[1:129].view(2, 64), one)
    with pytest.raises(ValueError, match="16-byte aligned"):            # r's row stride
        ops.add_norm(x, torch.zeros((2, 65), device=cuda, dtype=torch.bfloat16)[:, :64], one)
    with pytest.raises(ValueError, match="16-byte aligned"):            # x's offset
        ops.add_norm(buf.view(-1)[1:129].view(2, 64), x, one)
    wide = torch.zeros((2, 20000), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="width"):
        ops.add_norm(wide, wide, torch.ones((20000,), device=cuda))
    with pytest.raises(ValueError, match="width"):
        ops.gated_norm(wide, wide, torch.ones((20000,), device=cuda))


def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 4, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        ops.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="unsupported"):          # D = 48
        z = torch.zeros((1, 4, 8, 48), device=cuda, dtype=torch.bfloat16)
        ops.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="unsupported"):          # Hq not a multiple of Hkv
        ops.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="multiples of 8"):
        flat = torch.zeros(4 * 8 * 64 + 4, device=cuda, dtype=torch.bfloat16)
        ops.flash_attention(q, flat[4:].view(1, 4, 8, 64), q)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_attention(q, q, q, q_offset=torch.zeros(1, device=cuda, dtype=torch.int64))


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-370m", "olmoe-1b-7b"])
def test_spec_engine_at_full_width_launches_the_path_kernels(cuda, arch):
    """A 2-layer full-width model served speculatively (draft 4, greedy):
    every request finishes, each verify pass launches flash attention once
    per layer (codeqwen, olmoe) or the SSD scan once per layer and chunk
    token (Mamba-2), olmoe's experts three grouped matmuls a layer, and no
    verify pass launches decode attention."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    params = model.init_params(0, ccfg, device=cuda)
    eng = engine.ServeEngine(model, params, ccfg, engine.ServeConfig(
        max_batch=4, max_len=80, prefill_chunk=32, draft_len=4, fused=True), device=cuda)
    per_verify = []
    verify = model.spec_verify

    def counted(*a, **kw):
        before = dict(ops.LAUNCHES)
        out = verify(*a, **kw)
        per_verify.append({k: ops.LAUNCHES[k] - before[k] for k in before})
        return out

    model.spec_verify = counted
    rng = np.random.default_rng(0)
    reqs = [engine.Request(uid=i, prompt=np.resize(rng.integers(0, cfg.vocab, 5), 48)
                           .astype(np.int32), max_new_tokens=12) for i in range(6)]
    ops.reset_launch_counts()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert eng.effective_mode == "spec-greedy-fused"
    assert all(r.done and len(r.tokens_out) == 12 for r in reqs)
    assert per_verify
    for step in per_verify:
        assert step["decode_attention"] == 0
        assert step["norm"] == 2 * 2 + 1          # two norms a layer, then the final norm
        if arch == "mamba2-370m":
            assert step["ssd_scan"] == 2 * 5 and step["flash_attention"] == 0
        else:
            assert step["flash_attention"] == 2 and step["ssd_scan"] == 0
        assert step["cascade_matmul_grouped"] == (2 * 2 if arch == "olmoe-1b-7b" else 0)
        assert step["cascade_matmul"] > 0


def _count_device_launches(fn):
    """Kernels, copies and memsets that torch.profiler records on the card
    while ``fn`` runs (synchronised at the end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _clone_tree(tree):
    return {k: _clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.clone()


def test_served_codeqwen_decode_step_builds_no_mask(cuda, monkeypatch):
    """A codeqwen decode step at full width and depth 2 (bf16, FP4 kernels,
    8 slots at positions 128-156 of a 192-row cache) hands the rows'
    positions to decode attention, which launches once per layer, and makes
    3 fewer device launches per layer than the route it replaced, which
    built the (B, T) mask ``arange(T) <= pos`` in three launches (pos plus
    the step offsets, arange, <=) in every layer: 96 a step over codeqwen's
    32 layers. The old route is replayed by wrapping ``ops.decode_attention``
    with exactly those three operations; launches are counted as the device
    events torch.profiler records over one step."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_config("codeqwen1.5-7b"), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(0, ccfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = model.init_cache(8, 192, dtype=torch.bfloat16, device=cuda)
    for name in ("k", "v"):
        cache["layers"][name].copy_(torch.randn(cache["layers"][name].shape, generator=gen,
                                                device=cuda))
    cache["layers"]["pos"].copy_(torch.arange(128, 160, 4, device=cuda).expand(2, 8))
    toks = torch.randint(0, cfg.vocab, (8, 1), generator=gen, device=cuda)
    new_route = ops.decode_attention

    def mask_route(q, k, v, valid=None, *, scale=None, q_pos=None):
        assert valid is None and q_pos is not None
        rows = q_pos[:, None] + 0
        valid = torch.arange(k.shape[1], device=k.device)[None, None, :] <= rows[:, :, None]
        return new_route(q, k, v, valid[:, 0], scale=scale)

    counts, logits = {}, {}
    with torch.no_grad():
        model.decode_step(params, {"tokens": toks}, _clone_tree(cache), ccfg)   # warm-up
        for route in ("q_pos", "mask"):
            if route == "mask":
                monkeypatch.setattr(ops, "decode_attention", mask_route)
            c = _clone_tree(cache)
            ops.reset_launch_counts()
            counts[route] = _count_device_launches(
                lambda: logits.__setitem__(route, model.decode_step(
                    params, {"tokens": toks}, c, ccfg)[0]))
            assert ops.LAUNCHES["decode_attention"] == cfg.n_layers
    assert counts["mask"] - counts["q_pos"] == 3 * cfg.n_layers, counts
    torch.testing.assert_close(logits["q_pos"], logits["mask"], atol=0, rtol=0)


def test_mamba2_verify_rows_equal_decode_steps_bit_for_bit(cuda, monkeypatch):
    """mamba2-370m at full width and depth 2, bf16, FP4 kernels, seed-0
    weights: from one cache, 5 tokens decoded one step at a time, and from a
    copy of it one speculative verify pass over the same 5 tokens. Row j of
    the verify logits equals decode step j's logits bit for bit, so a
    speculative greedy stream is the plain greedy stream. On a mismatch the
    message names the first tensor (in call order: each norm's and linear's
    input and output, each block's output, the head's input and output)
    whose verify row j differs from decode step j."""
    import dataclasses
    from repro_torch.core import cascade
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(registry.get_config("mamba2-370m"), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(0, ccfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, s = 8, 5
    prompt = torch.randint(0, cfg.vocab, (b, 32), generator=gen, device=cuda)
    chunk = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=cuda)

    trace = []
    def recorded(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            trace.append((f"{name} in", a[1]))
            trace.append((f"{name} out", out[0] if isinstance(out, tuple) else out))
            return out
        return call
    with torch.no_grad():
        cache = model.init_cache(b, 64, dtype=torch.bfloat16, device=cuda)
        model.prefill_extend(params, {"tokens": prompt}, cache, ccfg)
        copy = _clone_tree(cache)
        monkeypatch.setattr(L, "norm_apply", recorded("norm", L.norm_apply))
        monkeypatch.setattr(L, "add_norm_apply", recorded("add_norm", L.add_norm_apply))
        monkeypatch.setattr(L, "gated_norm_apply", recorded("gated_norm", L.gated_norm_apply))
        monkeypatch.setattr(L, "tied_head", recorded("head", L.tied_head))
        monkeypatch.setattr(cascade, "linear_apply", recorded("linear", cascade.linear_apply))
        monkeypatch.setattr(model, "_block", recorded("block", model._block))
        steps, decoded = [], []
        for j in range(s):
            trace.clear()
            lj, _ = model.decode_step(params, {"tokens": chunk[:, j:j + 1]}, cache, ccfg)
            decoded.append(lj[:, 0])
            steps.append(list(trace))
        trace.clear()
        verified, _, _ = model.spec_verify(params, {"tokens": chunk}, copy, ccfg)
        torch.cuda.synchronize()
    assert trace and all(len(st) == len(trace) for st in steps)
    differs = []
    for i, (name, vt) in enumerate(trace):
        for j, st in enumerate(steps):
            dn, dtn = st[i]
            assert dn == name
            a, w = dtn.reshape(b, -1).float(), vt[:, j].reshape(b, -1).float()
            if not torch.equal(a, w):
                differs.append((i, name, j, float((a - w).abs().max())))
    first = differs[0] if differs else None
    rows_equal = [torch.equal(decoded[j], verified[:, j]) for j in range(s)]
    assert all(rows_equal) and not differs, (
        f"verify rows equal decode steps: {rows_equal}; first differing tensor "
        f"(call index, name, token, max|diff|): {first}; all: {differs[:40]}")


def test_norm_rows_round_alike_at_the_decode_and_verify_shapes(cuda):
    """norm_apply through the norm kernel (as the fused serving path calls
    it) over a verify chunk's (8, 5, 2048) bf16 rows (the gated norm of
    mamba2-370m) gives each token's rows what it gives over that token's
    (8, 1, 2048) rows, decode's shape, bit for bit. The eager norm (without
    the kernel) sums a row in an order set by the number of rows, and fails
    this (ROADMAP Queue 3 item 1)."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"scale": 1 + 0.1 * torch.randn((2048,), generator=gen, device=cuda)}
    differing = 0
    ops.reset_launch_counts()
    for _ in range(200):
        x = torch.randn((8, 5, 2048), generator=gen, device=cuda).to(torch.bfloat16)
        whole = L.norm_apply(params, x, use_kernel=True)
        per_token = torch.cat([L.norm_apply(params, x[:, j:j + 1].contiguous(), use_kernel=True)
                               for j in range(5)], dim=1)
        differing += int((whole != per_token).any(dim=-1).sum())
    assert ops.LAUNCHES["norm"] == 200 * 6
    assert differing == 0, f"{differing} of {200 * 40} rows round otherwise"


def test_paged_scatter_and_gather_on_the_card_equal_the_cpu(cuda):
    """``paged_update_rows`` and ``paged_gather`` at codeqwen's KV width
    (bf16, 32 heads of 128) on the card equal the CPU on every page but the
    trash page: rows past capacity, unbacked blocks and a free slot's zeroed
    table row all land on the trash page, several on one row, and never on a
    live page."""
    from repro_torch.models import cache_utils as C

    ps, nb, npages = 16, 4, 12
    gen = torch.Generator().manual_seed(0)
    pool = torch.randn((npages, ps, 32, 128), generator=gen).to(torch.bfloat16)
    bt = torch.tensor([[3, 7, 1, 9], [5, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([50, 30, 4], dtype=torch.int32)
    new = torch.randn((3, 17, 32, 128), generator=gen).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        p = pool.to(dev)
        rows = pos.to(dev).to(torch.int64)[:, None] + torch.arange(17, device=dev)
        C.paged_update_rows(p, new.to(dev), C.paged_phys_rows(bt.to(dev), rows, ps))
        out[str(dev)] = (p.cpu(), C.paged_gather(p, bt.to(dev), ps).cpu())
    (pc, gc), (pg, gg) = out["cpu"], out[str(cuda)]
    assert torch.equal(pg[1:], pc[1:])
    assert torch.equal(pg[10:], pool[10:])                  # pages no slot maps
    for b, backed in enumerate((nb, 2, 0)):
        assert torch.equal(gg[b, :backed * ps], gc[b, :backed * ps])


def test_paged_decode_step_and_admission_give_the_dense_logits_bit_for_bit(cuda):
    """codeqwen1.5-7b at full width and depth 2, bf16, through the kernels:
    eight prompts (40-150 tokens) admitted chunk by chunk into a 97-page
    pool (each slot alone, its pages scattered over the pool) give every
    chunk's logits of a dense batch-1 staging cache bit for bit, and the
    8-slot decode step over the gathered pages the dense 192-row cache's."""
    import dataclasses
    from repro_torch.models import cache_utils as C

    cfg = dataclasses.replace(registry.get_config("codeqwen1.5-7b"), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(0, ccfg, device=cuda)
    b, ps, t, chunk = 8, 16, 192, 32
    nb = t // ps
    dense = model.init_cache(b, t, dtype=torch.bfloat16, device=cuda)
    paged = model.init_paged_cache(b, b * nb + 1, ps, dtype=torch.bfloat16, device=cuda)
    rng = np.random.default_rng(0)
    lens = [40, 150, 64, 97, 33, 128, 71, 111]
    free = list(1 + rng.permutation(b * nb))
    bt = np.zeros((b, nb), np.int32)
    nxt = []
    with torch.no_grad():
        for slot, n in enumerate(lens):
            bt[slot, :-(-(n + 1) // ps)] = [free.pop() for _ in range(-(-(n + 1) // ps))]
            prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
            sub = model.init_cache(1, t, dtype=torch.bfloat16, device=cuda)
            lay = paged["layers"]
            view = {"layers": {**lay, "pos": lay["pos"][:, slot:slot + 1]}}
            row = torch.from_numpy(bt[slot:slot + 1]).to(cuda)
            for c0 in range(0, n, chunk):
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :min(chunk, n - c0)] = prompt[c0:c0 + chunk]
                toks = torch.from_numpy(toks).to(cuda)
                kw = dict(n_valid=min(chunk, n - c0), kv_len=c0 + chunk)
                want, sub = model.prefill_extend(params, {"tokens": toks}, sub, ccfg, **kw)
                got, _ = model.prefill_extend(params, {"tokens": toks, "block_table": row},
                                              view, ccfg, **kw)
                assert torch.equal(got, want), (slot, c0)
            model.write_cache(dense, sub, slot)
            nxt.append(int(torch.argmax(want[0, -1])))
        toks = torch.tensor(nxt, dtype=torch.int32, device=cuda)[:, None]
        ops.reset_launch_counts()
        want, _ = model.decode_step(params, {"tokens": toks}, dense, ccfg)
        got, _ = model.decode_step(params, {"tokens": toks,
                                            "block_table": torch.from_numpy(bt).to(cuda)},
                                   paged, ccfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 2 * cfg.n_layers
    assert torch.equal(got, want)
    assert torch.equal(paged["layers"]["pos"], dense["layers"]["pos"])
    view = C.paged_gather(paged["layers"]["k"][1], torch.from_numpy(bt).to(cuda), ps)
    for slot, n in enumerate(lens):
        assert torch.equal(view[slot, :n + 1], dense["layers"]["k"][1, slot, :n + 1])


# (E, C, K, N, group): olmoe's experts (64 of 2048 -> 1024 and 1024 -> 2048)
# at a decode step's, an admission chunk's and a verify pass's C, and
# deepseek-v2's (160 of 5120 -> 1536 and 1536 -> 5120) at a decode step's
# and (E = 160) at a verify pass's; rows from a top-k draw, with experts at
# 0 rows and at all C forced (so one expert has over 16 rows wherever C
# does); K and N off the tiles, C past two m-blocks (65) and C = 1; scale
# groups of 32 (on the 16-row step) and 24 (off it)
GROUPED_CASES = [(64, 8, 2048, 1024, 0), (64, 8, 1024, 2048, 0), (64, 32, 2048, 1024, 0),
                 (64, 40, 1024, 2048, 0), (160, 8, 5120, 1536, 0), (160, 8, 1536, 5120, 0),
                 (5, 65, 258, 301, 0), (3, 17, 96, 40, 0), (64, 1, 2048, 1024, 0),
                 (160, 40, 5120, 1536, 0), (8, 24, 512, 256, 32), (6, 40, 240, 136, 24),
                 (5, 9, 96, 300, 32), (4, 33, 144, 72, 24)]


def _grouped_inputs(cuda, e, c, k, n, seed, group=0):
    """Weights of e experts, routed rows from a top-k draw (expert 0 gets no
    row, expert 1 all C) and x with zero rows past each expert's, as the
    dispatch builds it."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ws = [quant.quantize_weight(torch.randn((k, n), generator=gen, device=cuda), group)
          for _ in range(e)]
    packed, scales = torch.stack([w[0] for w in ws]), torch.stack([w[1] for w in ws])
    top = min(8, e - 1)
    picks = torch.argsort(torch.rand((c, e), generator=gen, device=cuda), dim=-1)[:, :top]
    rows = torch.bincount(picks.flatten(), minlength=e).clamp(max=c)
    rows[0], rows[1] = 0, c
    rows = rows.to(torch.int32)
    x = torch.randn((e, c, k), generator=gen, device=cuda) / k ** 0.5
    x = torch.where(torch.arange(c, device=cuda)[None, :, None] < rows[:, None, None], x, 0.0)
    return x.to(torch.bfloat16), packed, scales, rows


@pytest.mark.parametrize("e,c,k,n,group", GROUPED_CASES)
@pytest.mark.parametrize("odtype", ["bfloat16", "float32"])
def test_grouped_matmul_equals_per_expert_calls_bit_for_bit(cuda, e, c, k, n, group, odtype):
    """One grouped launch gives every expert the bits of a per-expert
    ``ops.cascade_matmul`` over its C rows (zeros past its routed rows,
    none routed included), and agrees with the plain version."""
    x, packed, scales, rows = _grouped_inputs(cuda, e, c, k, n, seed=e + c + k, group=group)
    out_dtype = getattr(torch, odtype)
    ops.reset_launch_counts()
    got = ops.cascade_matmul_grouped(x, packed, scales, rows, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cascade_matmul_grouped"] == 1 and got.dtype == out_dtype
    loop = torch.stack([ops.cascade_matmul(x[i], packed[i], scales[i], out_dtype=out_dtype)
                        for i in range(e)])
    assert torch.equal(got, loop)
    assert not got[0].any() and not (got[2:] * (torch.arange(c, device=cuda)[None, :, None]
                                                >= rows[2:, None, None])).any()
    want = tcm.cascade_matmul_grouped_plain(x, packed, scales, rows, out_dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if odtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)


def test_grouped_matmul_zeros_past_the_rows_whatever_x_holds_there(cuda):
    """Rows at or past ``rows[e]`` are stored as exact zeros even where x is
    not zero, and an output full of another value is overwritten."""
    x, packed, scales, rows = _grouped_inputs(cuda, 6, 40, 1024, 2048, seed=9)
    x = x + 1.0
    got = tcm.cascade_matmul_grouped_cuda(x, packed, scales, rows, torch.float32)
    want = tcm.cascade_matmul_grouped_plain(x, packed, scales, rows, torch.float32)
    live = torch.arange(40, device=cuda)[None, :] < rows[:, None]
    torch.cuda.synchronize()
    assert not got[~live].any()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_grouped_matmul_with_no_routed_row_is_all_zeros(cuda):
    """Every expert at 0 rows: the launch succeeds, reads no weight and
    writes exact zeros over an output full of another value (one stack and
    the pair)."""
    x, packed, scales, rows = _grouped_inputs(cuda, 64, 8, 2048, 1024, seed=4)
    rows = torch.zeros_like(rows)
    ops.reset_launch_counts()
    got = ops.cascade_matmul_grouped(x, packed, scales, rows, out_dtype=torch.bfloat16)
    pair = ops.cascade_matmul_grouped_pair(x, (packed, scales), (packed, scales), rows,
                                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cascade_matmul_grouped"] == 2
    assert not got.any() and not pair[0].any() and not pair[1].any()


@pytest.mark.parametrize("c", [8, 40])
@pytest.mark.parametrize("odtype", ["bfloat16", "float32"])
def test_grouped_pair_is_one_launch_with_each_stacks_bits(cuda, c, odtype):
    """olmoe's gate and up (64 experts, 2048 -> 1024) in one launch: each
    output bit for bit its own per-expert loop and its own grouped launch,
    zeros past the rows."""
    x, pg, sg, rows = _grouped_inputs(cuda, 64, c, 2048, 1024, seed=21 + c)
    gen = torch.Generator(device=cuda).manual_seed(22 + c)
    ws = [quant.quantize_weight(torch.randn((2048, 1024), generator=gen, device=cuda), 0)
          for _ in range(64)]
    pu, su = torch.stack([w[0] for w in ws]), torch.stack([w[1] for w in ws])
    out_dtype = getattr(torch, odtype)
    ops.reset_launch_counts()
    gate, up = ops.cascade_matmul_grouped_pair(x, (pg, sg), (pu, su), rows, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cascade_matmul_grouped"] == 1
    live = torch.arange(c, device=cuda)[None, :] < rows[:, None]
    for got, p, s in ((gate, pg, sg), (up, pu, su)):
        loop = torch.stack([ops.cascade_matmul(x[i], p[i], s[i], out_dtype=out_dtype)
                            for i in range(64)])
        loop = torch.where(live[..., None], loop, torch.zeros((), dtype=out_dtype, device=cuda))
        assert torch.equal(got, loop)
        assert torch.equal(got, ops.cascade_matmul_grouped(x, p, s, rows, out_dtype=out_dtype))


def test_grouped_matmul_raises_on_what_it_does_not_take(cuda):
    x, packed, scales, rows = _grouped_inputs(cuda, 3, 8, 64, 32, seed=1)
    with pytest.raises(ValueError, match="not supported"):
        ops.cascade_matmul_grouped(x.float(), packed, scales, rows)
    with pytest.raises(ValueError, match="int32"):
        tcm.cascade_matmul_grouped_cuda(x, packed, scales, rows.long())
    with pytest.raises(ValueError, match="do not agree"):
        tcm.cascade_matmul_grouped_cuda(x[:2], packed, scales, rows)
    with pytest.raises(ValueError, match="do not agree"):
        tcm.cascade_matmul_grouped_pair_cuda(x, (packed, scales), (packed[:, :16], scales), rows)
    # a plan that is not the build's is refused before anything is launched:
    # the output keeps its 7s, and the build's own plan then runs
    out = torch.full((3, 8, 32), 7.0, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    pl = tcm.plan_grouped(3, 32)
    blocks = tcm.grouped_blocks(pl, 64, 64, torch.float32)
    head = (x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), None, None,
            None, rows.data_ptr(), 3, 8, 64, 32, 64, 0)

    def launch(**kw):
        p = {**pl, "blocks": blocks, **kw}
        return tcm._grouped_library().cascade_matmul_grouped_launch(
            *head, p["col_tile"], p["stages"], p["threads"], p["smem_bytes"], p["blocks"],
            stream)
    for wrong in ({"col_tile": 64}, {"stages": pl["stages"] + 1}, {"threads": 128},
                  {"smem_bytes": pl["smem_bytes"] + 16}, {"blocks": 0},
                  {"blocks": blocks + 1}):
        assert launch(**wrong) != 0, wrong
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert launch() == 0
    torch.cuda.synchronize()
    want = tcm.cascade_matmul_grouped_plain(x, packed, scales, rows, torch.float32)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


def test_router_logit_rows_are_bit_equal_at_decode_admission_and_verify_row_counts(cuda):
    """olmoe's router (2048 -> 64, f32): a token's logits are the same bits
    in a decode step's 8 rows, an admission chunk's 32 and a verify pass's
    40, so the three route it alike."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((40, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    router = torch.randn((2048, 64), generator=gen, device=cuda) * 0.02
    whole = moe.router_logits(x, router)
    for m in (1, 8, 32):
        assert torch.equal(moe.router_logits(x[:m], router), whole[:m]), m


def test_olmoe_paged_decode_step_and_admission_give_the_dense_logits_bit_for_bit(cuda):
    """olmoe-1b-7b at full width and depth 2, bf16, through the kernels (the
    grouped expert matmul among them): prompts admitted chunk by chunk into
    a page pool give every chunk's logits of a dense batch-1 staging cache
    bit for bit, and the 8-slot decode step over the gathered pages the
    dense cache's."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_config("olmoe-1b-7b"), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(0, ccfg, device=cuda)
    b, ps, t, chunk = 8, 16, 192, 32
    nb = t // ps
    dense = model.init_cache(b, t, dtype=torch.bfloat16, device=cuda)
    paged = model.init_paged_cache(b, b * nb + 1, ps, dtype=torch.bfloat16, device=cuda)
    rng = np.random.default_rng(1)
    lens = [40, 150, 64, 97, 33, 128, 71, 111]
    free = list(1 + rng.permutation(b * nb))
    bt = np.zeros((b, nb), np.int32)
    nxt = []
    ops.reset_launch_counts()
    with torch.no_grad():
        for slot, n in enumerate(lens):
            bt[slot, :-(-(n + 1) // ps)] = [free.pop() for _ in range(-(-(n + 1) // ps))]
            prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
            sub = model.init_cache(1, t, dtype=torch.bfloat16, device=cuda)
            lay = paged["layers"]
            view = {"layers": {**lay, "pos": lay["pos"][:, slot:slot + 1]}}
            row = torch.from_numpy(bt[slot:slot + 1]).to(cuda)
            for c0 in range(0, n, chunk):
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :min(chunk, n - c0)] = prompt[c0:c0 + chunk]
                toks = torch.from_numpy(toks).to(cuda)
                kw = dict(n_valid=min(chunk, n - c0), kv_len=c0 + chunk)
                want, sub = model.prefill_extend(params, {"tokens": toks}, sub, ccfg, **kw)
                got, _ = model.prefill_extend(params, {"tokens": toks, "block_table": row},
                                              view, ccfg, **kw)
                assert torch.equal(got, want), (slot, c0)
            model.write_cache(dense, sub, slot)
            nxt.append(int(torch.argmax(want[0, -1])))
        toks = torch.tensor(nxt, dtype=torch.int32, device=cuda)[:, None]
        want, _ = model.decode_step(params, {"tokens": toks}, dense, ccfg)
        got, _ = model.decode_step(params, {"tokens": toks,
                                            "block_table": torch.from_numpy(bt).to(cuda)},
                                   paged, ccfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cascade_matmul_grouped"] > 0 and ops.LAUNCHES["decode_attention"] > 0
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert torch.equal(paged["layers"]["pos"], dense["layers"]["pos"])


# ---------------------------------------------------------------------------
# Griffin (recurrentgemma-2b): local attention at head dim 256, the ring
# decode, and the RG-LRU's verify rows against its decode steps
# ---------------------------------------------------------------------------

def ring_slot_pos(b, t, positions, device):
    """(B, T) int32 ``slot_pos`` of a ring of T rows whose row b next writes
    position ``positions[b]``: row r holds the last position p < positions[b]
    with p % T == r, or -1 (never written)."""
    pos = torch.tensor(positions, dtype=torch.int64, device=device)[:, None]
    r = torch.arange(t, device=device)[None, :]
    last = pos - 1 - ((pos - 1 - r) % t)
    return torch.where(last >= 0, last, -1).to(torch.int32)


# (name, B, Hq, Hkv, S, ring T or 0, D, window, offsets): Griffin's admission
# chunk (S = 32 over a 2,048-row ring and the chunk) before and after the
# ring wraps, its verify pass (8 rows of 5), a windowed S = T = 2048 prompt
# at window 2048 and 512 (no k_pos), and small rings at D = 128 and 16
LOCAL_CASES = [("griffin_admit_early", 1, 10, 1, 32, 2048, 256, 2048, [96]),
               ("griffin_admit_wrapped", 1, 10, 1, 32, 2048, 256, 2048, [2040]),
               ("griffin_verify", 8, 10, 1, 5, 2048, 256, 2048,
                [40, 300, 1000, 2047, 2048, 2100, 3000, 4000]),
               ("prefill_w2048", 1, 10, 1, 2048, 0, 256, 2048, [0]),
               ("prefill_w512", 1, 10, 1, 2048, 0, 256, 512, [0]),
               ("ring_d128", 2, 8, 2, 7, 64, 128, 64, [10, 150]),
               ("ring_d16_w5", 3, 4, 4, 9, 16, 16, 5, [0, 9, 40])]


@pytest.mark.parametrize("name,b,hq,hkv,s,ring,d,window,offsets", LOCAL_CASES,
                         ids=[c[0] for c in LOCAL_CASES])
def test_flash_attention_local_cuda_matches_plain(cuda, name, b, hq, hkv, s, ring, d, window,
                                                  offsets):
    """Local attention on the kernel: with ``k_pos`` (a ring's rows at their
    positions, then the chunk's own) and ``window``, and a windowed prompt
    without ``k_pos``; within the flash tolerance of the plain version, also
    with every split count the plan could pick."""
    gen = torch.Generator(device=cuda).manual_seed(s + ring + d)
    t = ring + s if ring else s
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    kc = torch.randn((b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    vc = torch.randn((b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    args = (q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2))
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    k_pos = None
    if ring:
        rows = off[:, None] + torch.arange(s, device=cuda, dtype=torch.int32)
        k_pos = torch.cat([ring_slot_pos(b, ring, offsets, cuda), rows], dim=1)
    ops.reset_launch_counts()
    got = ops.flash_attention(*args, q_offset=off, k_pos=k_pos, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    want = tfa.flash_attention_plain(*args, True, None, off, k_pos, window)
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_tolerance(want, vc)).all()), float(err.max())
    for splits in (2, 5, 16):
        split = tfa.flash_attention_cuda(*args, True, None, off, k_pos, window, splits=splits)
        torch.cuda.synchronize()
        err = (split.float() - want.float()).abs()
        assert bool((err <= flash_tolerance(want, vc)).all()), (splits, float(err.max()))


def test_flash_attention_without_k_pos_or_window_keeps_its_bits(cuda):
    """``k_pos`` holding each key's own index and a window wider than T give
    the bits of the call without them (the masks are the same)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, hq, hkv, s, t, d = 8, 32, 32, 5, 192, 128
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, hkv, t, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, hkv, t, d), generator=gen, device=cuda).to(torch.bfloat16)
    off = torch.tensor([0, 27, 53, 80, 107, 133, 160, 187], dtype=torch.int32, device=cuda)
    base = ops.flash_attention(q, k, v, q_offset=off)
    idx = torch.arange(t, dtype=torch.int32, device=cuda).expand(b, t).contiguous()
    assert torch.equal(ops.flash_attention(q, k, v, q_offset=off, k_pos=idx), base)
    assert torch.equal(ops.flash_attention(q, k, v, q_offset=off, window=t + 8), base)


def test_flash_attention_refuses_local_arguments_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="k_pos"):
        ops.flash_attention(q, q, q, k_pos=torch.zeros((1, 8), device=cuda, dtype=torch.int64))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)


@pytest.mark.parametrize("positions", [[96 + 37 * i for i in range(8)],
                                       [2040, 2047, 2048, 2049, 2100, 3000, 4095, 6000]])
def test_decode_attention_ring_mask_at_griffin_shape(cuda, positions):
    """The ring decode as Griffin serves it: 8 slots, a 2,048-row ring, 10
    query heads over one KV head of 256 (two blocks of 5 heads), the (B, T)
    mask built from ``slot_pos``, before and after the ring wraps; within
    atol/rtol 1e-4 of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(sum(positions))
    b, t, hq, hkv, d, window = 8, 2048, 10, 1, 256, 2048
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    kc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    vc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    sp = ring_slot_pos(b, t, [p + 1 for p in positions], cuda)       # the token at p written
    mask = (sp >= 0) & (sp <= pos[:, None]) & (pos[:, None] - sp < window)
    ops.reset_launch_counts()
    got = ops.decode_attention(q, kc[1], vc[1], mask)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1 and tda.heads_per_block(hq // hkv) == 5
    want = tda.decode_attention_plain(q, kc[1], vc[1], mask)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _griffin_verify_vs_decode(cuda, n_layers):
    """recurrentgemma-2b at full width cut to ``n_layers``, bf16, FP4
    kernels, seed-0 weights: from one cache, 5 tokens decoded a step at a
    time, and from a copy one verify pass over them. Returns (decode
    logits per step, verify logits, decode R-block states per step, the
    verify checkpoint)."""
    import dataclasses

    cfg = dataclasses.replace(registry.get_config("recurrentgemma-2b"), n_layers=n_layers)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(0, ccfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, s = 8, 5
    prompt = torch.randint(0, cfg.vocab, (b, 32), generator=gen, device=cuda)
    chunk = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=cuda)
    with torch.no_grad():
        cache = model.init_cache(b, 64, dtype=torch.bfloat16, device=cuda)
        model.prefill_extend(params, {"tokens": prompt}, cache, ccfg)
        copy = _clone_tree(cache)
        decoded, states = [], []
        for j in range(s):
            lj, _ = model.decode_step(params, {"tokens": chunk[:, j:j + 1]}, cache, ccfg)
            decoded.append(lj[:, 0])
            states.append(cache["layers"]["h"].clone())
        verified, _, ckpt = model.spec_verify(params, {"tokens": chunk}, copy, ccfg)
        torch.cuda.synchronize()
    return decoded, verified, states, ckpt


def test_griffin_verify_rows_equal_decode_steps_bit_for_bit(cuda):
    """Depth 2 (two RG-LRU blocks, no attention): row j of the verify logits
    equals decode step j's bit for bit (the chunk's recurrence runs in order
    with decode's operations, its conv with decode's arithmetic, and every
    kernel's rows round alike at any row count), so a speculative greedy
    stream is the plain one. Depth 3 adds the local-attention block, which
    verifies through flash attention and decodes through decode attention:
    there the two R blocks' states after each token still equal the decode
    steps' bit for bit."""
    decoded, verified, states, ckpt = _griffin_verify_vs_decode(cuda, 2)
    rows_equal = [torch.equal(decoded[j], verified[:, j]) for j in range(len(decoded))]
    assert all(rows_equal), rows_equal
    _, _, states, ckpt = _griffin_verify_vs_decode(cuda, 3)
    for j, st in enumerate(states):
        assert torch.equal(ckpt["layers"]["h"][:, :, j + 1], st), j


def test_griffin_fused_engine_serves_past_the_window_with_the_path_kernels(cuda, monkeypatch):
    """Griffin's smoke config (window 16) at bf16 on the card, prompts and
    streams past the window: the fused engine launches its path's kernels
    (a verify pass: flash attention and no decode attention), and the plain
    greedy stream equals the engine's with every wrapper sent to its plain
    version."""
    cfg, model = registry.load("recurrentgemma-2b", smoke=True)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    params = model.init_params(0, ccfg, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [np.resize(rng.integers(0, cfg.vocab, 4), n).astype(np.int32) for n in (30, 9, 21)]

    def serve(**opts):
        eng = engine.ServeEngine(model, params, ccfg, engine.ServeConfig(
            max_batch=2, max_len=24, prefill_chunk=8, fused=True, **opts), device=cuda)
        reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=14) for i, p in enumerate(prompts)]
        ops.reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.tokens_out) == 14 for r in reqs)
        return [r.tokens_out for r in reqs], dict(ops.LAUNCHES)

    plain, launches = serve()
    assert all(launches[k] > 0 for k in ("cascade_matmul", "decode_attention",
                                         "flash_attention", "norm")), launches
    _, launches = serve(draft_len=3)
    assert launches["decode_attention"] == 0 and launches["flash_attention"] > 0
    for mod, name, plain_fn in ((tcm, "cascade_matmul_cuda", tcm.cascade_matmul_plain),
                                (tda, "decode_attention_cuda", tda.decode_attention_plain),
                                (tfa, "flash_attention_cuda", tfa.flash_attention_plain),
                                (tnorm, "norm_cuda", tnorm.norm_plain),
                                (tnorm, "add_norm_cuda", tnorm.add_norm_plain)):
        monkeypatch.setattr(mod, name, plain_fn)
    assert serve()[0] == plain


# ---------------------------------------------------------------------------
# QAT's FP4 fake quantization and the bit-accurate CASCADE matmul
# ---------------------------------------------------------------------------

def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, but any NaN equals any NaN."""
    nan = torch.isnan(got) & torch.isnan(want)
    if got.dtype == torch.bfloat16:
        gb, wb = got.view(torch.int16), want.view(torch.int16)
    else:
        gb, wb = got.view(torch.int32), want.view(torch.int32)
    return bool(((gb == wb) | nan).all())


def _qat_weight(shape, cuda, seed, edges):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(shape, generator=gen, device=cuda) * 0.02
    if edges:
        flat = w.reshape(-1, shape[-1])
        flat[:, 0] = 0.0                                 # an all-zero column: scale 1
        flat[:, 1] = 0.0
        flat[0, 1], flat[1, 1], flat[2, 1] = 6.0, 2.5, -0.25   # q on FP4 midpoints
        flat[3, 2] = float("nan")                        # a NaN column: scale 1
        flat[5, 3] = float("inf")
        flat[7, 4] = -1e-30
    return w


# (shape, group): phi4-mini's q/o, k/v, gate/up and down, codeqwen's up, a
# group of 32, a group that does not divide K (one group), a 3-D weight
# (one (-1, N) matrix), N off every strip width and off the 16-byte vector
# (one element a copy); tall groups split over a cluster: K = 3000, and K =
# 3001 (prime: the last block's rows fewer), with 16-byte copies and with
# one-element ones; groups taller than a cluster holds in one chunk (walked
# in chunks, read twice): nemotron4-15b's and qwen2.5-32b's down projections
# at group 0, and K = 24,576 with one-element copies
FQ_CASES = [((3072, 3072), 0), ((3072, 1024), 0), ((3072, 8192), 0), ((8192, 3072), 0),
            ((4096, 13440), 0), ((3072, 8192), 32), ((96, 40), 64), ((2, 48, 24), 16),
            ((64, 37), 0), ((40, 5), 8), ((3000, 1024), 0), ((3001, 200), 0), ((3001, 37), 0),
            ((24576, 6144), 0), ((27648, 5120), 0), ((24576, 37), 0)]


@pytest.mark.parametrize("shape,group", FQ_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("edges", [False, True])
def test_fake_quant_kernel_equals_plain_bit_for_bit(cuda, shape, group, dtype, edges):
    w = _qat_weight(shape, cuda, sum(shape) + group, edges).to(getattr(torch, dtype))
    ops.reset_launch_counts()
    got = ops.fake_quant_fp4(w, group)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fake_quant_fp4"] == 1 and got.dtype == w.dtype
    want = quant.fake_quant_fp4_plain(w, group)
    assert _same_bits(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fake_quant_kernel_expert_stack_is_one_launch_equal_to_per_expert_calls(cuda, dtype):
    w = _qat_weight((64, 2048, 1024), cuda, 5, False).to(getattr(torch, dtype))
    w[3, :, 7] = 0.0
    ops.reset_launch_counts()
    got = ops.fake_quant_fp4(w, 0, experts=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fake_quant_fp4"] == 1
    assert _same_bits(got, quant.fake_quant_fp4_plain(w, 0, experts=True))
    assert all(_same_bits(got[e], ops.fake_quant_fp4(w[e], 0)) for e in (0, 3, 63))


def _around(values, ulps):
    """Every f32 within ``ulps`` steps of each value, both signs."""
    bits = torch.tensor(values, dtype=torch.float32).view(torch.int32)
    near = (bits[:, None] + torch.arange(-ulps, ulps + 1, dtype=torch.int32)).reshape(-1)
    near = near.view(torch.float32)
    return torch.cat([near, -near])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fake_quant_kernel_rounds_every_quotient_like_the_plain_version(cuda, dtype):
    """A column whose absmax is 6 has scale 1, so each quotient is the value
    itself: in bf16 every finite value of magnitude up to 6 (all of them),
    in f32 every value within 64 steps of each FP4 grid value and midpoint
    and random ones; each must round onto the grid as the plain version's
    midpoint count rounds it."""
    if dtype == "bfloat16":
        every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
        vals = every.view(torch.bfloat16).float()
        vals = vals[torch.isfinite(vals) & (vals.abs() <= 6.0)]
    else:
        grid = [0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]
        gen = torch.Generator().manual_seed(3)
        vals = torch.cat([_around(grid, 64), torch.rand(20000, generator=gen) * 12 - 6,
                          torch.tensor([1e-40, -1e-45, 2.0 ** -126])])
        vals = vals[vals.abs() <= 6.0]
    cols = 64                                            # each column's row 0 is 6
    vals = torch.cat([vals, torch.zeros(-len(vals) % cols)]).reshape(-1, cols)
    w = torch.cat([torch.full((1, cols), 6.0), vals]).to(getattr(torch, dtype))
    w = torch.cat([w, -w, w / 3], dim=1).to(cuda)
    got = ops.fake_quant_fp4(w, 0)
    torch.cuda.synchronize()
    assert _same_bits(got, quant.fake_quant_fp4_plain(w, 0))


def test_fake_quant_kernel_gradient_is_straight_through(cuda):
    w = _qat_weight((3072, 1024), cuda, 9, False).to(torch.bfloat16).requires_grad_(True)
    g = torch.randn((3072, 1024), device=cuda).to(torch.bfloat16)
    out = ops.fake_quant_fp4(w, 32)
    (out.float() * g.float()).sum().backward()
    assert torch.equal(w.grad, g)


def test_fake_quant_kernel_raises_on_what_it_does_not_take(cuda):
    from repro_torch.kernels import fake_quant as tfq
    with pytest.raises(ValueError):
        tfq.fake_quant_fp4_cuda(torch.zeros((4, 4), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        tfq.fake_quant_fp4_cuda(torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        tfq.fake_quant_fp4_cuda(torch.zeros((2, 4, 4, 4), device=cuda), experts=True)


def _fp4_valued(shape, cuda, seed, scale):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return quant.fp4_round(torch.randn(shape, generator=gen, device=cuda) * scale)


# (M, K, N, bias): the chip smoke's codeqwen shapes at M = 8, a row tail
# (M = 20: 4 rows a thread, 5 warps), N off the 32-column block; M = 1 (one
# warp a block), M = 9 (2 rows a thread), M = 40 (8 rows a thread, a second
# block row of 8), and M = 128 with K off the 32-step tile and N off the
# column block
CE_CASES = [(8, 4096, 4096, False), (8, 4096, 13440, True), (8, 13440, 4096, False),
            (20, 300, 1000, True), (3, 64, 7, False), (1, 4096, 4096, True),
            (9, 300, 70, False), (40, 100, 33, True), (128, 4099, 1000, True)]


@pytest.mark.parametrize("m,k,n,with_bias", CE_CASES)
def test_cascade_exact_kernel_equals_plain_bit_for_bit(cuda, m, k, n, with_bias):
    """Random FP4 operands; row 0 all 6s against a positive column (the sum
    saturates at 448), a NaN in row 1 and a +inf in row 2."""
    x4 = _fp4_valued((m, k), cuda, m + k, 2.0)
    w4 = _fp4_valued((k, n), cuda, k + n, 2.0)
    x4[0] = 6.0
    w4[:, 0] = 6.0
    if m > 2:
        x4[1, k // 2] = float("nan")
        x4[2, 1] = float("inf")
    bias = torch.randn((n,), device=cuda) * 4 if with_bias else None
    ops.reset_launch_counts()
    got = ops.cascade_matmul_exact(x4, w4, bias)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cascade_matmul_exact"] == 1
    want = quant.cascade_matmul_exact(x4, w4, bias)
    assert _same_bits(got, want)
    assert float(got[0, 0]) == 448.0 and (m < 2 or bool(torch.isnan(got[1]).any()) == (m > 2))


def test_cascade_exact_kernel_takes_leading_dims_and_raises_on_the_rest(cuda):
    from repro_torch.kernels import cascade_exact as tce
    x4 = _fp4_valued((2, 3, 64), cuda, 1, 1.0)
    w4 = _fp4_valued((64, 40), cuda, 2, 1.0)
    got = ops.cascade_matmul_exact(x4, w4)
    assert got.shape == (2, 3, 40) and _same_bits(got, quant.cascade_matmul_exact(x4, w4))
    with pytest.raises(ValueError):
        tce.cascade_matmul_exact_cuda(x4[0].to(torch.bfloat16), w4)
    with pytest.raises(ValueError):
        tce.cascade_matmul_exact_cuda(x4[0], w4[:32])


#: the kernel route's gradient of each leaf against the plain route's
#: (every kernel on its plain version), smoke phi4-mini at bf16: the norm and
#: attention kernels' outputs differ from their plain versions' by a last
#: bf16 bit here and there, and each gradient sums such products over the
#: batch's tokens. Limits on | |g| - |g_plain| | / |g_plain| and
#: |g - g_plain| / |g_plain|, the largest over the leaves, at about twice the
#: readings on an H100 (0.0015 at `layers/attn/wv/w` and 0.0097 at
#: `layers/attn/wq/w`)
QAT_GRAD_NORM_RTOL, QAT_GRAD_RTOL = 2.0 ** -8, 2.0 ** -5.5


def test_qat_train_step_through_the_kernels_matches_the_plain_route(cuda, monkeypatch):
    """Smoke phi4-mini, bf16, QAT, remat "dots", on the card: each step
    launches the fake quantization 2 x 7 times a layer (forward and
    recompute); with the fake quantization on its plain version the loss
    and every gradient are bit-equal; against the route with every kernel on
    its plain version, the loss is within a bf16 step and each leaf's
    gradient within ``QAT_GRAD_NORM_RTOL`` in norm and ``QAT_GRAD_RTOL`` in
    relative L2."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.kernels import fake_quant as tfq
    from repro_torch.train import loop as tloop
    cfg, model = registry.load("phi4-mini-3.8b", smoke=True)
    ccfg = CascadeConfig(mode="train", qat=True, use_kernel=True, compute_dtype=torch.bfloat16)
    params = model.init_params(0, ccfg, device=cuda)
    for p in T.leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=cuda)}
    labels = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=cuda)

    def run(c):
        loss = tloop.cross_entropy(model.forward(params, batch, c, remat=True), labels)
        return loss.detach(), torch.autograd.grad(loss, T.leaves(params))

    ops.reset_launch_counts()
    loss, grads = run(ccfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fake_quant_fp4"] == 2 * 7 * cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with monkeypatch.context() as mp:
        mp.setattr(tfq, "fake_quant_fp4_cuda", tfq.fake_quant_fp4_plain)
        loss_plain_fq, grads_plain_fq = run(ccfg)
    assert torch.equal(loss, loss_plain_fq)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_plain_fq))
    loss_plain, grads_plain = run(dataclasses.replace(ccfg, use_kernel=False))
    assert abs(float(loss) - float(loss_plain)) <= 2.0 ** -7 * abs(float(loss_plain))
    names = ["/".join(path) for path, _ in T.leaves_with_paths(params)]
    worst_norm, worst_rel = {}, {}
    for name, g, gp in zip(names, grads, grads_plain):
        g, gp = g.float(), gp.float()
        ref = float(torch.linalg.vector_norm(gp))
        worst_norm[name] = abs(float(torch.linalg.vector_norm(g)) - ref) / ref
        worst_rel[name] = float(torch.linalg.vector_norm(g - gp)) / ref
    assert max(worst_norm.values()) <= QAT_GRAD_NORM_RTOL, worst_norm
    assert max(worst_rel.values()) <= QAT_GRAD_RTOL, worst_rel


# ---------------------------------------------------------------------------
# mesh serving: a rank's band of a call equals those outputs of the whole call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,m", [(4096, 13440, 8), (13440, 4096, 4), (4096, 92416, 2),
                                   (1024, 2048, 8), (96, 100, 4)])
def test_cascade_matmul_column_band_equals_the_whole_calls_columns(cuda, k, n, m):
    """Each rank's contiguous band of the packed weight (cascade placement)
    gives exactly those columns of the unsharded call, 32-column multiples
    or not (13440 / 8 = 1680, 100 / 4 = 25)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    codes = torch.randint(0, 256, (k // 2, n), generator=gen, device=cuda,
                          dtype=torch.int64).to(torch.uint8)
    scales = torch.rand((1, n), generator=gen, device=cuda) * 0.02 + 1e-3
    x = torch.randn((8, k), generator=gen, device=cuda).to(torch.bfloat16)
    full = ops.cascade_matmul(x, codes, scales, out_dtype=torch.bfloat16)
    w = n // m
    for r in range(m):
        band = ops.cascade_matmul(x, codes[:, r * w:(r + 1) * w].contiguous(),
                                  scales[:, r * w:(r + 1) * w].contiguous(),
                                  out_dtype=torch.bfloat16)
        assert torch.equal(band, full[:, r * w:(r + 1) * w]), r


@pytest.mark.parametrize("t", [192, 1024, 4096])
def test_attention_over_a_data_shard_plans_as_the_whole_grid(cuda, t):
    """Decode and flash attention over half the slot grid's rows, under
    ``ops.planned_rows``, equal the whole grid's call row for row, bit for
    bit, at any cache length (their split over the keys follows the rows a
    launch plans for)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    b, h, d, s = 8, 32, 128, 5
    k = torch.randn((b, t, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, t, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    qv = torch.randn((b, h, s, d), generator=gen, device=cuda).to(torch.bfloat16)
    pos = torch.randint(t // 2, t, (b,), generator=gen, device=cuda, dtype=torch.int32)
    off = (pos - s).clamp(min=0).to(torch.int32)
    dec = lambda lo, hi: ops.decode_attention(q[lo:hi], k[lo:hi], v[lo:hi], q_pos=pos[lo:hi])
    fla = lambda lo, hi: ops.flash_attention(qv[lo:hi], k[lo:hi].transpose(1, 2),
                                             v[lo:hi].transpose(1, 2), q_offset=off[lo:hi])
    for call in (dec, fla):
        full = call(0, b)
        with ops.planned_rows(b // 2, b):
            for r in range(2):
                assert torch.equal(call(r * b // 2, (r + 1) * b // 2),
                                   full[r * b // 2:(r + 1) * b // 2])


# ---------------------------------------------------------------------------
# an FP8 (e4m3) KV cache through both attention kernels
# ---------------------------------------------------------------------------

def _fp8_cache(gen, shape, device):
    """An e4m3 cache drawn from N(0, 1) (every code a finite value)."""
    return torch.randn(shape, generator=gen, device=device).to(torch.float8_e4m3fn)


# (B, Hq, Hkv, T, D, live, splits): the served codeqwen step, qwen2.5-32b's
# GQA 40/8 at T = 4,096 (split) and on its 2,048-row time band with lse,
# Griffin's ring band (10/1, D = 256, a mask), D = 80 and D = 64
FP8_DECODE_CASES = [(8, 32, 32, 192, 128, "q_pos", None), (8, 32, 32, 4096, 128, "q_pos", None),
                    (8, 40, 8, 2048, 128, "q_pos", None), (8, 10, 1, 1024, 256, "mask", None),
                    (8, 10, 1, 2048, 256, "mask", 1), (2, 6, 2, 300, 80, "q_pos", None),
                    (8, 32, 32, 192, 64, "mask", None), (2, 40, 8, 4096, 128, "q_pos", 3)]


@pytest.mark.parametrize("b,hq,hkv,t,d,live,splits", FP8_DECODE_CASES)
def test_decode_attention_on_an_fp8_cache_is_the_kernel_on_its_bf16_upcast(
        cuda, b, hq, hkv, t, d, live, splits):
    """The kernel reading e4m3 K/V (converted in registers) gives the bits
    it gives on the cache upcast to bf16 (exact), out and lse, and stays
    within the plain version's tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(b + t + d)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    kc = _fp8_cache(gen, (2, b, t, hkv, d), cuda)
    vc = _fp8_cache(gen, (2, b, t, hkv, d), cuda)
    mask = q_pos = None
    if live == "mask":
        mask = torch.rand((b, t), generator=gen, device=cuda) > 0.3
    else:
        q_pos = torch.randint(0, t, (b,), generator=gen, device=cuda).to(torch.int32)
        q_pos[0] = t + 5
    kw = {} if splits is None else {"splits": splits}
    o8, l8 = tda.decode_attention_cuda(q, kc[1], vc[1], mask, None, q_pos, return_lse=True, **kw)
    o16, l16 = tda.decode_attention_cuda(q, kc[1].to(torch.bfloat16), vc[1].to(torch.bfloat16),
                                         mask, None, q_pos, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o8, o16) and torch.equal(l8, l16)
    want = tda.decode_attention_plain(q, kc[1], vc[1], mask, q_pos=q_pos)
    torch.testing.assert_close(o8, want, atol=1e-4, rtol=1e-4)


# (name, B, Hq, Hkv, S, T, D, offsets, local): the verify chunk, an
# admission chunk (split over 4,096 live keys), GQA 40/8, D = 64, and
# Griffin's [ring, chunk] at D = 256 with k_pos and its window
FP8_FLASH_CASES = [("verify", 8, 32, 32, 5, 192, 128, [0, 27, 53, 80, 107, 133, 160, 187], False),
                   ("admit4064", 1, 32, 32, 32, 4096, 128, [4064], False),
                   ("g5_verify", 8, 40, 8, 5, 192, 128, [0, 27, 53, 80, 107, 133, 160, 187],
                    False),
                   ("d64_admit", 1, 32, 32, 32, 160, 64, [128], False),
                   ("griffin_ring", 2, 10, 1, 8, 72, 256, [100, 70], True)]


@pytest.mark.parametrize("name,b,hq,hkv,s,t,d,offsets,local", FP8_FLASH_CASES,
                         ids=[c[0] for c in FP8_FLASH_CASES])
def test_flash_attention_on_an_fp8_cache_is_the_kernel_on_its_bf16_upcast(
        cuda, name, b, hq, hkv, s, t, d, offsets, local):
    """e4m3 K/V staged into shared memory as bf16 (exact): the bits of the
    kernel on the cache upcast to bf16, within the plain version's
    tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(s * 3 + t)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(torch.bfloat16)
    kc = _fp8_cache(gen, (2, b, t, hkv, d), cuda)
    vc = _fp8_cache(gen, (2, b, t, hkv, d), cuda)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    kw = {}
    if local:                                      # ring rows at scattered positions
        kpos = torch.randint(-1, int(max(offsets)), (b, t), generator=gen, device=cuda)
        kpos[:, -s:] = off[:, None] + torch.arange(s, device=cuda)[None, :]
        kw = dict(k_pos=kpos.to(torch.int32), window=64)
    args8 = (q.transpose(1, 2), kc[1].transpose(1, 2), vc[1].transpose(1, 2))
    args16 = (args8[0], kc[1].to(torch.bfloat16).transpose(1, 2),
              vc[1].to(torch.bfloat16).transpose(1, 2))
    ops.reset_launch_counts()
    got = ops.flash_attention(*args8, q_offset=off, **kw)
    same = ops.flash_attention(*args16, q_offset=off, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2
    assert torch.equal(got, same)
    want = tfa.flash_attention_plain(*args8, q_offset=off, **kw)
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_tolerance(want, vc[1].float())).all()), float(err.max())


def test_the_attention_kernels_refuse_other_cache_mixes(cuda):
    q = torch.zeros((2, 4, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((2, 8, 2, 64), device=cuda, dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="float8_e4m3fn"):       # f32 q over e4m3
        ops.decode_attention(q.float(), kv, kv)
    with pytest.raises(ValueError, match="float8_e4m3fn"):       # e5m2
        ops.decode_attention(q, kv.to(torch.float8_e5m2), kv.to(torch.float8_e5m2))
    with pytest.raises(ValueError, match="float8_e4m3fn"):       # k and v differ
        ops.decode_attention(q, kv, kv.to(torch.bfloat16))
    qf = torch.zeros((1, 4, 8, 64), device=cuda, dtype=torch.bfloat16)
    kf = torch.zeros((1, 4, 8, 64), device=cuda, dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        ops.flash_attention(qf, kf, kf.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        ops.flash_attention(qf, kf.to(torch.float8_e5m2), kf.to(torch.float8_e5m2))


def test_fp8_cache_row_ops_on_the_card_equal_the_cpu_ones(cuda):
    """The cache's row work on float8 CUDA tensors (the dense row write, the
    paged pool's scatter and gather, a verify snapshot and rewind, the
    Griffin [ring, chunk] concatenation): every code the CPU's."""
    from repro_torch.models import cache_utils as cu
    from repro_torch.models import layers as tl
    gen = torch.Generator().manual_seed(5)
    codes = lambda *s: torch.randn(s, generator=gen).to(torch.float8_e4m3fn)
    same = lambda a, b: torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    buf, new, idx = codes(4, 16, 2, 8), codes(4, 3, 2, 8), torch.tensor([0, 5, 13, 20])
    dense = []
    for dev in (cuda, "cpu"):
        dense.append(buf.to(dev))
        tl.update_rows(dense[-1], new.to(dev).to(torch.float32), idx.to(dev))
    assert same(*dense)
    pool, bt = codes(6, 4, 2, 8), torch.tensor([[1, 3, 0], [2, 5, 4]])
    rows = torch.tensor([[2, 3, 4], [9, 10, 11]])
    outs = []
    for dev in (cuda, "cpu"):
        p = pool.to(dev)
        phys = cu.paged_phys_rows(bt.to(dev), rows.to(dev), 4)
        cu.paged_update_rows(p, new[:2].to(dev), phys)
        outs.append((p, cu.paged_gather(p, bt.to(dev), 4)))
    assert same(outs[0][0], outs[1][0]) and same(outs[0][1], outs[1][1])
    cat = torch.cat([buf.to(cuda), new.to(cuda)], dim=1)
    assert same(cat, torch.cat([buf, new], dim=1))
    cache = {"k": buf, "v": buf.clone(), "pos": torch.tensor([1, 4, 9, 12])}
    keep = torch.tensor([0, 2, 3, 1])
    res = []
    for dev in (cuda, "cpu"):
        c = {k: v.clone().to(dev) for k, v in cache.items()}
        snap = cu.seq_rows_snapshot(c, 3)
        tl.update_rows(c["k"], new.to(dev), c["pos"])
        c["pos"].add_(3)
        cu.seq_rows_restore(c, snap, keep.to(dev))
        res.append(c)
    assert same(res[0]["k"], res[1]["k"]) and torch.equal(res[0]["pos"].cpu(), res[1]["pos"])


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "recurrentgemma-2b", "deepseek-v2-236b"])
def test_an_fp8_cache_serves_through_the_kernels(cuda, arch):
    """The engine with ``kv_dtype=float8_e4m3fn`` and ``fused=True`` at smoke
    size, plain and speculative (codeqwen also paged with the prefix
    cache): every request ends with its tokens and the attention kernels
    launched on the FP8 cache (MLA's latent cache: its pad and row writes
    on float8, no attention kernel)."""
    cfg, model = registry.load(arch, smoke=True)
    ccfg = CascadeConfig(mode="serve_fp4", use_kernel=True, kv_dtype=torch.float8_e4m3fn)
    params = model.init_params(0, ccfg, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (12, 5, 20, 9)]
    runs = [{}, {"draft_len": 3}]
    if arch == "codeqwen1.5-7b":
        runs.append({"prefix_cache": True, "page_size": 4})
    for kw in runs:
        eng = engine.ServeEngine(model, params, ccfg, engine.ServeConfig(
            fused=True, max_batch=2, max_len=48, prefill_chunk=8, **kw), device=cuda)
        ops.reset_launch_counts()
        reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(len(r.tokens_out) == 6 and r.done for r in reqs), kw
        if arch == "deepseek-v2-236b":         # MLA's latent attention runs no kernel
            assert ops.LAUNCHES["cascade_matmul"] > 0, kw
            continue
        assert ops.LAUNCHES["flash_attention"] > 0, kw
        assert kw.get("draft_len") or ops.LAUNCHES["decode_attention"] > 0, kw


# ---------------------------------------------------------------------------
# AttnConfig.softmax_scale through both attention kernels
# ---------------------------------------------------------------------------

SOFTMAX_SCALE = 0.07


@pytest.mark.parametrize("window", [0, 16], ids=["full", "window"])
@pytest.mark.parametrize("mode", ["prefill", "extend", "decode"])
def test_softmax_scale_reaches_both_attention_kernels(cuda, mode, window):
    """``layers.attn_apply`` with ``AttnConfig(softmax_scale=0.07)`` on the
    kernel route (prefill and extend: ``flash_attention``; decode:
    ``decode_attention``) against its plain route at that scale, f32 q/k/v
    cast to bf16 for the kernels: within 2^-7 of max|plain| + 1e-3 (the
    attention output rounded once to bf16 before ``wo``); and moved from the
    default scale's kernel route by more than that."""
    from repro_torch.models import layers as L
    kw = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, qkv_bias=True, window=window)
    scaled, default = L.AttnConfig(**kw, softmax_scale=SOFTMAX_SCALE), L.AttnConfig(**kw)
    params = L.attn_init(torch.Generator(device=cuda).manual_seed(3), scaled,
                         CascadeConfig(mode="train"), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, s = 3, {"prefill": 24, "extend": 8, "decode": 1}[mode]
    x = torch.randn((b, s, 256), generator=gen, device=cuda).to(torch.bfloat16)
    prompt = torch.randn((b, 20, 256), generator=gen, device=cuda).to(torch.bfloat16)

    def run(cfg, use_kernel):
        ccfg = CascadeConfig(mode="train", compute_dtype=torch.bfloat16, use_kernel=use_kernel)
        if mode == "prefill":
            return L.attn_apply(params, x, cfg, ccfg, mode="prefill", max_len=48)[0]
        _, cache = L.attn_apply(params, prompt, cfg, ccfg, mode="prefill", max_len=48)
        return L.attn_apply(params, x, cfg, ccfg, cache=cache, mode=mode)[0]

    ops.reset_launch_counts()
    got = run(scaled, True)
    torch.cuda.synchronize()
    kernel = "decode_attention" if mode == "decode" else "flash_attention"
    assert ops.LAUNCHES[kernel] >= 1
    want = run(scaled, False)
    tol = 2.0 ** -7 * float(want.float().abs().max()) + 1e-3
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((run(default, True).float() - got.float()).abs().max()) > tol


@pytest.mark.parametrize("case", ["decode", "verify", "admit", "griffin_local"])
def test_softmax_scale_kernels_match_their_plain_versions(cuda, case):
    """The kernels at scale 0.07 at the chip smoke's codeqwen shapes (the
    served decode step; the verify pass; an admission chunk at offset 96)
    and Griffin's local attention (D = 256, ``k_pos``, window 2048): within
    each kernel's tolerance of its plain version at that scale."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    if case == "decode":
        q, k, v = rnd(8, 32, 128), rnd(8, 192, 32, 128), rnd(8, 192, 32, 128)
        pos = torch.tensor([128 + 4 * i for i in range(8)], dtype=torch.int32, device=cuda)
        got = ops.decode_attention(q, k, v, q_pos=pos, scale=SOFTMAX_SCALE)
        want = tda.decode_attention_plain(q, k, v, q_pos=pos, scale=SOFTMAX_SCALE)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    b, s, t, off, hq, hkv, d, ring = {
        "verify": (8, 5, 192, [round(i * 187 / 7) for i in range(8)], 32, 32, 128, 0),
        "admit": (1, 32, 128, [96], 32, 32, 128, 0),
        "griffin_local": (1, 32, 2048 + 32, [96], 10, 1, 256, 2048)}[case]
    qv = rnd(b, s, hq, d).transpose(1, 2)
    kc, vc = rnd(b, t, hkv, d), rnd(b, t, hkv, d)
    offs = torch.tensor(off, dtype=torch.int32, device=cuda)
    k_pos, window = None, 0
    if ring:
        rows = offs[:, None] + torch.arange(s, device=cuda, dtype=torch.int32)
        k_pos, window = torch.cat([ring_slot_pos(b, ring, off, cuda), rows], dim=1), ring
    args = (qv, kc.transpose(1, 2), vc.transpose(1, 2))
    got = ops.flash_attention(*args, scale=SOFTMAX_SCALE, q_offset=offs, k_pos=k_pos,
                              window=window)
    want = tfa.flash_attention_plain(*args, True, SOFTMAX_SCALE, offs, k_pos, window)
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_tolerance(want, vc)).all()), float(err.max())


# ---------------------------------------------------------------------------
# serving fulldp: two gloo ranks sharing the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fulldp_world():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card")
    from repro_torch.launch import mesh as meshlib
    rng = np.random.default_rng(0)
    inputs = {"fulldp": {a: rng.integers(0, 256, (3, 13)).astype(np.int32)
                         for a in R.FULLDP_ARCHS}, "fulldp_max_len": 24}
    return meshlib.run_local_ranks(2, R.fulldp_card, inputs, threads=2, timeout=600)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", list(R.FULLDP_ARCHS))
def test_fulldp_serving_cell_on_the_card_equals_the_unsharded_step(fulldp_world, arch, kind):
    """The dry run's prefill and decode cells under ``--act-policy fulldp``
    on (1, 2), FP4 params, bf16, through the kernels, 3 rows (a rank's share
    padded): the norms run on a rank's rows, the kernels on the gathered
    rows, whose bits do not depend on the row count, so the logits and the
    cache are the unsharded step's bit for bit; where the cache's time or
    latent rows are banded, decode merges the bands' attentions (as the
    plain cell does): the plain cascade cell's bits."""
    for rank in (0, 1):
        res = fulldp_world[rank][arch]
        (want, got), (cache_want, cache_got) = res[kind]["logits"], res[kind]["cache"]
        assert np.isfinite(got).all()
        ref = res["cascade_cell"] if kind == "decode" and R.FULLDP_ARCHS[arch] else (want,
                                                                                  cache_want)
        np.testing.assert_array_equal(got, ref[0])
        for name in cache_want:
            np.testing.assert_array_equal(cache_got[name], ref[1][name], err_msg=name)
