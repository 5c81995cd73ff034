"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a Hopper card (the
kernels are built for sm_90a). This file imports torch only, so it runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
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
                (65, 4096, 13440, 0, False)]


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
                       (258, 301, 0, True), (1032, 1000, 24, True)]


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
                (2, 6, 2, 300, 80)]


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
               ("g20", 1, 40, 2, 7, 50, 16, True, [30])]


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
# 8,192; a width off 16 bytes
NORM_CASES = [((8,), 1024), ((8, 5), 2048), ((8, 1), 4096), ((40,), 4096), ((3, 2), 8192),
              ((5,), 1000), ((2, 3), 36)]


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
                                         (2048, "layernorm"), (4096, "layernorm")])
def test_norm_kernel_rows_round_alike_in_any_number_of_rows(cuda, d, norm_type):
    """The norm kernel over (8, 5, d) bf16 rows (a verify chunk) gives each
    token's rows what it gives over that token's (8, 1, d) rows (a decode
    step), bit for bit: codeqwen's width and mamba2-370m's, RMSNorm and
    LayerNorm, 100 draws of 40 rows."""
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
# (..., 4384) output; widths off 16 bytes
FUSED_NORM_CASES = [("add", (8, 1), 4096, "rmsnorm"), ("add", (8, 5), 4096, "rmsnorm"),
                    ("add", (1, 32), 4096, "rmsnorm"), ("add", (8, 1), 1024, "rmsnorm"),
                    ("add", (8, 5), 1024, "rmsnorm"), ("add", (8, 1), 4096, "layernorm"),
                    ("add", (5,), 1000, "layernorm"), ("gated", (8, 1), 2048, "rmsnorm"),
                    ("gated", (8, 5), 2048, "rmsnorm"), ("gated", (3, 2), 36, "rmsnorm")]


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


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-370m"])
def test_spec_engine_at_full_width_launches_the_path_kernels(cuda, arch):
    """A 2-layer full-width model served speculatively (draft 4, greedy):
    every request finishes, each verify pass launches flash attention once
    per layer (codeqwen) or the SSD scan once per layer and chunk token
    (Mamba-2), and no verify pass launches decode attention."""
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
