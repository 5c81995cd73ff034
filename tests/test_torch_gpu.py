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
# many group edges), no bias, and full-width codeqwen shapes
MATMUL_CASES = [(3, 64, 48, 0, True), (5, 63, 37, 0, False), (4, 96, 100, 24, True),
                (1, 130, 70, 65, False), (7, 258, 301, 0, True), (9, 512, 72, 64, False),
                (17, 160, 45, 32, True), (2, 48, 33, 1, False), (6, 36, 20, 2, True),
                (8, 4096, 13440, 0, True), (33, 13440, 4096, 0, False)]


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


@pytest.mark.parametrize("b,hq,hkv,t,d", [(3, 8, 2, 700, 16), (8, 32, 32, 192, 128),
                                          (4, 8, 1, 513, 256), (2, 4, 4, 1, 64)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_attention_cuda_matches_plain(cuda, b, hq, hkv, t, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b * 100 + t)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).to(dt)
    # a layer view of a stacked (L, B, T, Hkv, D) cache: read through strides
    kc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(dt)
    vc = torch.randn((2, b, t, hkv, d), generator=gen, device=cuda).to(dt)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
    mask = torch.arange(t, device=cuda)[None, :] < lens[:, None]
    if b > 1:
        mask[-1] = False                 # a row with no live key: uniform average
    ops.reset_launch_counts()
    got = ops.decode_attention(q, kc[1], vc[1], mask)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1
    want = tda.decode_attention_plain(q, kc[1], vc[1], mask)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


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
PATH_KERNELS = {"codeqwen1.5-7b": {"cascade_matmul", "decode_attention", "flash_attention"},
                "mamba2-370m": {"cascade_matmul", "ssd_scan"}}


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
               ("smoke_d16", 2, 4, 2, 9, 24, 16, True, [3, 15])]


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
        if arch == "mamba2-370m":
            assert step["ssd_scan"] == 2 * 5 and step["flash_attention"] == 0
        else:
            assert step["flash_attention"] == 2 and step["ssd_scan"] == 0
        assert step["cascade_matmul"] > 0
