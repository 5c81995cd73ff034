#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

from the root of a checkout. It builds the CUDA kernels from ``src/repro_torch/
kernels/csrc`` with nvcc (sm_90a), all at once, and runs the phases below on
the two served paths, the dense transformer (codeqwen1.5-7b) and Mamba-2
(mamba2-370m); any failure exits non-zero before the final ``ok`` line is
printed.

1. Kernels: each CUDA kernel at the shapes the serving paths give it, held
   to its plain PyTorch version on the same inputs (tolerances below), and
   timed with CUDA events over CUDA-graph replays of many launches (device
   time, no host launch gaps), beside its plain version, one library call
   computing the same function where there is one, and the least time the
   card could take. The FP4 matmul runs at a decode step's 8 rows, an
   admission chunk's 32, a verify pass's 40 and (codeqwen's MLP) 64, each
   row with its launch plan (m-tiles a block, grid); at each served weight
   shape its rows over 1-64 leading rows of x must equal, bit for bit, the
   same rows of a call over 65. Decode attention runs at three shapes: the served
   codeqwen step, qwen2.5-32b's GQA heads (40 over 8) and a 4096-row
   cache whose rows are split across blocks. The SSD scan is also held to
   its plain version at a multi-step shape with an initial state and at a
   grouped (G > 1) shape;
   flash attention at the TPU kernel's own signature (S = T = 128 and 2048,
   causal and not), at GQA heads, at the admission chunk (over its live
   cache prefix, early in a 192-row cache and late in a 4,096-row one) and
   the verify pass (per-row offsets into a 192-row cache), and on strided
   views, each row with the launch plan (heads per block, splits over the
   keys; a split call is also timed unsplit); the
   norm at the served widths and row counts (codeqwen's 4,096, mamba2-370m's
   1,024 and gated 2,048; a decode step's 8 rows, a verify pass's 40, an
   admission chunk's 32), where each token's rows must also equal, bit for
   bit, what a one-token call over the same slots gives; its fused forms
   (the residual add inside the norm at 4,096 and 1,024, Mamba-2's gate
   inside the gated norm at 2,048 with z a column slice of in_proj's
   4,384-wide output) must equal, bit for bit, the route they replaced (the
   eager add or gate, then the norm kernel), also in one-token calls.
2. Parity, per path and for qwen2.5-32b (GQA 40/8, QKV bias, decode
   attention at G = 5): the model cut to 2 layers at full width, one padded
   prefill chunk, one decode step and one speculative verify chunk (8 rows
   of 1 + 4 tokens) through the kernels, and again with the wrappers sent to
   the kernels' plain versions on the card (the same functions on the same
   weights); the logits must agree within a stated number of bf16 steps and
   a relative L2 error.
3. Serve, per path: the full model (random FP4 weights from a seed) through
   ServeEngine(fused=True): 16 requests, prompt 128, 32 new tokens, 8
   slots, prefill chunk 32. Every request must finish with 32 tokens, every
   logit must be finite, and every kernel of the run must have launched in
   it (launch counts are reset just before each run and read just after).
   Runs: plain greedy decode on random prompts; then, on repetitive prompts
   (a short pattern tiled), plain greedy and speculative greedy decode
   (draft 4), whose streams are compared (a divergence is reported with the
   plain run's top-2 logit margin there, and fails the run when that margin
   exceeds the path's bf16-step limit); on codeqwen also speculative
   sampling (temperature 0.8, top-k 50), twice with one seed, which must
   give the same streams, and plain greedy at a 4,096-token context (2
   prompts of 4,064 tokens, 8 new tokens each), whose late admission chunks
   must split flash attention over the keys and whose early ones must not.

Stdout: the card's name and power limit first, then one line per phase, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``. The
full record goes to ``results/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (dense): device memory and bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# kernel vs plain version, both on the same bf16 inputs:
#   cascade_matmul (f32 out): the same exact products summed in f32 in
#     another order -> |err| <= MATMUL_RTOL * max|plain| + MATMUL_ATOL
#   cascade_matmul (bf16 out, as served): that, plus at most one bf16 step
#     of the largest output -> |err| <= 2^-7 * max|plain| + MATMUL_ATOL
#   decode_attention (f32 out): online vs two-pass softmax in f32
#   ssd_scan: the state update is the same elementwise f32 arithmetic as the
#     plain version (no FMA contraction; expf as torch.exp) -> state within
#     SSD_STATE_TOL (abs and rel); the readout state @ C sums over N in
#     another order, then y rounds to bf16 -> every y within one bf16 step:
#     |err| <= 2^-7 * |plain| + SSD_Y_ATOL
#   flash_attention (bf16 out): online softmax with p carried as two bf16
#     terms (~2^-18 relative) and f32 sums in another order, then the bf16
#     rounding of the output -> |err| <= 2^-7 * |plain| + 2^-12 * max|v|
#   norm (bf16 out): the same f32 arithmetic with the row's sum in another
#     order, then one bf16 rounding -> |err| <= 2^-7 * |plain|, plus
#     2^-20 * max|plain| where LayerNorm's bias add cancels to near 0 (the
#     last f32 bits of terms as large as the outputs show there)
#   depth-2 parity (bf16 logits, kernels vs their plain versions): the same
#     functions summed in another order. Once one f32 sum lands on the other
#     side of a bf16 rounding edge, every later bf16 rounding on that row
#     differs. Limits per path: ||kernel - plain|| <= rel_l2 * ||plain|| and
#     every logit within max_steps bf16 steps (units in the last place) of
#     max|plain|, set at about twice the readings on an H100. codeqwen: the
#     two runs end about one step apart (relative L2 0.0064, max one step,
#     73% of logits not bit-equal). mamba2-370m: relative L2 0.00060 /
#     0.00096 and at most 0.44 of a step (prefill / decode; its logits leave
#     the tied head in f32, and 25% of them moved)
MATMUL_RTOL, MATMUL_ATOL = 1e-4, 1e-4
MATMUL_BF16_RTOL = 2.0 ** -7
ATTN_ATOL = 1e-4
FLASH_RTOL, FLASH_VTOL = 2.0 ** -7, 2.0 ** -12
SSD_STATE_TOL = 1e-5
SSD_Y_RTOL, SSD_Y_ATOL = 2.0 ** -7, 1e-5
#: arch -> (rel_l2, max_steps)
#     qwen2.5-32b (GQA 40/8, decode attention at G = 5) takes codeqwen's
#     limits: a dense transformer of the same kind
PARITY_LIMITS = {"codeqwen1.5-7b": (2.0 ** -6, 2), "mamba2-370m": (2.0 ** -9, 1),
                 "qwen2.5-32b": (2.0 ** -6, 2)}
# f32 rate outside the tensor cores (the SSD scan's arithmetic)
F32_FLOP_PER_S = 67e12

PROMPT_LEN, MAX_NEW, N_REQ, MAX_BATCH, CHUNK = 128, 32, 16, 8, 32
DRAFT_LEN = 4
#: the long-context serve run (codeqwen): a 4,096-token context, prompts
#: that fill it but for a chunk, admitted in 127 chunks of 32
LONG_LEN, LONG_REQ, LONG_BATCH, LONG_NEW = 4096, 2, 2, 8

ARCHS = ("codeqwen1.5-7b", "mamba2-370m")
#: the depth-2 parity phase also runs a GQA transformer (not served here)
PARITY_ARCHS = ARCHS + ("qwen2.5-32b",)
#: (arch, decode) -> the kernels that run launches; a speculative step's
#: decode is the verify pass, which never launches decode attention
RUN_KERNELS = {("codeqwen1.5-7b", "plain"): ("cascade_matmul", "decode_attention",
                                             "flash_attention", "norm"),
               ("codeqwen1.5-7b", "spec"): ("cascade_matmul", "flash_attention", "norm"),
               ("mamba2-370m", "plain"): ("cascade_matmul", "norm", "ssd_scan"),
               ("mamba2-370m", "spec"): ("cascade_matmul", "norm", "ssd_scan")}
NORM_RTOL, NORM_MTOL = 2.0 ** -7, 2.0 ** -20


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def graph_ms(torch, fn, argsets, iters: int) -> float:
    """Device ms per call: ``iters`` calls cycling over ``argsets`` (rotated
    so weights come cold from device memory, as layer after layer does),
    captured once in a CUDA graph and replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(3, iters)):
            fn(*argsets[i % len(argsets)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    t1.synchronize()
    ms = t0.elapsed_time(t1) / iters
    del g
    torch.cuda.empty_cache()
    return ms


def host_us(torch, fn, args, iters: int = 2000) -> float:
    """Host µs per call: ``iters`` eager calls enqueued back to back (no
    synchronisation between them; a call's device time is shorter than its
    host time, so the queue never fills), on the host clock."""
    for _ in range(20):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def copies_beyond_l2(nbytes: int) -> int:
    return max(1, -(-160 * 2 ** 20 // max(nbytes, 1)))


#: (arch, K, N, bias) -> launches per decode step, and per verify pass:
#: codeqwen's q/k/v/o (QKV bias), gate/up and down, and mamba2-370m's
#: in_proj and out_proj, in each of 32 and 48 layers
MATMUL_LAYERS = {("codeqwen1.5-7b", 4096, 4096, True): 4 * 32,
                 ("codeqwen1.5-7b", 4096, 13440, False): 2 * 32,
                 ("codeqwen1.5-7b", 13440, 4096, False): 32,
                 ("mamba2-370m", 1024, 4384, False): 48,
                 ("mamba2-370m", 2048, 1024, False): 48}
#: codeqwen's FP4 lm_head, once a step (mamba2-370m's head is tied to the
#: embedding: no FP4 matmul)
MATMUL_HEAD = ("codeqwen1.5-7b", 4096, 92416, False)
#: leading row counts whose rows must equal, bit for bit, the same rows of
#: a call over ROWS_ACROSS_M rows: 1 to 4 m-tiles a block, two block rows
ROWS_ACROSS_M = 65
ROW_COUNTS = (1, 8, 16, 17, 40, 64)


def matmul_shapes():
    """(arch, M, K, N, bias, launches per decode step, launches per verify
    pass): the layers and the head at a decode step's M = 8 and a verify
    pass's 40 (8 slots x (draft 4 + 1)), the layers at an admission chunk's
    32, codeqwen's MLP at 64 (the most rows one block holds) and its head at
    M = 1."""
    v = MAX_BATCH * (1 + DRAFT_LEN)
    layers = list(MATMUL_LAYERS.items()) + [(MATMUL_HEAD, 1)]
    rows = []
    for m in (MAX_BATCH, CHUNK, v):
        for (arch, k, n, bias), count in layers if m != CHUNK else layers[:-1]:
            rows.append((arch, m, k, n, bias, count if m == MAX_BATCH else 0,
                         count if m == v else 0))
    cq = MATMUL_HEAD[0]
    return rows + [(cq, 64, 4096, 13440, False, 0, 0), (cq, 64, 13440, 4096, False, 0, 0),
                   (cq, 1, *MATMUL_HEAD[1:], 0, 0)]


def matmul_phase(torch, dev):
    from repro_torch.core import quant
    from repro_torch.kernels import cascade_matmul as cm
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for arch, m, k, n, with_bias, per_step, per_verify in matmul_shapes():
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        packed, scales = quant.quantize_weight(w, 0)
        del w
        bias = torch.randn((n,), generator=gen, device=dev) if with_bias else None
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = ops.cascade_matmul(x, packed, scales, bias, out_dtype=torch.float32)
        want = cm.cascade_matmul_plain(x, packed, scales, bias, torch.float32)
        got16 = ops.cascade_matmul(x, packed, scales, bias, out_dtype=torch.bfloat16)
        want16 = cm.cascade_matmul_plain(x, packed, scales, bias, torch.bfloat16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = MATMUL_RTOL * float(want.abs().max()) + MATMUL_ATOL
        if not err <= tol:
            fail(f"cascade_matmul ({m},{k},{n}) f32 out: max|err| {err} > {tol}")
        err16 = float((got16.float() - want16.float()).abs().max())
        tol16 = MATMUL_BF16_RTOL * float(want16.float().abs().max()) + MATMUL_ATOL
        if not err16 <= tol16:
            fail(f"cascade_matmul ({m},{k},{n}) bf16 out: max|err| {err16} > {tol16}")
        wbytes = packed.numel() + scales.numel() * 4
        nc = copies_beyond_l2(wbytes)
        sets = [(x, packed.clone(), scales.clone(), bias) for _ in range(nc)]
        kern = lambda a, p, s, b: ops.cascade_matmul(a, p, s, b, out_dtype=torch.bfloat16)
        plain = lambda a, p, s, b: cm.cascade_matmul_plain(a, p, s, b, torch.bfloat16)
        dense = quant.dequantize_weight(packed, scales, torch.bfloat16)
        bias16 = bias.to(torch.bfloat16) if bias is not None else None
        lib_sets = [(x, dense if i == 0 else dense.clone(), bias16)
                    for i in range(copies_beyond_l2(dense.numel() * 2))]
        lib = ((lambda a, wd, b: torch.addmm(b, a, wd)) if bias is not None
               else (lambda a, wd, b: torch.matmul(a, wd)))
        pl = cm.plan(m, k, n)
        row = {
            "arch": arch, "M": m, "K": k, "N": n, "bias": with_bias,
            "m_tiles": pl["m_tiles"], "grid": list(pl["grid"]),
            "launches_per_decode_step": per_step, "launches_per_verify_step": per_verify,
            "max_abs_err": err, "tol": tol, "max_abs_err_bf16_out": err16, "tol_bf16_out": tol16,
            "ms": graph_ms(torch, kern, sets, 40),
            "plain_ms": graph_ms(torch, plain, sets[:1], 3),
            "library_ms": graph_ms(torch, lib, lib_sets, 20),
        }
        nbytes = m * k * 2 + wbytes + (n * 4 if with_bias else 0) + m * n * 2
        flops = 2 * m * k * n
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S \
            else "operations"
        rows.append(row)
        del sets, lib_sets, dense
        torch.cuda.empty_cache()
    return rows


def matmul_rows_phase(torch, dev):
    """Each layer's weight shape once, ROWS_ACROSS_M rows of x: the kernel
    over the leading ROW_COUNTS rows must give every row the bits it gets in
    the call over all of them (bf16 out as served, and f32), so a verify
    pass's rows round as a decode step's. Fails on any differing bit."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out = []
    for arch, k, n, with_bias in MATMUL_LAYERS:
        packed, scales = quant.quantize_weight(torch.randn((k, n), generator=gen, device=dev), 0)
        bias = torch.randn((n,), generator=gen, device=dev) if with_bias else None
        x = (torch.randn((ROWS_ACROSS_M, k), generator=gen, device=dev) / k ** 0.5) \
            .to(torch.bfloat16)
        differ = {}
        for odt in (torch.bfloat16, torch.float32):
            whole = ops.cascade_matmul(x, packed, scales, bias, out_dtype=odt)
            for m in ROW_COUNTS:
                got = ops.cascade_matmul(x[:m].contiguous(), packed, scales, bias, out_dtype=odt)
                rows = (got != whole[:m]).any(dim=-1).nonzero().flatten().tolist()
                if rows:
                    differ[f"{odt} M={m}"] = rows
        torch.cuda.synchronize()
        res = {"arch": arch, "K": k, "N": n, "bias": with_bias, "row_counts": list(ROW_COUNTS),
               "against_rows": ROWS_ACROSS_M, "rows_equal": not differ}
        if differ:
            fail(f"cascade_matmul ({k},{n}): rows round otherwise at another M: {differ}")
        out.append(res)
    return out


def decode_attention_cases():
    """(name, B, Hq, Hkv, T, positions), D = 128: the served codeqwen step
    (8 slots at 128-156 of the engine's 192-row cache), qwen2.5-32b's GQA
    heads (40 over 8) at the same positions, and a long context (T = 4096,
    positions spread over 2,047-4,095, so 2,048-4,096 live keys a row)."""
    t = -(-(PROMPT_LEN + MAX_NEW + 1) // CHUNK) * CHUNK      # the engine's cache length
    served = [PROMPT_LEN + 4 * i for i in range(MAX_BATCH)]
    long_pos = [2047 + round(i * 2048 / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    return [("codeqwen_step", MAX_BATCH, 32, 32, t, served),
            ("qwen2.5-32b_gqa", MAX_BATCH, 40, 8, t, served),
            ("long_4096", MAX_BATCH, 32, 32, 4096, long_pos)]


def attention_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    d = 128
    rows = []
    for name, b, hq, hkv, t, positions in decode_attention_cases():
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        # one layer's view of a stacked (L, B, T, Hkv, D) cache, read in place
        kc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = kc[1], vc[1]
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        mask = torch.arange(t, device=dev)[None, :] <= pos[:, None]
        live = int(mask.sum())
        # as served: live keys up to each row's position, no mask
        got = ops.decode_attention(q, k, v, q_pos=pos)
        want = da.decode_attention_plain(q, k, v, q_pos=pos)
        by_mask = ops.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        mask_err = float((by_mask - want).abs().max())
        if not max(err, mask_err) <= ATTN_ATOL:
            fail(f"decode_attention {name}: max|err| {err} (q_pos), {mask_err} (mask) "
                 f"> {ATTN_ATOL}")
        nc = copies_beyond_l2(k.numel() * 4)
        sets = [(q, k if i == 0 else k.clone(), v if i == 0 else v.clone(), pos)
                for i in range(nc)]
        kern = lambda a, kk, vv, p: ops.decode_attention(a, kk, vv, q_pos=p)
        plain = lambda a, kk, vv, p: da.decode_attention_plain(a, kk, vv, q_pos=p)
        lib = lambda a, kk, vv, p: F.scaled_dot_product_attention(
            a[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=hq != hkv)
        big = t > 1024
        row = {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "T": t, "D": d, "q_pos": positions,
               "live_keys": live, "splits": da.choose_splits(b, hkv, hq // hkv, t),
               "heads_per_block": da.heads_per_block(hq // hkv),
               "max_abs_err": err, "max_abs_err_mask_route": mask_err, "tol": ATTN_ATOL,
               "ms": graph_ms(torch, kern, sets, 20 if big else 100),
               "plain_ms": graph_ms(torch, plain, sets, 5 if big else 20),
               "library_ms": graph_ms(torch, lib, sets, 20 if big else 100)}
        # every live K/V row read once per kv head, q and q_pos read, out written
        nbytes = q.numel() * 2 + 2 * live * hkv * d * 2 + b * 4 + b * hq * d * 4
        flops = 4 * live * hq * d
        row.update({"bytes": nbytes, "flops": flops,
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
                    "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                                 else "operations")})
        if name == "codeqwen_step":
            row["launches_per_decode_step"] = 32
        rows.append(row)
        del sets, kc, vc
        torch.cuda.empty_cache()
    return rows


def flash_cases():
    """(name, B, Hq, Hkv, S, T, causal, offsets), D = 128 throughout: the
    TPU kernel's own signature (T = S, offset 0), not causal, GQA at
    phi4-mini's 24/8 heads, the admission chunk at each of its offsets into
    the engine's 192-row cache and late in a 4,096-row one (T is the live
    prefix the engine hands in, offset + 32: from 256 live keys on the
    chunk is split over the keys), and the verify pass (8 rows of 1 + 4
    tokens at positions spread over the cache)."""
    t = -(-(PROMPT_LEN + MAX_NEW + 1 + DRAFT_LEN) // CHUNK) * CHUNK     # the engine's cache
    n = DRAFT_LEN + 1
    verify_off = [round(i * (t - n) / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    return ([("tpu_causal_128", 1, 32, 32, 128, 128, True, [0]),
             ("tpu_causal_2048", 1, 32, 32, 2048, 2048, True, [0]),
             ("tpu_full_128", 1, 32, 32, 128, 128, False, [0]),
             ("gqa_512", 1, 24, 8, 512, 512, True, [0])]
            + [(f"admit_off{o}", 1, 32, 32, CHUNK, o + CHUNK, True, [o])
               for o in (0, 32, 64, 96)]
            + [(f"admit4k_off{o}", 1, 32, 32, CHUNK, o + CHUNK, True, [o])
               for o in (224, 2016, LONG_LEN - CHUNK)]
            + [("verify", MAX_BATCH, 32, 32, n, t, True, verify_off)])


def flash_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    d = 128
    rows = []
    for name, b, hq, hkv, s, t, causal, offsets in flash_cases():
        gen = torch.Generator(device=dev)
        gen.manual_seed(s * 7 + t)
        # q as the model's (B, S, H, D) projection transposed, k/v as one
        # layer's view of a stacked (L, B, T, Hkv, D) cache: read in place
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        qv, k, v = q.transpose(1, 2), kc[1].transpose(1, 2), vc[1].transpose(1, 2)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        got = ops.flash_attention(qv, k, v, causal=causal, q_offset=off)
        want = fa.flash_attention_plain(qv, k, v, causal, None, off)
        contiguous = ops.flash_attention(qv.contiguous(), k.contiguous(), v.contiguous(),
                                         causal=causal, q_offset=off)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = FLASH_RTOL * want.float().abs() + FLASH_VTOL * float(vc[1].float().abs().max())
        pl = fa.plan(b, hq, hkv, s, t, sms=torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
        row = {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "T": t, "D": d,
               "causal": causal, "q_offset": offsets, "splits": pl["splits"],
               "heads_per_block": pl["heads_per_block"], "blocks": pl["blocks"],
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol).max()),
               "bit_equal_share": float((got == want).float().mean()),
               "strided_equals_contiguous": bool(torch.equal(got, contiguous))}
        if not bool((err <= tol).all()) or not row["strided_equals_contiguous"]:
            fail(f"flash_attention {name}: kernel vs plain out of tolerance: {row}")
        # keys each row may see (causal: up to its offset + index), and the
        # K/V rows any of a batch row's queries may see, read once
        vis = [[min(t, o + i + 1) if causal else t for i in range(s)] for o in offsets]
        kv_rows = sum(max(r) for r in vis)
        nbytes = 2 * q.numel() * 2 + 2 * kv_rows * hkv * d * 2
        flops = 4 * d * hq * sum(sum(r) for r in vis)
        nc = copies_beyond_l2(nbytes)
        sets = [(qv, k.clone(), v.clone(), off) for _ in range(nc)]
        kern = lambda a, kk, vv, o: ops.flash_attention(a, kk, vv, causal=causal, q_offset=o)
        plain = lambda a, kk, vv, o: fa.flash_attention_plain(a, kk, vv, causal, None, o)
        if not causal:
            lib = lambda a, kk, vv, o: F.scaled_dot_product_attention(a, kk, vv,
                                                                      enable_gqa=hq != hkv)
        elif s == t and not any(offsets):
            lib = lambda a, kk, vv, o: F.scaled_dot_product_attention(
                a, kk, vv, is_causal=True, enable_gqa=hq != hkv)
        else:
            mask = (torch.arange(t, device=dev)[None, None, :]
                    <= off[:, None, None] + torch.arange(s, device=dev)[None, :, None])[:, None]
            lib = lambda a, kk, vv, o: F.scaled_dot_product_attention(
                a, kk, vv, attn_mask=mask, enable_gqa=hq != hkv)
        big = s * t > 2 ** 20
        if pl["splits"] > 1:
            # the same call unsplit, beside the planned split
            one = lambda a, kk, vv, o: fa.flash_attention_cuda(a, kk, vv, causal, None, o,
                                                                splits=1)
            row["ms_one_split"] = graph_ms(torch, one, sets, 20 if big else 100)
        row.update({"ms": graph_ms(torch, kern, sets, 20 if big else 100),
                    "plain_ms": graph_ms(torch, plain, sets, 3 if big else 20),
                    "library_ms": graph_ms(torch, lib, sets, 20 if big else 100),
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
                    "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                                 else "operations")})
        rows.append(row)
        del sets, kc, vc
        torch.cuda.empty_cache()
    return rows


def norm_cases():
    """(name, leading shape, d, norm type): the served norms (RMSNorm at
    codeqwen's 4,096 and mamba2-370m's 1,024 and gated 2,048) at a decode
    step's 8 rows, a verify pass's (8, 5) and an admission chunk's (1, 32),
    and a LayerNorm at codeqwen's width."""
    v = (MAX_BATCH, 1 + DRAFT_LEN)
    return [("codeqwen_step", (MAX_BATCH, 1), 4096, "rmsnorm"),
            ("codeqwen_verify", v, 4096, "rmsnorm"),
            ("codeqwen_admit", (1, CHUNK), 4096, "rmsnorm"),
            ("mamba_step", (MAX_BATCH, 1), 1024, "rmsnorm"),
            ("mamba_gated_step", (MAX_BATCH, 1), 2048, "rmsnorm"),
            ("mamba_gated_verify", v, 2048, "rmsnorm"),
            ("layernorm_4096", (MAX_BATCH, 1), 4096, "layernorm")]


#: mamba2-370m's in_proj output width (z, x, B, C, dt): z is its first
#: 2,048 columns, read by the gated norm in place
MAMBA_IN_PROJ = 4384


def fused_norm_cases():
    """(name, form, leading shape, d): the residual add inside the norm
    (add-norm) at codeqwen's 4,096 (a decode step's 8 rows, a verify pass's
    (8, 5), an admission chunk's (1, 32)) and mamba2-370m's 1,024 (step and
    verify), and Mamba-2's gate inside its gated norm at 2,048 (step and
    verify, and an admission chunk, whose dual form hands over f32 y beside
    bf16 z). Rows are bf16 but where stated."""
    v = (MAX_BATCH, 1 + DRAFT_LEN)
    return [("codeqwen_step_add", "add", (MAX_BATCH, 1), 4096, "bfloat16"),
            ("codeqwen_verify_add", "add", v, 4096, "bfloat16"),
            ("codeqwen_admit_add", "add", (1, CHUNK), 4096, "bfloat16"),
            ("mamba_step_add", "add", (MAX_BATCH, 1), 1024, "bfloat16"),
            ("mamba_verify_add", "add", v, 1024, "bfloat16"),
            ("mamba_gated_step_fused", "gated", (MAX_BATCH, 1), 2048, "bfloat16"),
            ("mamba_gated_verify_fused", "gated", v, 2048, "bfloat16"),
            ("mamba_gated_admit_fused_f32_y", "gated", (1, CHUNK), 2048, "float32")]


def fused_norm_phase(torch, dev):
    """Each fused form against the route it replaced on the card (the eager
    add or gate, then the norm kernel): bit for bit, the normed rows and the
    written sum, in the whole call and token by token; within the norm's
    tolerance of its plain version (all eager). Timed beside that old route,
    the plain version and a library yardstick (torch.add or the eager gate,
    then F.rms_norm)."""
    import torch.nn.functional as F
    from repro_torch.kernels import norm as nrm
    from repro_torch.kernels import ops

    rows = []
    for name, form, lead, d, xdtype in fused_norm_cases():
        gen = torch.Generator(device=dev).manual_seed(d + len(lead) + 1)
        x = (3 * torch.randn(lead + (d,), generator=gen, device=dev) + 0.5) \
            .to(getattr(torch, xdtype))
        width = MAMBA_IN_PROJ if form == "gated" else d
        r = (3 * torch.randn(lead + (width,), generator=gen, device=dev)).to(torch.bfloat16)
        r = r[..., :d]                       # the gate's z: a column slice, read in place
        scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        w16 = scale.to(x.dtype)
        if form == "add":
            def kern(a, b):
                return ops.add_norm(a, b, scale)

            def old(a, b):
                s = a + b
                return ops.norm(s, scale), s

            def plain(a, b):
                return nrm.add_norm_plain(a, b, scale)

            def lib(a, b):
                return F.rms_norm(torch.add(a, b), (d,), w16, 1e-6)
        else:
            def kern(a, b):
                return (ops.gated_norm(a, b, scale),)

            def old(a, b):
                return (ops.norm((a * F.silu(b.to(torch.float32))).to(a.dtype), scale),)

            def plain(a, b):
                return (nrm.gated_norm_plain(a, b, scale),)

            def lib(a, b):
                return F.rms_norm((a * F.silu(b.to(torch.float32))).to(a.dtype), (d,), w16, 1e-6)
        got, want, ref = kern(x, r), old(x, r), plain(x, r)
        parts = [kern(x[:, j:j + 1], r[:, j:j + 1]) for j in range(x.shape[1])]
        per_token = [torch.cat([p[k] for p in parts], dim=1) for k in range(len(got))]
        torch.cuda.synchronize()
        err = (got[0].float() - ref[0].float()).abs()
        tol = NORM_RTOL * ref[0].float().abs() + NORM_MTOL * float(ref[0].float().abs().max())
        row = {"case": name, "form": form, "rows": list(lead), "d": d, "norm_type": "rmsnorm",
               "dtype": xdtype, "z_row_stride": width if form == "gated" else None,
               "equals_old_route": all(torch.equal(a, b) for a, b in zip(got, want)),
               "rows_equal_one_token_calls": all(torch.equal(a, b)
                                                 for a, b in zip(got, per_token)),
               "sum_equals_eager_add": bool(torch.equal(got[1], ref[1])) if form == "add"
               else None,
               "max_abs_err": float(err.max()), "max_err_over_tol": float((err / tol).max()),
               "bit_equal_share": float((got[0] == ref[0]).float().mean())}
        if not (row["equals_old_route"] and row["rows_equal_one_token_calls"]
                and bool((err <= tol).all()) and row["sum_equals_eager_add"] is not False):
            fail(f"norm {name}: the fused form does not give the old route's bits, its rows "
                 f"round otherwise in one-token calls, or it is out of tolerance: {row}")
        # read x and r (or y and z) and the scale, write the normed rows (and the sum)
        nbytes = (x.element_size() * (2 + (1 if form == "add" else 0)) + r.element_size()) \
            * x.numel() + d * 4
        row.update({"ms": graph_ms(torch, kern, [(x, r)], 200),
                    "old_route_ms": graph_ms(torch, old, [(x, r)], 200),
                    "host_us": host_us(torch, kern, (x, r)),
                    "old_route_host_us": host_us(torch, old, (x, r)),
                    "plain_ms": graph_ms(torch, plain, [(x, r)], 100),
                    "library_ms": graph_ms(torch, lib, [(x, r)], 200),
                    "library_note": ("torch.add" if form == "add" else
                                     "F.silu, multiply, cast") + " then F.rms_norm on weights "
                                                                  "in the rows' dtype, a "
                                                                  "yardstick only",
                    "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes"})
        rows.append(row)
    return rows


def norm_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import norm as nrm
    from repro_torch.kernels import ops

    rows = []
    for name, lead, d, kind in norm_cases():
        gen = torch.Generator(device=dev).manual_seed(d + len(lead))
        x = (3 * torch.randn(lead + (d,), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        bias = 0.1 * torch.randn((d,), generator=gen, device=dev) if kind == "layernorm" \
            else None
        got = ops.norm(x, scale, bias, norm_type=kind)
        want = nrm.norm_plain(x, scale, bias, kind)
        # each token's rows alone (a decode step's shape) give the same bits
        per_token = torch.cat([ops.norm(x[:, j:j + 1].contiguous(), scale, bias, norm_type=kind)
                               for j in range(x.shape[1])], dim=1)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = NORM_RTOL * want.float().abs() + NORM_MTOL * float(want.float().abs().max())
        row = {"case": name, "rows": list(lead), "d": d, "norm_type": kind,
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol).max()),
               "bit_equal_share": float((got == want).float().mean()),
               "rows_equal_one_token_calls": bool(torch.equal(got, per_token))}
        if not bool((err <= tol).all()) \
                or not row["rows_equal_one_token_calls"]:
            fail(f"norm {name}: kernel vs plain out of tolerance, or rows round otherwise "
                 f"than in one-token calls: {row}")
        w16, b16 = scale.to(x.dtype), None if bias is None else bias.to(x.dtype)
        if kind == "layernorm":
            lib = lambda a: F.layer_norm(a, (d,), w16, b16, 1e-6)
        elif hasattr(F, "rms_norm"):
            lib = lambda a: F.rms_norm(a, (d,), w16, 1e-6)
        else:
            lib = None
        kern = lambda a: ops.norm(a, scale, bias, norm_type=kind)
        plain = lambda a: nrm.norm_plain(a, scale, bias, kind)
        nbytes = 2 * x.numel() * 2 + d * 4 * (2 if bias is not None else 1)
        row.update({"ms": graph_ms(torch, kern, [(x,)], 200),
                    "plain_ms": graph_ms(torch, plain, [(x,)], 100),
                    "library_ms": graph_ms(torch, lib, [(x,)], 200) if lib else None,
                    "library_note": ("F.layer_norm" if kind == "layernorm" else "F.rms_norm")
                    + " on bf16 weights, a yardstick only",
                    "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes"})
        rows.append(row)
    return rows


def ssd_inputs(torch, dev, bt, s, h, p, g, n, seed):
    """SSD scan inputs as the Mamba-2 decode step hands them over: x, B and
    C bf16 strided views of one conv output row (bt, s, h*p + 2*g*n), dt f32
    after softplus, A = -exp(A_log) and D per head, an f32 state."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xbc = torch.randn((bt, s, h * p + 2 * g * n), generator=gen, device=dev)
    xbc = torch.nn.functional.silu(xbc).to(torch.bfloat16)
    x = xbc[..., :h * p].reshape(bt, s, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(bt, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(bt, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((bt, s, h), generator=gen, device=dev) - 2.0)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    D = torch.ones((h,), device=dev)
    state = torch.randn((bt, h, p, n), generator=gen, device=dev)
    return x, dt, A, B, C, D, state


def ssd_phase(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    # the decode step of mamba2-370m at 8 slots (x bf16, state carried), one
    # multi-step shape with an initial state, one grouped shape
    h, p, n = 32, 64, 128
    cases = [("decode", MAX_BATCH, 1, h, p, 1, n), ("multi_step", 2, 64, h, p, 1, n),
             ("grouped", MAX_BATCH, 1, h, p, 4, n)]
    checks = {}
    for name, bt, s, hh, pp, g, nn in cases:
        x, dt, A, B, C, D, state = ssd_inputs(torch, dev, bt, s, hh, pp, g, nn, seed=7)
        want_y, want_s = ssd.ssd_scan_plain(x, dt, A, B, C, D, state, True)
        inplace = state.clone()
        got_y, got_s = ops.ssd_decode(x, dt, A, B, C, D, inplace, out_state=inplace) \
            if s == 1 else ssd.ssd_scan_cuda(x, dt, A, B, C, D, inplace, True, inplace)
        torch.cuda.synchronize()
        y_err = (got_y.float() - want_y.float()).abs()
        s_err = (got_s - want_s).abs()
        y_ok = bool((y_err <= SSD_Y_RTOL * want_y.float().abs() + SSD_Y_ATOL).all())
        s_ok = bool((s_err <= SSD_STATE_TOL * want_s.abs() + SSD_STATE_TOL).all())
        checks[name] = {"Bt": bt, "S": s, "H": hh, "P": pp, "G": g, "N": nn,
                        "y_max_abs_err": float(y_err.max()),
                        "y_max_bf16_steps": float((y_err / (2.0 ** -7 * want_y.float().abs()
                                                            + SSD_Y_ATOL)).max()),
                        "state_max_abs_err": float(s_err.max()),
                        "state_bit_equal_share": float((got_s == want_s).float().mean())}
        if not (y_ok and s_ok):
            fail(f"ssd_scan {name}: kernel vs plain out of tolerance: {checks[name]}")

    # timing at the decode shape, the state written in place as served; each
    # argument set has its own state so the states come cold from device memory
    x, dt, A, B, C, D, state = ssd_inputs(torch, dev, MAX_BATCH, 1, h, p, 1, n, seed=8)
    sbytes = state.numel() * 4
    sets = [(x, dt, A, B, C, D, state.clone()) for _ in range(copies_beyond_l2(2 * sbytes))]
    kern = lambda *a: ops.ssd_decode(*a, out_state=a[-1])
    plain = lambda *a: ssd.ssd_scan_plain(*a, return_final_state=True, final_state_out=a[-1])
    row = {**checks["decode"], "checks": checks, "launches_per_decode_step": 48,
           "ms": graph_ms(torch, kern, sets, 100),
           "plain_ms": graph_ms(torch, plain, sets, 20),
           "library_ms": None,
           "library_note": "no single PyTorch call computes this recurrence"}
    io = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C, D))
    nbytes = 2 * sbytes + io + x.numel() * 2                  # state in + out, inputs, y
    flops = 5 * state.numel()      # decay mul, input mul, add, readout multiply-add
    row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S \
        else "operations"
    row["bound_bytes"] = nbytes
    del sets
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def plain_versions_on_card():
    """Send the wrappers' CUDA tensors to the kernels' plain versions (the
    parity phase's reference run); the launch counts are put back after."""
    from repro_torch.kernels import cascade_matmul as cm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import norm as nrm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    routes = [(cm, "cascade_matmul_cuda", cm.cascade_matmul_plain),
              (da, "decode_attention_cuda", da.decode_attention_plain),
              (fa, "flash_attention_cuda", fa.flash_attention_plain),
              (nrm, "norm_cuda", nrm.norm_plain),
              (nrm, "add_norm_cuda", nrm.add_norm_plain),
              (nrm, "gated_norm_cuda", nrm.gated_norm_plain),
              (ssd, "ssd_scan_cuda", ssd.ssd_scan_plain)]
    saved = [getattr(mod, name) for mod, name, _ in routes], dict(ops.LAUNCHES)
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved[0]):
            setattr(mod, name, fn)
        ops.LAUNCHES.update(saved[1])


def bf16_step(x: float) -> float:
    """The bf16 step (unit in the last place) at magnitude |x| > 0."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def parity_phase(torch, dev, arch: str):
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config(arch), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(3, ccfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (MAX_BATCH, CHUNK), device=dev, generator=gen)
    chunk = torch.randint(0, cfg.vocab, (MAX_BATCH, 1 + DRAFT_LEN), device=dev, generator=gen)
    from repro_torch.kernels import ops
    out = {}
    nxt = None
    with torch.no_grad():
        for name, route in (("plain", plain_versions_on_card), ("kernel", contextlib.nullcontext)):
            ops.reset_launch_counts()
            with route():
                cache = model.init_cache(MAX_BATCH, 2 * CHUNK, dtype=torch.bfloat16, device=dev)
                l1, cache = model.prefill_extend(params, {"tokens": toks}, cache, ccfg,
                                                 n_valid=CHUNK - 5)
                if nxt is None:   # both runs decode the reference run's next token
                    nxt = torch.argmax(l1[:, -1], dim=-1)[:, None].to(torch.int32)
                l2, cache = model.decode_step(params, {"tokens": nxt}, cache, ccfg)
                # a speculative verify chunk: the pending token and 4 drafts per row
                l3, cache, _ = model.spec_verify(params, {"tokens": chunk}, cache, ccfg)
            out[name] = (l1, l2, l3)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)            # the kernel run's: prefill, decode, verify
    if cfg.family == "dense" and launches["decode_attention"] != cfg.n_layers:
        fail(f"depth-2 parity ({arch}): the decode step launched decode attention "
             f"{launches['decode_attention']} times, not once per layer: {launches}")
    if not all(torch.isfinite(o).all() for o in out["kernel"]):
        fail(f"depth-2 parity ({arch}): kernel logits not finite")
    rel_limit, step_limit = PARITY_LIMITS[arch]
    res = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "kernel_launches": launches,
           "logit_absmax": float(out["plain"][1].abs().max()),
           "tol": {"rel_l2": rel_limit, "max_bf16_steps": step_limit}}
    rels, steps = [], []
    for stage, a, b in zip(("prefill", "decode", "verify"), out["kernel"], out["plain"]):
        rels.append(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)))
        steps.append(float((a - b).abs().max()) / bf16_step(float(b.abs().max())))
        res.update({f"{stage}_max_abs_err": float((a - b).abs().max()),
                    f"{stage}_rel_l2": rels[-1], f"{stage}_max_bf16_steps": steps[-1],
                    f"{stage}_moved_share": float((a != b).float().mean()),
                    f"{stage}_argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                                   .float().mean())})
    if not (max(rels) <= rel_limit and max(steps) <= step_limit):
        fail(f"depth-2 parity ({arch}): kernels vs plain versions out of tolerance: {res}")
    return res


def profile_step(torch, eng) -> dict:
    """One engine step under torch.profiler: the device's busy time (sum of
    kernel durations) and the kernels that take most of it. The profiler
    slows the host, so this step's wall time is not a step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        produced = eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ours = {}                  # the port's kernels, every instantiation (and merge) summed
    for name, (n, us) in by_name.items():
        for k in ("cascade_matmul", "decode_attention", "flash_attention", "norm", "ssd_scan"):
            if re.search(rf"(?<![A-Za-z0-9_]){k}_(kernel|merge)\b", name):
                c, t = ours.get(k, (0, 0.0))
                ours[k] = (c + n, t + us)
    # eager elementwise kernels by ATen functor: the bf16 adds (the residual
    # adds before the fused add-norm) and silu (Mamba-2's gate, beside the
    # conv's own silu), to show which the fused norm forms took
    eager = {}
    for name, (n, _) in by_name.items():
        for key, pat in (("add_bf16", r"CUDAFunctor_add<c10::BFloat16>"), ("silu", r"silu")):
            if re.search(pat, name):
                eager[key] = eager.get(key, 0) + n
    return {"tokens": produced, "wall_ms_under_profiler": wall_ms,
            "device_busy_ms": busy_ms if by_name else "not measured",
            "device_kernels": sum(n for n, _ in by_name.values()),
            "our_kernels": {k: {"count": n, "ms": us / 1e3} for k, (n, us) in ours.items()},
            "eager_elementwise": eager,
            "top_kernels": [{"name": k[:90], "count": n, "ms": us / 1e3} for k, (n, us) in top]}


@contextlib.contextmanager
def instrumented(torch, eng, margins: bool):
    """Wrap the engine's model calls for one run: every logit the engine
    picks from is checked finite (on the device, read once at the end), the
    launches of each decode step and verify pass are recorded, and with
    ``margins`` the top-2 logits and max|logit| of the row behind every
    committed token are kept, by (request, token index): the margins where a
    speculative stream departs from the plain one, and how far the two
    runs' margins move before that."""
    from repro_torch.kernels import ops

    model = eng.model
    rec = {"finite": [], "decode": [], "verify": [], "top2": {}}
    last = {}

    def wrap(name, per_step):
        fn = getattr(model, name)

        def call(*a, **kw):
            before = dict(ops.LAUNCHES)
            out = fn(*a, **kw)
            rec["finite"].append(torch.isfinite(out[0]).all())
            if per_step is not None:
                per_step.append({k: ops.LAUNCHES[k] - before[k] for k in before})
            if margins:
                # (B, rows, 3): top-1, top-2, max|logit| of every logits row
                last["top2"] = torch.cat([torch.topk(out[0], 2, dim=-1).values,
                                          out[0].abs().amax(dim=-1, keepdim=True)], dim=-1)
                last["used"] = {}
            return out
        setattr(model, name, call)

    wrap("prefill_extend", None)
    wrap("decode_step", rec["decode"])
    if eng.spec:
        wrap("spec_verify", rec["verify"])
    if margins:
        commit = eng._commit_token

        def record(req, tok):
            # admission commits before the request takes its slot (row 0 of
            # its prefill logits); a decode commit reads its slot's row, a
            # verify pass's commits its slot's rows in order
            slot = next((i for i, r in enumerate(eng.slots) if r is req), 0)
            top = last["top2"][slot]
            j = last["used"].get(slot, 0) if top.shape[0] > 1 else -1
            last["used"][slot] = j + 1
            rec["top2"][(req.uid, len(req.tokens_out))] = top[j]
            commit(req, tok)
        eng._commit_token = record
    try:
        yield rec
    finally:
        for name in ("prefill_extend", "decode_step", "spec_verify"):
            model.__dict__.pop(name, None)
        eng.__dict__.pop("_commit_token", None)


def serve_run(torch, dev, arch, model, params, ccfg, prompts, kind, margins=False,
              max_new=MAX_NEW, **opts):
    """One serve run: the prompts (16 unless stated) through a fresh fused
    engine. The launch counts are reset just before the run and read just
    after; every request must finish with ``max_new`` tokens, every logit
    must be finite and every kernel of the run (``RUN_KERNELS``) must have
    launched."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    scfg = ServeConfig(**{"max_batch": MAX_BATCH, "max_len": PROMPT_LEN + MAX_NEW + 1,
                          "prefill_chunk": CHUNK, "fused": True, **opts})
    eng = ServeEngine(model, params, ccfg, scfg, device=dev)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    with instrumented(torch, eng, margins) as rec:
        gc.collect()               # no earlier run's engine may count in the peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(ops.LAUNCHES)
    m = eng.metrics()
    if not all(r.done and len(r.tokens_out) == max_new for r in reqs):
        fail(f"serve ({arch}, {kind}): not every request finished with {max_new} tokens: "
             f"{[len(r.tokens_out) for r in reqs]}")
    if not bool(torch.stack(rec["finite"]).all()):
        fail(f"serve ({arch}, {kind}): non-finite logits")
    decode = "spec" if eng.spec else "plain"
    if not all(launches[k] > 0 for k in RUN_KERNELS[(arch, decode)]):
        fail(f"serve ({arch}, {kind}): a kernel of the run never launched: {launches}")
    if not all(0 <= t < model.cfg.vocab for r in reqs for t in r.tokens_out):
        fail(f"serve ({arch}, {kind}): a token outside the vocabulary")
    ttft = [r.first_token_at - r.created_at for r in reqs]
    steps = rec["verify"] if eng.spec else rec["decode"]
    out = {"arch": arch, "run": kind, "effective_mode": m["effective_mode"], "wall_s": wall,
           "tokens_out": sum(len(r.tokens_out) for r in reqs),
           "decode_tokens": m["decode_tokens"], "decode_steps": m["steps"],
           "decode_tokens_per_s": m["tokens_per_s"],
           "end_to_end_tokens_per_s": sum(len(r.tokens_out) for r in reqs) / wall,
           "step_ms_p50": m["step_time_p50_s"] * 1e3, "step_ms_p99": m["step_time_p99_s"] * 1e3,
           "ttft_s_p50": float(np.percentile(ttft, 50)), "ttft_s_max": float(max(ttft)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_decode_step": steps[-1] if steps else {},
           "first_tokens": reqs[0].tokens_out[:8]}
    if eng.spec:
        out.update({"draft_len": m["draft_len"], "accepted_per_step": m["accepted_per_step"],
                    "draft_tokens_accepted": m["draft_tokens_accepted"]})
        per_verify = {k: sorted({st[k] for st in steps}) for k in steps[0]}
        out["launches_per_verify_step_seen"] = per_verify
        want = {"flash_attention": model.cfg.n_layers if arch == "codeqwen1.5-7b" else 0,
                "ssd_scan": (model.cfg.n_layers * (1 + DRAFT_LEN)
                             if arch == "mamba2-370m" else 0),
                "decode_attention": 0, "norm": 2 * model.cfg.n_layers + 1}
        if any(per_verify[k] != [n] for k, n in want.items()):
            fail(f"serve ({arch}, {kind}): launches per verify pass {per_verify}, "
                 f"expected {want}")
    return out, eng, reqs, rec


def repetitive_prompts(vocab: int):
    """A 4-token pattern tiled to the prompt length, one pattern per
    request: text a prompt-lookup drafter can predict."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [np.tile(rng.integers(0, vocab, 4).astype(np.int32), PROMPT_LEN // 4)
            for _ in range(N_REQ)]


def serve_phase(torch, dev, arch: str):
    import numpy as np
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request

    cfg, model = registry.load(arch)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    t0 = time.monotonic()
    params = model.init_params(0, ccfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0

    # plain greedy decode on random prompts
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32) for _ in range(N_REQ)]
    plain, eng, reqs, _ = serve_run(torch, dev, arch, model, params, ccfg, prompts, "plain")
    # after the measured run: 8 more requests fill every slot (the first step
    # admits them all), and the next step, a pure 8-slot decode, is profiled
    for i in range(MAX_BATCH):
        eng.submit(Request(uid=N_REQ + i, prompt=reqs[i].prompt, max_new_tokens=4))
    eng.step()
    profiled = profile_step(torch, eng)
    eng.run_until_drained()
    tied_head_ms = None
    if cfg.tie_embeddings:
        # the tied head is a plain matmul over the f32-upcast embedding table,
        # outside any kernel of the port (as in the reference): its own time
        from repro_torch.models import layers as L
        xh = torch.randn((MAX_BATCH, 1, cfg.d_model), device=dev).to(torch.bfloat16)
        tied_head_ms = graph_ms(torch, lambda a: L.tied_head(params["embed"], a, torch.bfloat16),
                                [(xh,)], 20)
    plain.update({"layers": cfg.n_layers, "requests": N_REQ, "prompt_len": PROMPT_LEN,
                  "max_new": MAX_NEW, "max_batch": MAX_BATCH, "prefill_chunk": CHUNK,
                  "init_s": init_s, "profiled_decode_step": profiled,
                  "tied_head_ms": tied_head_ms})

    # repetitive prompts: plain greedy, then speculative greedy decode; the
    # streams are compared token by token
    rep = repetitive_prompts(cfg.vocab)
    rep_plain, _, plain_reqs, prec = serve_run(torch, dev, arch, model, params, ccfg, rep,
                                               "plain_repetitive", margins=True)
    spec, spec_eng, spec_reqs, srec = serve_run(torch, dev, arch, model, params, ccfg, rep,
                                                "spec", margins=True, draft_len=DRAFT_LEN)
    # as after the plain run: fill the slots, then profile one 8-slot verify step
    for i in range(MAX_BATCH):
        spec_eng.submit(Request(uid=N_REQ + i, prompt=rep[i], max_new_tokens=8))
    spec_eng.step()
    spec["profiled_verify_step"] = profile_step(torch, spec_eng)
    spec_eng.run_until_drained()
    del spec_eng
    # margins in bf16 steps of the row's max|logit| (the unit of the depth-2
    # parity limit); a margin is the difference of two logits, each within
    # the path's step limit, so a departure where the plain margin is at most
    # twice that limit is rounding, and one above it fails the run
    step_limit = PARITY_LIMITS[arch][1]
    margin_limit = 2 * step_limit

    def margin(top):
        top1, top2, absmax = (float(x) for x in top)
        return top1 - top2, (top1 - top2) / bf16_step(absmax)

    diverged, moved = [], []
    for pr, sr in zip(plain_reqs, spec_reqs):
        j = next((i for i, (a, b) in enumerate(zip(pr.tokens_out, sr.tokens_out)) if a != b),
                 None)
        # before the streams part, how far the spec run's margins sit from the plain run's
        for i in range(MAX_NEW if j is None else j):
            moved.append(abs(margin(prec["top2"][(pr.uid, i)])[1]
                             - margin(srec["top2"][(sr.uid, i)])[1]))
        if j is None:
            continue
        m, steps = margin(prec["top2"][(pr.uid, j)])
        d = {"uid": pr.uid, "index": j, "plain": pr.tokens_out[j], "spec": sr.tokens_out[j],
             "plain_margin": m, "margin_bf16_steps": steps}
        diverged.append(d)
        if steps > margin_limit:
            fail(f"serve ({arch}): the speculative stream departs from plain greedy decode "
                 f"where the plain margin is {steps:.2f} bf16 steps (limit {margin_limit}): {d}")
    spec.update({"streams_equal_plain": len(diverged) == 0, "divergences": diverged,
                 "margin_limit_bf16_steps": margin_limit,
                 "margin_moved_bf16_steps": {"max": max(moved), "p50": float(np.median(moved)),
                                             "p99": float(np.percentile(moved, 99)),
                                             "tokens": len(moved)},
                 "plain_repetitive": rep_plain})
    out = {"plain": plain, "spec": spec}

    if arch == "codeqwen1.5-7b":
        # speculative sampling, twice with one seed
        opts = dict(draft_len=DRAFT_LEN, temperature=0.8, top_k=50, sample_seed=0)
        runs = [serve_run(torch, dev, arch, model, params, ccfg, rep, "spec_sampled", **opts)
                for _ in range(2)]
        streams = [[r.tokens_out for r in reqs] for _, _, reqs, _ in runs]
        if streams[0] != streams[1]:
            fail(f"serve ({arch}): two sampled runs with one seed gave different streams")
        out["sampled"] = {**runs[0][0], "same_streams_with_same_seed": True,
                          "temperature": 0.8, "top_k": 50}
        out["long_context"] = long_context_run(torch, dev, arch, model, params, ccfg)
    return out


@contextlib.contextmanager
def recorded_flash_plans():
    """Record (T, splits) of every flash-attention launch plan made inside."""
    from repro_torch.kernels import flash_attention as fa
    seen, plan = [], fa.plan

    def record(*a, **kw):
        pl = plan(*a, **kw)
        seen.append((a[4], pl["splits"]))
        return pl
    fa.plan = record
    try:
        yield seen
    finally:
        fa.plan = plan


def long_context_run(torch, dev, arch, model, params, ccfg):
    """Plain greedy serving at a 4,096-token context: LONG_REQ prompts of
    LONG_LEN - 32 tokens, admitted in chunks of 32, each chunk's flash
    attention over its live cache prefix. Early chunks must keep one split
    and late ones split over the keys: the split route runs on a served
    path."""
    import numpy as np
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab, LONG_LEN - CHUNK).astype(np.int32)
               for _ in range(LONG_REQ)]
    with recorded_flash_plans() as plans:
        run, eng, _, _ = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                   "long_context", max_new=LONG_NEW, max_batch=LONG_BATCH,
                                   max_len=LONG_LEN)
    del eng
    split_keys = [t for t, n in plans if n > 1]
    by_splits = {}
    for _, n in plans:
        by_splits[n] = by_splits.get(n, 0) + 1
    run.update({"requests": LONG_REQ, "prompt_len": LONG_LEN - CHUNK, "max_len": LONG_LEN,
                "max_batch": LONG_BATCH, "flash_launches_by_splits": by_splits,
                "fewest_keys_split": min(split_keys) if split_keys else None,
                "most_keys_one_split": max((t for t, n in plans if n == 1), default=None)})
    if not split_keys or run["most_keys_one_split"] >= min(split_keys):
        fail(f"serve ({arch}, long_context): flash attention should split the late chunks "
             f"only: {run}")
    return run


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA GPU")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not importable ({e}); run chip_smoke.py from a checkout")
    dev = torch.device("cuda")
    print(gpu_name_and_power(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    libs = build.build()
    regs = {n: [ln.strip() for ln in p.with_suffix(".log").read_text().splitlines()
                if "registers" in ln] for n, p in libs.items()}
    print(json.dumps({"build_s": time.monotonic() - t0, "ptxas": regs}), flush=True)

    phase_s = {"build": time.monotonic() - t0}

    def timed(name, fn, *args):
        t = time.monotonic()
        out = fn(torch, dev, *args)
        phase_s[name] = time.monotonic() - t
        gc.collect()
        torch.cuda.empty_cache()
        return out

    mm = timed("cascade_matmul", matmul_phase)
    from repro_torch.kernels import cascade_matmul as cm
    mm_geometry = cm.geometry()
    print(json.dumps({"cascade_matmul_shapes": mm, "geometry": mm_geometry}), flush=True)
    mm_rows = timed("cascade_matmul rows", matmul_rows_phase)
    print(json.dumps({"cascade_matmul_rows_across_m": mm_rows}), flush=True)
    atts = timed("decode_attention", attention_phase)
    att = atts[0]
    from repro_torch.kernels import decode_attention as da
    att_geometry = da.geometry()
    print(json.dumps({"decode_attention": atts, "geometry": att_geometry}), flush=True)
    fla = timed("flash_attention", flash_phase)
    from repro_torch.kernels import flash_attention as fa
    fla_geometry = fa.geometry()
    print(json.dumps({"flash_attention": fla, "geometry": fla_geometry}), flush=True)
    nrm = timed("norm", norm_phase)
    nrm_fused = timed("norm fused", fused_norm_phase)
    print(json.dumps({"norm": nrm, "norm_fused": nrm_fused}), flush=True)
    ssd = timed("ssd_scan", ssd_phase)
    print(json.dumps({"ssd_scan": ssd}), flush=True)
    par, srv = {}, {}
    for arch in PARITY_ARCHS:
        par[arch] = timed(f"parity {arch}", parity_phase, arch)
        print(json.dumps({"parity_depth2": par[arch]}), flush=True)
    for arch in ARCHS:
        srv[arch] = timed(f"serve {arch}", serve_phase, arch)
        for run in srv[arch].values():
            print(json.dumps({"serve": run}), flush=True)
    print(json.dumps({"phase_s": phase_s}), flush=True)

    def per_step(arch, key, per="launches_per_decode_step"):
        return sum(r[key] * r[per] for r in mm if r["arch"] == arch)

    def verify_step(arch):
        return {key: per_step(arch, key, "launches_per_verify_step")
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")}

    def launches(name):
        return {arch: srv[arch]["plain"]["launches"][name] for arch in ARCHS}

    def by_run(name):
        """Launches in every serve run, each counted from zero."""
        return {f"{arch}/{kind}": rec["launches"][name] for arch in ARCHS
                for kind, rec in srv[arch].items()}

    cq, mb = ARCHS
    fv = next(r for r in fla if r["case"] == "verify")
    nq = next(r for r in nrm_fused if r["case"] == "codeqwen_step_add")
    kernels = [
        {"name": "cascade_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cascade_matmul.cu",
         "replaces": "src/repro/kernels/cascade_matmul.py:98",
         "shape": "one codeqwen decode step at M=8: 32 x [(4096,4096)x4, (4096,13440)x2, "
                  "(13440,4096)] + lm_head (4096,92416); times are summed over its launches "
                  "(mamba2-370m's step: 48 x [(1024,4384), (2048,1024)], under mamba2_370m_step)",
         "launches": sum(launches("cascade_matmul").values()),
         "launches_by_path": launches("cascade_matmul"),
         "launches_by_run": by_run("cascade_matmul"),
         "launches_per_decode_step": {
             a: srv[a]["plain"]["launches_per_decode_step"]["cascade_matmul"] for a in ARCHS},
         "max_abs_err": max(r["max_abs_err"] for r in mm),
         "max_err": max(r["max_abs_err"] for r in mm),
         "tol": f"{MATMUL_RTOL} * max|plain| + {MATMUL_ATOL}",
         "max_abs_err_bf16_out": max(r["max_abs_err_bf16_out"] for r in mm),
         "tol_bf16_out": f"2^-7 * max|plain| + {MATMUL_ATOL}",
         "ms": per_step(cq, "ms"), "kernel_ms": per_step(cq, "ms"),
         "plain_ms": per_step(cq, "plain_ms"),
         "bound_ms": per_step(cq, "bound_ms"), "bound_by": "bytes",
         "library_ms": per_step(cq, "library_ms"),
         "mamba2_370m_step": {key: per_step(mb, key)
                              for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "verify_step_m40": {a: verify_step(a) for a in ARCHS},
         "geometry": mm_geometry,
         "rows_equal_across_m": all(r["rows_equal"] for r in mm_rows),
         "cascade_matmul_shapes": {f"{r['arch']} {r['M']}x{r['K']}->{r['N']}": {k: r[k] for k in (
             "m_tiles", "grid", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err")} for r in mm}},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:178",
         "shape": f"B={att['B']} Hq={att['Hq']} Hkv={att['Hkv']} T={att['T']} D={att['D']}, "
                  f"q_pos {att['q_pos']} ({att['live_keys']} live keys; every shape under "
                  "decode_attention_shapes)",
         "launches": srv[cq]["plain"]["launches"]["decode_attention"],
         "launches_by_run": by_run("decode_attention"),
         "launches_per_decode_step":
             srv[cq]["plain"]["launches_per_decode_step"]["decode_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in atts),
         "max_err": max(max(r["max_abs_err"], r["max_abs_err_mask_route"]) for r in atts),
         "tol": ATTN_ATOL,
         "ms": att["ms"], "kernel_ms": att["ms"], "plain_ms": att["plain_ms"],
         "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
         "library_ms": att["library_ms"],
         "library_note": "scaled_dot_product_attention with the equivalent boolean mask",
         "geometry": att_geometry, "splits": att["splits"],
         "decode_attention_shapes": {r["case"]: {k: r[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits", "max_abs_err")}
             for r in atts}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:72",
         "shape": f"the codeqwen verify pass: B={fv['B']} Hq={fv['Hq']} Hkv={fv['Hkv']} "
                  f"S={fv['S']} T={fv['T']} D={fv['D']}, per-row offsets {fv['q_offset']} "
                  "(every shape under flash_attention_shapes)",
         "launches": srv[cq]["spec"]["launches"]["flash_attention"],
         "launches_by_run": by_run("flash_attention"),
         "launches_per_verify_step": srv[cq]["spec"]["launches_per_decode_step"]
         ["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in fla),
         "max_err_over_tol": max(r["max_err_over_tol"] for r in fla),
         "tol": "2^-7 * |plain| + 2^-12 * max|v| (bf16 out)",
         "ms": fv["ms"], "kernel_ms": fv["ms"], "plain_ms": fv["plain_ms"],
         "bound_ms": fv["bound_ms"], "bound_by": fv["bound_by"],
         "library_ms": fv["library_ms"],
         "library_note": "scaled_dot_product_attention with a boolean mask (is_causal at "
                         "offset 0)",
         "geometry": fla_geometry,
         "flash_attention_shapes": {r["case"]: {k: r[k] for k in (
             "ms", "ms_one_split", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
             "heads_per_block") if k in r} for r in fla},
         "long_context_launches_by_splits": srv[cq]["long_context"]["flash_launches_by_splits"]},
        {"name": "norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/norm.cu",
         "replaces": "no TPU kernel: the reference's plain norm_apply, "
                     "src/repro/models/layers.py:32, with the residual add before it "
                     "(src/repro/models/transformer.py:117-118, ssm.py:299) and Mamba-2's "
                     "gate (src/repro/models/ssm.py:287)",
         "shape": f"codeqwen decode step's add-norm: {nq['rows']} x {nq['d']} bf16 RMSNorm of "
                  "x + r (every shape under norm_shapes; the plain form at the same shape "
                  "under norm_shapes.codeqwen_step)",
         "launches": sum(launches("norm").values()),
         "launches_by_path": launches("norm"),
         "launches_by_run": by_run("norm"),
         "launches_per_decode_step": {
             a: srv[a]["plain"]["launches_per_decode_step"]["norm"] for a in ARCHS},
         "max_abs_err": max(r["max_abs_err"] for r in nrm + nrm_fused),
         "max_err_over_tol": max(r["max_err_over_tol"] for r in nrm + nrm_fused),
         "tol": "2^-7 * |plain| + 2^-20 * max|plain| (bf16 out); the fused forms also equal "
                "the eager add or gate then the norm kernel bit for bit",
         "rows_equal_one_token_calls": all(r["rows_equal_one_token_calls"]
                                           for r in nrm + nrm_fused),
         "fused_equal_old_route": all(r["equals_old_route"] for r in nrm_fused),
         "ms": nq["ms"], "kernel_ms": nq["ms"], "plain_ms": nq["plain_ms"],
         "old_route_ms": nq["old_route_ms"],
         "bound_ms": nq["bound_ms"], "bound_by": nq["bound_by"],
         "library_ms": nq["library_ms"], "library_note": nq["library_note"],
         "norm_shapes": {r["case"]: {k: r[k] for k in (
             "ms", "old_route_ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
             if k in r} for r in nrm + nrm_fused}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:92",
         "shape": f"decode: B={ssd['Bt']} H={ssd['H']} P={ssd['P']} N={ssd['N']} G={ssd['G']} "
                  "S=1, bf16 x, f32 state carried in place",
         "launches": srv[mb]["plain"]["launches"]["ssd_scan"],
         "launches_by_run": by_run("ssd_scan"),
         "launches_per_decode_step": srv[mb]["plain"]["launches_per_decode_step"]["ssd_scan"],
         "max_abs_err": max(c["y_max_abs_err"] for c in ssd["checks"].values()),
         "state_max_abs_err": max(c["state_max_abs_err"] for c in ssd["checks"].values()),
         "tol": f"y: 2^-7 * |plain| + {SSD_Y_ATOL}; state: {SSD_STATE_TOL} * |plain| + "
                f"{SSD_STATE_TOL}",
         "ms": ssd["ms"], "kernel_ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
         "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "library_ms": None, "library_note": ssd["library_note"]},
    ]
    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    record = {"gpu": gpu_name_and_power(), "kernels": kernels, "cascade_matmul_shapes": mm,
              "cascade_matmul_rows_across_m": mm_rows,
              "decode_attention": atts, "flash_attention": fla, "norm": nrm,
              "norm_fused": nrm_fused, "ssd_scan": ssd,
              "parity_depth2": par, "serve": srv,
              "phase_s": phase_s}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
