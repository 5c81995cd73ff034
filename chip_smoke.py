#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

from the root of a checkout. It builds the CUDA kernels from ``src/repro_torch/
kernels/csrc`` with nvcc (sm_90a), all at once, and runs the phases below on
the four served paths, the dense transformer (codeqwen1.5-7b), Mamba-2
(mamba2-370m), the MoE family (olmoe-1b-7b) and Griffin (recurrentgemma-2b);
any failure exits non-zero before the final ``ok`` line is printed.

Griffin and CREST (the paper's fault tolerance) add: flash attention at
head dim 256 with the local-window mask (``k_pos``, ``window``) at Griffin's
admission and verify shapes over its 2,048-row ring and on a windowed
2,048-token prompt (window 2,048 and 512), and decode attention on the ring
(10 heads over one KV head), each held, timed and bounded as below; Griffin's
FP4 matmul shapes in the matmul phase; recurrentgemma-2b's parity at depth 3
(one (R, R, A) group); its serve runs (plain, speculative, and 4 prompts of
2,040 tokens whose streams cross the window, held to an unfused run on the
same weights); on codeqwen a healthy serve run with CREST probe waves every
4 steps (streams equal the CREST-off run's, no fault confirmed, the probe's
device time), and CREST on its dense lm_head through ``crest_matmul`` (3
injected columns over 3 cursor cycles: all detected and repaired, none
falsely, the repaired output within ``tol`` of the clean product).

The modality-stub backbones, the slot-wise loop and the fleet add: flash
attention at head dim 64 (musicgen-large's prefill and an admission chunk)
and at qwen2-vl-2b's GQA 12/2 prefill, decode attention at head dim 64 and
at 12/2 heads, the LayerNorm (with bias) and add-LayerNorm at 2,048 and the
RMSNorm at 1,536, and the FP4 matmul at both configs' weight shapes (a
decode step's 8 rows and the prefill's 1,024), each held, timed and bounded
as below; both configs' depth-2 parity at full width (a prefill of stub
embeddings, qwen2-vl with the M-RoPE positions of an 8 x 8 image then text,
and a decode step, musicgen with ``pos_offset``); both at full width and
depth at the model level (the engine takes token prompts, so 8 rows go
through ``prefill`` and 32 ``decode_step``s fed seeded stub embeddings);
the slot-wise loop (codeqwen1.5-7b at depth 2, ``batched=False``, through
the kernels, its downgrades recorded and its streams held to an unfused
run's); and the ``--traffic`` path: two full-width codeqwen
replicas under the SLO-aware router on a seeded Poisson trace of 24
requests at 4 req/s, replica 0 failed 2 s in, every stream finished and
each rebuilt one held to the same request served alone.

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
   Then codeqwen's paged runs (pages of 16 rows; none may downgrade), each
   stream held to a dense run's token for token: (a) ``paged`` on the plain
   run's random prompts, one 8-slot paged decode step profiled beside the
   dense one; (b) ``prefix_cache`` on 16 prompts sharing a 96-token prefix,
   beside the dense engine on them (hit rate >= 0.5; TTFT, admission chunks
   and prompt tokens spent on both); (c) ``prefix_cache`` on the random
   prompts, whose default pool must evict; (d) ``paged`` speculative
   greedy on the repetitive prompts, against the dense speculative run.
   The paged pool's gather and scatter (PyTorch ops, not kernels of the
   port) are also timed per call at the served step's shapes.

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
#     the tied head in f32, and 25% of them moved). The MoE models add a
#     discontinuity: a token whose router inputs differ in a last bit may
#     swap its k-th expert for the (k+1)-th (random routers are near
#     uniform: top-8 of 64 at ~1/64 each), moving that token's logits by
#     more. olmoe-1b-7b: relative L2 0.0053 / 0.0056 / 0.0095 and at most
#     1.06 / 1.5 / 4.69 steps (prefill / decode / verify; 52 token-layer
#     routings flipped); deepseek-v2-236b: 0.0070 / 0.0073 / 0.0155 and 1.07
#     / 1.25 / 12.6 steps (15 flipped)
MATMUL_RTOL, MATMUL_ATOL = 1e-4, 1e-4
MATMUL_BF16_RTOL = 2.0 ** -7
ATTN_ATOL = 1e-4
FLASH_RTOL, FLASH_VTOL = 2.0 ** -7, 2.0 ** -12
SSD_STATE_TOL = 1e-5
SSD_Y_RTOL, SSD_Y_ATOL = 2.0 ** -7, 1e-5
#: arch -> (rel_l2, max_steps)
#     qwen2.5-32b (GQA 40/8, decode attention at G = 5) takes codeqwen's
#     limits: a dense transformer of the same kind
#     recurrentgemma-2b (depth 3: one (R, R, A) group): relative L2 0.0072 /
#     0.0069 / 0.0072 and at most 1.5 / 1.25 / 1.625 steps on an H100
#     qwen2-vl-2b and musicgen-large (fed stub embeddings) take codeqwen's
#     limits: dense transformers of the same kind
PARITY_LIMITS = {"codeqwen1.5-7b": (2.0 ** -6, 2), "mamba2-370m": (2.0 ** -9, 1),
                 "qwen2.5-32b": (2.0 ** -6, 2), "olmoe-1b-7b": (2.0 ** -5.5, 10),
                 "deepseek-v2-236b": (2.0 ** -5, 25), "recurrentgemma-2b": (2.0 ** -6, 3),
                 "qwen2-vl-2b": (2.0 ** -6, 2), "musicgen-large": (2.0 ** -6, 2)}
#: depth of the parity phase's model, where it is not 2: Griffin's first
#: (R, R, A) group, so an attention block is held too
PARITY_DEPTH = {"recurrentgemma-2b": 3}
# f32 rate outside the tensor cores (the SSD scan's arithmetic)
F32_FLOP_PER_S = 67e12

PROMPT_LEN, MAX_NEW, N_REQ, MAX_BATCH, CHUNK = 128, 32, 16, 8, 32
DRAFT_LEN = 4
#: the paged runs (codeqwen): page size, and the prefix the shared-prefix
#: prompts share (a multiple of CHUNK, so admission after a hit keeps the
#: dense engine's chunk boundaries)
PAGE_SIZE, PREFIX_LEN = 16, 96
#: paged run (e): prompts of PROMPT_E tokens sharing PREFIX_E = 7 pages, not
#: a multiple of CHUNK, so admission after a hit runs other chunk
#: boundaries than the dense engine's, past 256 live keys (flash splits)
PREFIX_E, PROMPT_E = 112, 320
#: the long-context serve run (codeqwen): a 4,096-token context, one prompt
#: that fills it but for a chunk, admitted in 127 chunks of 32
LONG_LEN, LONG_REQ, LONG_BATCH, LONG_NEW = 4096, 1, 2, 8
#: requests in the paged run (e) and its dense pair, and in the sampled pair:
#: one wave of MAX_BATCH (the other runs take N_REQ, two waves)
SHORT_REQ = MAX_BATCH

ARCHS = ("codeqwen1.5-7b", "mamba2-370m", "olmoe-1b-7b", "recurrentgemma-2b")
#: the depth-2 parity phase also runs a GQA transformer and DeepSeek-V2's
#: MLA (layer 0 dense, layer 1 160 routed experts); neither is served here
PARITY_ARCHS = ARCHS + ("qwen2.5-32b", "deepseek-v2-236b")
#: (arch, decode) -> the kernels that run launches; a speculative step's
#: decode is the verify pass, which never launches decode attention
RUN_KERNELS = {("codeqwen1.5-7b", "plain"): ("cascade_matmul", "decode_attention",
                                             "flash_attention", "norm"),
               ("codeqwen1.5-7b", "spec"): ("cascade_matmul", "flash_attention", "norm"),
               ("mamba2-370m", "plain"): ("cascade_matmul", "norm", "ssd_scan"),
               ("mamba2-370m", "spec"): ("cascade_matmul", "norm", "ssd_scan"),
               ("olmoe-1b-7b", "plain"): ("cascade_matmul", "cascade_matmul_grouped",
                                          "decode_attention", "flash_attention", "norm"),
               ("olmoe-1b-7b", "spec"): ("cascade_matmul", "cascade_matmul_grouped",
                                         "flash_attention", "norm"),
               ("recurrentgemma-2b", "plain"): ("cascade_matmul", "decode_attention",
                                                "flash_attention", "norm"),
               ("recurrentgemma-2b", "spec"): ("cascade_matmul", "flash_attention", "norm"),
               ("qwen2-vl-2b", "model"): ("cascade_matmul", "decode_attention",
                                          "flash_attention", "norm"),
               ("musicgen-large", "model"): ("cascade_matmul", "decode_attention",
                                             "flash_attention", "norm")}
#: the Griffin run whose streams cross the window: CROSS_REQ prompts of
#: CROSS_LEN tokens, MAX_NEW new tokens each (positions past 2,048); its
#: unfused reference admits them in chunks of CROSS_REF_CHUNK (8 calls a
#: prompt, not 64: each unfused call dequantizes every weight)
CROSS_REQ, CROSS_LEN, CROSS_REF_CHUNK = 4, 2040, 256
#: the modality-stub backbones, run at the model level (the engine takes
#: token prompts): STUB_ROWS rows of a STUB_LEN-token prefill of seeded stub
#: embeddings (qwen2-vl: first an image of 1 x STUB_GRID x STUB_GRID
#: patches at its (t, h, w) positions, then text), then STUB_DECODES decode
#: steps into a cache of STUB_LEN + STUB_DECODES rows
STUB_ARCHS = ("qwen2-vl-2b", "musicgen-large")
STUB_ROWS, STUB_LEN, STUB_GRID, STUB_DECODES = MAX_BATCH, 128, 8, 32
#: the slot-wise loop: codeqwen1.5-7b cut to SLOT_DEPTH layers at full width,
#: SLOT_REQ requests of PROMPT_LEN // 4 prompt tokens and as many new ones
SLOT_DEPTH, SLOT_REQ = 2, 2
#: the fleet (the --traffic path): FLEET_REPLICAS replicas of codeqwen1.5-7b
#: at full width sharing one params tree, MAX_BATCH slots each, a seeded
#: Poisson trace of FLEET_REQ arrivals at FLEET_RATE req/s (prompts of
#: PROMPT_LEN / 2 to PROMPT_LEN tokens, outputs of MAX_NEW / 2 to MAX_NEW),
#: a FLEET_SLO_S TTFT target, no deadline; replica 0 fails FLEET_KILL_S
#: into the trace
FLEET_REPLICAS, FLEET_REQ, FLEET_RATE, FLEET_SLO_S, FLEET_KILL_S = 2, 24, 4.0, 1.0, 2.0
#: CREST on codeqwen's dense lm_head: injected columns, the cursor cycles the
#: detection run takes (n_spares 16, threshold 3: the defaults), and the
#: leading columns it protects: three cycles over all 92,416 took 28.6 s on
#: an H100 (17,328 probes at 1.65 ms), so the run takes the first 16,384
CREST_FAULTS, CREST_CYCLES, CREST_COLUMNS = 3, 3, 16384
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
#: in_proj and out_proj, in each of 32 and 48 layers; olmoe-1b-7b's q/k/v/o
#: in each of 16 layers and its lm_head (its experts take the grouped entry)
#: recurrentgemma-2b's 18 RG-LRU blocks (w_in, w_gate, w_out; wa and wx with
#: bias), 8 attention blocks (q, o; k and v of one KV head: N = 256), the
#: GeGLU MLP of all 26 layers and its untied head
MATMUL_LAYERS = {("codeqwen1.5-7b", 4096, 4096, True): 4 * 32,
                 ("codeqwen1.5-7b", 4096, 13440, False): 2 * 32,
                 ("codeqwen1.5-7b", 13440, 4096, False): 32,
                 ("mamba2-370m", 1024, 4384, False): 48,
                 ("mamba2-370m", 2048, 1024, False): 48,
                 ("olmoe-1b-7b", 2048, 2048, False): 4 * 16,
                 ("olmoe-1b-7b", 2048, 50304, False): 1,
                 ("recurrentgemma-2b", 2560, 2560, False): 3 * 18 + 2 * 8,
                 ("recurrentgemma-2b", 2560, 2560, True): 2 * 18,
                 ("recurrentgemma-2b", 2560, 256, False): 2 * 8,
                 ("recurrentgemma-2b", 2560, 7680, False): 2 * 26,
                 ("recurrentgemma-2b", 7680, 2560, False): 26,
                 ("recurrentgemma-2b", 2560, 256000, False): 1}
#: codeqwen's FP4 lm_head, once a step (mamba2-370m's head is tied to the
#: embedding: no FP4 matmul)
MATMUL_HEAD = ("codeqwen1.5-7b", 4096, 92416, False)
#: (arch, K, N, bias) -> launches per decode step of the modality-stub
#: backbones, run at the model level: qwen2-vl-2b's q (bias), k and v (bias;
#: 2 KV heads of 128: N = 256), o, its SwiGLU MLP in each of 28 layers and
#: its 151,936-wide head; musicgen-large's q/k/v/o and GELU MLP in each of
#: 48 layers, and its 4-codebook head (2048 -> 4 x 2048, as w_up). Each runs
#: at a decode step's 8 rows and the layers at the 8 x 128-token prefill's
#: 1,024 (the head reads the last position only)
STUB_MATMUL = {("qwen2-vl-2b", 1536, 1536, True): 28,
               ("qwen2-vl-2b", 1536, 256, True): 2 * 28,
               ("qwen2-vl-2b", 1536, 1536, False): 28,
               ("qwen2-vl-2b", 1536, 8960, False): 2 * 28,
               ("qwen2-vl-2b", 8960, 1536, False): 28,
               ("qwen2-vl-2b", 1536, 151936, False): 1,
               ("musicgen-large", 2048, 2048, False): 4 * 48,
               ("musicgen-large", 2048, 8192, False): 48 + 1,
               ("musicgen-large", 8192, 2048, False): 48}
STUB_PREFILL_ROWS = 8 * 128
#: decode-attention case -> (arch, launches per model-level decode step):
#: one a layer
STUB_ATTN = {"musicgen_step_d64": ("musicgen-large", 48), "qwen2vl_step_g6": ("qwen2-vl-2b", 28)}
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
    rows += [(cq, 64, 4096, 13440, False, 0, 0), (cq, 64, 13440, 4096, False, 0, 0),
             (cq, 1, *MATMUL_HEAD[1:], 0, 0)]
    for (arch, k, n, bias), count in STUB_MATMUL.items():
        rows.append((arch, MAX_BATCH, k, n, bias, count, 0))
        if n < 100000:
            rows.append((arch, STUB_PREFILL_ROWS, k, n, bias, 0, 0))
    return rows


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
    for arch, k, n, with_bias in list(MATMUL_LAYERS) + [key for key in STUB_MATMUL
                                                        if key[2] < 100000]:
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


#: (arch, experts, top-k, K, N, C, launches per decode step): the grouped
#: expert matmul at olmoe's gate/up (2048 -> 1024, two a layer) and down
#: (1024 -> 2048) at a decode step's C = 8, an admission chunk's 32 and a
#: verify pass's 40, and deepseek-v2's (5120 -> 1536, 1536 -> 5120) at C = 8
GROUPED_SHAPES = ([("olmoe-1b-7b", 64, 8, 2048, 1024, c, 2 * 16 if c == MAX_BATCH else 0)
                   for c in (MAX_BATCH, CHUNK, MAX_BATCH * (1 + DRAFT_LEN))]
                  + [("olmoe-1b-7b", 64, 8, 1024, 2048, c, 16 if c == MAX_BATCH else 0)
                     for c in (MAX_BATCH, CHUNK, MAX_BATCH * (1 + DRAFT_LEN))]
                  + [("deepseek-v2-236b", 160, 6, 5120, 1536, MAX_BATCH, 0),
                     ("deepseek-v2-236b", 160, 6, 1536, 5120, MAX_BATCH, 0)])


def grouped_matmul_phase(torch, dev):
    """The grouped expert matmul at the served shapes, its rows routed as a
    step routes its tokens (C tokens, each to top-k distinct experts drawn
    at random; x zero past each expert's rows, as the dispatch builds it):
    held to its plain version (bf16 out, as served) and, bit for bit, to a
    loop of per-expert ``ops.cascade_matmul`` calls over each expert's C
    rows (the route it replaces); timed cold beside the plain version,
    ``torch.bmm`` on the dense bf16 experts and that loop, and its bound
    from the bytes of the experts with rows."""
    from repro_torch.core import quant
    from repro_torch.kernels import cascade_matmul as cm
    from repro_torch.kernels import ops

    rows_out = []
    for arch, e, top, k, n, c, per_step in GROUPED_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(e + k + c)
        parts = [quant.quantize_weight(torch.randn((k, n), generator=gen, device=dev), 0)
                 for _ in range(e)]
        packed = torch.stack([p[0] for p in parts])
        scales = torch.stack([p[1] for p in parts])
        del parts
        picks = torch.argsort(torch.rand((c, e), generator=gen, device=dev), dim=-1)[:, :top]
        rows = torch.bincount(picks.flatten(), minlength=e).to(torch.int32)
        live = torch.arange(c, device=dev)[None, :] < rows[:, None]
        x = torch.randn((e, c, k), generator=gen, device=dev) / k ** 0.5
        x = torch.where(live[..., None], x, 0.0).to(torch.bfloat16)
        got = ops.cascade_matmul_grouped(x, packed, scales, rows, out_dtype=torch.bfloat16)
        want = cm.cascade_matmul_grouped_plain(x, packed, scales, rows, torch.bfloat16)
        loop = torch.stack([ops.cascade_matmul(x[i], packed[i], scales[i],
                                               out_dtype=torch.bfloat16) for i in range(e)])
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = MATMUL_BF16_RTOL * float(want.float().abs().max()) + MATMUL_ATOL
        row = {"arch": arch, "E": e, "top_k": top, "C": c, "K": k, "N": n,
               "experts_with_rows": int((rows > 0).sum()), "routed_rows": int(rows.sum()),
               "plan": {kk: list(v) if isinstance(v, tuple) else v
                        for kk, v in cm.plan_grouped(e, c, n).items()},
               "launches_per_decode_step": per_step, "max_abs_err": err, "tol": tol,
               "equals_per_expert_calls": bool(torch.equal(got, loop)),
               "zeros_past_rows": not bool(got[~live].any())}
        if not (err <= tol and row["equals_per_expert_calls"] and row["zeros_past_rows"]):
            fail(f"cascade_matmul_grouped {arch} ({e}x{c}, {k}->{n}): {row}")
        wbytes = (packed.numel() // e + scales.numel() // e * 4) * row["experts_with_rows"]
        nc = copies_beyond_l2(packed.numel() + scales.numel() * 4)
        sets = [(x, packed if i == 0 else packed.clone(), scales if i == 0 else scales.clone(),
                 rows) for i in range(nc)]
        kern = lambda a, p, sc, r: ops.cascade_matmul_grouped(a, p, sc, r,
                                                              out_dtype=torch.bfloat16)
        plain = lambda a, p, sc, r: cm.cascade_matmul_grouped_plain(a, p, sc, r, torch.bfloat16)
        per_expert = lambda a, p, sc, r: [ops.cascade_matmul(a[i], p[i], sc[i],
                                                             out_dtype=torch.bfloat16)
                                          for i in range(e)]
        dense = torch.stack([quant.dequantize_weight(packed[i], scales[i], torch.bfloat16)
                             for i in range(e)])
        lib_sets = [(x, dense if i == 0 else dense.clone())
                    for i in range(copies_beyond_l2(dense.numel() * 2))]
        row.update({"ms": graph_ms(torch, kern, sets, 40),
                    "per_expert_loop_ms": graph_ms(torch, per_expert, sets, 3),
                    "plain_ms": graph_ms(torch, plain, sets[:1], 2),
                    "library_ms": graph_ms(torch, lambda a, wd: torch.bmm(a, wd), lib_sets, 10),
                    "library_note": "torch.bmm of bf16 (E, C, K) x dense bf16 (E, K, N) experts"})
        # the weights of the experts with rows, their live rows of x, every
        # output row written (zeros past the rows included)
        nbytes = wbytes + int(rows.sum()) * k * 2 + e * c * n * 2
        flops = 2 * int(rows.sum()) * k * n
        row.update({"bytes": nbytes, "flops": flops,
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
                    "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                                 else "operations")})
        rows_out.append(row)
        del sets, lib_sets, dense, packed, scales
        torch.cuda.empty_cache()
    return rows_out


def decode_attention_cases():
    """(name, B, Hq, Hkv, T, positions, D): the served codeqwen step (8
    slots at 128-156 of the engine's 192-row cache), qwen2.5-32b's GQA
    heads (40 over 8) at the same positions, a long context (T = 4096,
    positions spread over 2,047-4,095, so 2,048-4,096 live keys a row), and
    the modality-stub backbones' steps: musicgen-large's 32 heads at D = 64
    and qwen2-vl-2b's 12 over 2 KV heads (G = 6)."""
    t = -(-(PROMPT_LEN + MAX_NEW + 1) // CHUNK) * CHUNK      # the engine's cache length
    served = [PROMPT_LEN + 4 * i for i in range(MAX_BATCH)]
    long_pos = [2047 + round(i * 2048 / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    return [("codeqwen_step", MAX_BATCH, 32, 32, t, served, 128),
            ("olmoe_step", MAX_BATCH, 16, 16, t, served, 128),
            ("qwen2.5-32b_gqa", MAX_BATCH, 40, 8, t, served, 128),
            ("long_4096", MAX_BATCH, 32, 32, 4096, long_pos, 128),
            ("musicgen_step_d64", MAX_BATCH, 32, 32, t, served, 64),
            ("qwen2vl_step_g6", MAX_BATCH, 12, 2, t, served, 128)]


def attention_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    rows = []
    for name, b, hq, hkv, t, positions, d in decode_attention_cases():
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
        row["launches_per_decode_step"] = {"codeqwen_step": 32, "olmoe_step": 16,
                                           **{c: k for c, (_, k) in STUB_ATTN.items()}
                                           }.get(name, 0)
        rows.append(row)
        del sets, kc, vc
        torch.cuda.empty_cache()
    return rows


def flash_cases():
    """(name, B, Hq, Hkv, S, T, causal, offsets, D): at D = 128 the TPU
    kernel's own signature (T = S, offset 0), not causal, GQA at phi4-mini's
    24/8 heads, the admission chunk at each of its offsets into the engine's
    192-row cache and late in a 4,096-row one (T is the live prefix the
    engine hands in, offset + 32: from 256 live keys on the chunk is split
    over the keys), and the verify pass (8 rows of 1 + 4 tokens at positions
    spread over the cache); the modality-stub backbones' 8 x 128-token
    prefills (musicgen-large's 32 heads at D = 64, qwen2-vl-2b's 12 over 2
    KV heads) and, at D = 64, an admission chunk of 32 over a 160-row cache."""
    t = -(-(PROMPT_LEN + MAX_NEW + 1 + DRAFT_LEN) // CHUNK) * CHUNK     # the engine's cache
    n = DRAFT_LEN + 1
    verify_off = [round(i * (t - n) / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    d = 128
    return ([("tpu_causal_128", 1, 32, 32, 128, 128, True, [0], d),
             ("tpu_causal_2048", 1, 32, 32, 2048, 2048, True, [0], d),
             ("tpu_full_128", 1, 32, 32, 128, 128, False, [0], d),
             ("gqa_512", 1, 24, 8, 512, 512, True, [0], d)]
            + [(f"admit_off{o}", 1, 32, 32, CHUNK, o + CHUNK, True, [o], d)
               for o in (0, 32, 64, 96)]
            + [(f"admit4k_off{o}", 1, 32, 32, CHUNK, o + CHUNK, True, [o], d)
               for o in (224, 2016, LONG_LEN - CHUNK)]
            + [("verify", MAX_BATCH, 32, 32, n, t, True, verify_off, d),
               ("musicgen_prefill_d64", MAX_BATCH, 32, 32, 128, 128, True, [0] * MAX_BATCH, 64),
               ("musicgen_admit_d64", 1, 32, 32, CHUNK, 160, True, [128], 64),
               ("qwen2vl_prefill", MAX_BATCH, 12, 2, 128, 128, True, [0] * MAX_BATCH, d)])


def flash_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = []
    for name, b, hq, hkv, s, t, causal, offsets, d in flash_cases():
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


def ring_slot_pos(torch, b, t, positions, dev):
    """(B, T) int32 ``slot_pos`` of a ring of T rows whose row b next writes
    position ``positions[b]`` (-1 where never written)."""
    pos = torch.tensor(positions, dtype=torch.int64, device=dev)[:, None]
    last = pos - 1 - ((pos - 1 - torch.arange(t, device=dev)[None, :]) % t)
    return torch.where(last >= 0, last, -1).to(torch.int32)


GRIFFIN_WINDOW, GRIFFIN_HEADS, GRIFFIN_D = 2048, 10, 256


def local_flash_cases():
    """(name, B, S, ring rows or 0, window, offsets), Griffin's heads (10
    over 1 KV head of 256): the admission chunk over [ring, chunk] before
    and after the ring wraps, the verify pass (8 rows of 1 + 4 over [ring,
    chunk]), and a windowed S = T = 2048 prompt at window 2048 and 512."""
    n = DRAFT_LEN + 1
    return [("griffin_admit_off96", 1, CHUNK, GRIFFIN_WINDOW, GRIFFIN_WINDOW, [96]),
            ("griffin_admit_off2016", 1, CHUNK, GRIFFIN_WINDOW, GRIFFIN_WINDOW, [2016]),
            ("griffin_verify", MAX_BATCH, n, GRIFFIN_WINDOW, GRIFFIN_WINDOW,
             [PROMPT_LEN + 4 * i for i in range(MAX_BATCH // 2)]
             + [2040, 2047, 2100, 4000]),
            ("prefill_2048_w2048", 1, 2048, 0, 2048, [0]),
            ("prefill_2048_w512", 1, 2048, 0, 512, [0])]


def local_flash_phase(torch, dev):
    """Flash attention at head dim 256 with the window mask: ``k_pos`` (a
    ring's rows at their positions, then the chunk's) and ``window``, and a
    windowed prompt without ``k_pos``; held to the plain version at the
    flash tolerance, timed beside it and SDPA with the same boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    hq, hkv, d = GRIFFIN_HEADS, 1, GRIFFIN_D
    rows = []
    for name, b, s, ring, window, offsets in local_flash_cases():
        t = ring + s if ring else s
        gen = torch.Generator(device=dev)
        gen.manual_seed(s * 7 + t)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        qv, k, v = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        k_pos = None
        qrows = off[:, None] + torch.arange(s, device=dev, dtype=torch.int32)      # (B, S)
        if ring:
            k_pos = torch.cat([ring_slot_pos(torch, b, ring, offsets, dev), qrows], dim=1)
        kp = (torch.arange(t, device=dev)[None, :].expand(b, t) if k_pos is None else k_pos)
        vis = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qrows[:, :, None])
               & (qrows[:, :, None] - kp[:, None, :] < window))                     # (B, S, T)
        got = ops.flash_attention(qv, k, v, q_offset=off, k_pos=k_pos, window=window)
        want = fa.flash_attention_plain(qv, k, v, True, None, off, k_pos, window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = FLASH_RTOL * want.float().abs() + FLASH_VTOL * float(vc.float().abs().max())
        pl = fa.plan(b, hq, hkv, s, t, sms=torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
        row = {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "T": t, "D": d,
               "ring_rows": ring, "window": window, "q_offset": offsets, "k_pos": ring > 0,
               "splits": pl["splits"], "blocks": pl["blocks"],
               "max_abs_err": float(err.max()), "max_err_over_tol": float((err / tol).max()),
               "visible_pairs": int(vis.sum())}
        if not bool((err <= tol).all()):
            fail(f"flash_attention (local) {name}: kernel vs plain out of tolerance: {row}")
        # every input read once: q, the K/V rows some query sees, the
        # offsets and k_pos; the output written once; the products of the
        # visible (query, key) pairs
        kv_rows = int(vis.any(dim=1).sum())
        nbytes = 2 * q.numel() * 2 + 2 * kv_rows * hkv * d * 2 + b * 4 \
            + (k_pos.numel() * 4 if ring else 0)
        flops = 4 * d * hq * row["visible_pairs"]
        nc = copies_beyond_l2(nbytes)
        sets = [(qv, k.clone(), v.clone(), off) for _ in range(nc)]
        kern = lambda a, kk, vv, o: ops.flash_attention(a, kk, vv, q_offset=o, k_pos=k_pos,
                                                        window=window)
        plain = lambda a, kk, vv, o: fa.flash_attention_plain(a, kk, vv, True, None, o, k_pos,
                                                              window)
        lib = lambda a, kk, vv, o: F.scaled_dot_product_attention(
            a, kk, vv, attn_mask=vis[:, None], enable_gqa=True)
        big = s * t > 2 ** 20
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


def ring_decode_phase(torch, dev):
    """Decode attention at Griffin's ring: 8 slots, a 2,048-row ring, 10
    query heads over one KV head of 256 (two blocks of 5 heads), the (B, T)
    mask built from ``slot_pos`` as the served step builds it, before and
    after the ring wraps; held to the plain version, timed beside it and
    SDPA with the same mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    b, t, hq, hkv, d = MAX_BATCH, GRIFFIN_WINDOW, GRIFFIN_HEADS, 1, GRIFFIN_D
    rows = []
    for name, positions in (("griffin_ring_early", [PROMPT_LEN + 4 * i for i in range(b)]),
                            ("griffin_ring_wrapped", [2040 + 300 * i for i in range(b)])):
        gen = torch.Generator(device=dev)
        gen.manual_seed(sum(positions))
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = kc[1], vc[1]
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        sp = ring_slot_pos(torch, b, t, [p + 1 for p in positions], dev)
        mask = (sp >= 0) & (sp <= pos[:, None]) & (pos[:, None] - sp < GRIFFIN_WINDOW)
        live = int(mask.sum())
        got = ops.decode_attention(q, k, v, mask)
        want = da.decode_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= ATTN_ATOL:
            fail(f"decode_attention {name}: max|err| {err} > {ATTN_ATOL}")
        nc = copies_beyond_l2(k.numel() * 4)
        sets = [(q, k if i == 0 else k.clone(), v if i == 0 else v.clone(), mask)
                for i in range(nc)]
        kern = lambda a, kk, vv, m: ops.decode_attention(a, kk, vv, m)
        plain = lambda a, kk, vv, m: da.decode_attention_plain(a, kk, vv, m)
        lib = lambda a, kk, vv, m: F.scaled_dot_product_attention(
            a[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=m[:, None, None, :],
            enable_gqa=True)
        row = {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "T": t, "D": d, "positions": positions,
               "live_keys": live, "splits": da.choose_splits(b, hkv, hq // hkv, t),
               "heads_per_block": da.heads_per_block(hq // hkv), "max_abs_err": err,
               "tol": ATTN_ATOL, "ms": graph_ms(torch, kern, sets, 100),
               "plain_ms": graph_ms(torch, plain, sets, 20),
               "library_ms": graph_ms(torch, lib, sets, 100)}
        # the live K/V rows, q, the mask read once; the f32 output written once
        nbytes = q.numel() * 2 + 2 * live * hkv * d * 2 + b * t + b * hq * d * 4
        flops = 4 * live * hq * d
        row.update({"bytes": nbytes, "flops": flops,
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
    recurrentgemma-2b's first block's norm at 2,560 in the same three
    shapes, a LayerNorm at codeqwen's width, musicgen-large's LayerNorm
    (with bias) at 2,048 in 8, (8, 5) and 32 rows, and qwen2-vl-2b's
    RMSNorm at 1,536."""
    v = (MAX_BATCH, 1 + DRAFT_LEN)
    return [("codeqwen_step", (MAX_BATCH, 1), 4096, "rmsnorm"),
            ("codeqwen_verify", v, 4096, "rmsnorm"),
            ("codeqwen_admit", (1, CHUNK), 4096, "rmsnorm"),
            ("mamba_step", (MAX_BATCH, 1), 1024, "rmsnorm"),
            ("mamba_gated_step", (MAX_BATCH, 1), 2048, "rmsnorm"),
            ("mamba_gated_verify", v, 2048, "rmsnorm"),
            ("griffin_step", (MAX_BATCH, 1), 2560, "rmsnorm"),
            ("griffin_verify", v, 2560, "rmsnorm"),
            ("griffin_admit", (1, CHUNK), 2560, "rmsnorm"),
            ("layernorm_4096", (MAX_BATCH, 1), 4096, "layernorm"),
            ("musicgen_step", (MAX_BATCH, 1), 2048, "layernorm"),
            ("musicgen_verify", v, 2048, "layernorm"),
            ("musicgen_rows32", (1, CHUNK), 2048, "layernorm"),
            ("qwen2vl_step", (MAX_BATCH, 1), 1536, "rmsnorm")]


#: mamba2-370m's in_proj output width (z, x, B, C, dt): z is its first
#: 2,048 columns, read by the gated norm in place
MAMBA_IN_PROJ = 4384


def fused_norm_cases():
    """(name, form, leading shape, d, x dtype[, norm type]): the residual add inside the norm
    (add-norm) at codeqwen's 4,096 (a decode step's 8 rows, a verify pass's
    (8, 5), an admission chunk's (1, 32)), recurrentgemma-2b's 2,560 in the
    same three shapes, mamba2-370m's 1,024 (step and verify), and Mamba-2's
    gate inside its gated norm at 2,048 (step and verify, and an admission
    chunk, whose dual form hands over f32 y beside bf16 z), and musicgen-
    large's add-LayerNorm (with bias) at 2,048 in 8, (8, 5) and 32 rows.
    Rows are bf16 but where stated; the norm is RMSNorm but where stated."""
    v = (MAX_BATCH, 1 + DRAFT_LEN)
    return [("codeqwen_step_add", "add", (MAX_BATCH, 1), 4096, "bfloat16"),
            ("codeqwen_verify_add", "add", v, 4096, "bfloat16"),
            ("codeqwen_admit_add", "add", (1, CHUNK), 4096, "bfloat16"),
            ("griffin_step_add", "add", (MAX_BATCH, 1), 2560, "bfloat16"),
            ("griffin_verify_add", "add", v, 2560, "bfloat16"),
            ("griffin_admit_add", "add", (1, CHUNK), 2560, "bfloat16"),
            ("mamba_step_add", "add", (MAX_BATCH, 1), 1024, "bfloat16"),
            ("olmoe_step_add", "add", (MAX_BATCH, 1), 2048, "bfloat16"),
            ("mamba_verify_add", "add", v, 1024, "bfloat16"),
            ("mamba_gated_step_fused", "gated", (MAX_BATCH, 1), 2048, "bfloat16"),
            ("mamba_gated_verify_fused", "gated", v, 2048, "bfloat16"),
            ("mamba_gated_admit_fused_f32_y", "gated", (1, CHUNK), 2048, "float32"),
            ("musicgen_step_add", "add", (MAX_BATCH, 1), 2048, "bfloat16", "layernorm"),
            ("musicgen_verify_add", "add", v, 2048, "bfloat16", "layernorm"),
            ("musicgen_rows32_add", "add", (1, CHUNK), 2048, "bfloat16", "layernorm")]


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
    for name, form, lead, d, xdtype, *kind in fused_norm_cases():
        kind = kind[0] if kind else "rmsnorm"
        gen = torch.Generator(device=dev).manual_seed(d + len(lead) + 1)
        x = (3 * torch.randn(lead + (d,), generator=gen, device=dev) + 0.5) \
            .to(getattr(torch, xdtype))
        width = MAMBA_IN_PROJ if form == "gated" else d
        r = (3 * torch.randn(lead + (width,), generator=gen, device=dev)).to(torch.bfloat16)
        r = r[..., :d]                       # the gate's z: a column slice, read in place
        scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        bias = 0.1 * torch.randn((d,), generator=gen, device=dev) if kind == "layernorm" \
            else None
        w16 = scale.to(x.dtype)
        b16 = None if bias is None else bias.to(x.dtype)
        if form == "add":
            def kern(a, b):
                return ops.add_norm(a, b, scale, bias, norm_type=kind)

            def old(a, b):
                s = a + b
                return ops.norm(s, scale, bias, norm_type=kind), s

            def plain(a, b):
                return nrm.add_norm_plain(a, b, scale, bias, kind)

            def lib(a, b):
                if kind == "layernorm":
                    return F.layer_norm(torch.add(a, b), (d,), w16, b16, 1e-6)
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
        row = {"case": name, "form": form, "rows": list(lead), "d": d, "norm_type": kind,
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
            * x.numel() + d * 4 * (2 if bias is not None else 1)
        row.update({"ms": graph_ms(torch, kern, [(x, r)], 200),
                    "old_route_ms": graph_ms(torch, old, [(x, r)], 200),
                    "host_us": host_us(torch, kern, (x, r)),
                    "old_route_host_us": host_us(torch, old, (x, r)),
                    "plain_ms": graph_ms(torch, plain, [(x, r)], 100),
                    "library_ms": graph_ms(torch, lib, [(x, r)], 200),
                    "library_note": ("torch.add" if form == "add" else "F.silu, multiply, cast")
                    + (" then F.layer_norm" if kind == "layernorm" else " then F.rms_norm")
                    + " on weights in the rows' dtype, a yardstick only",
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
              (cm, "cascade_matmul_grouped_cuda", cm.cascade_matmul_grouped_plain),
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


def paged_pool_phase(torch, dev):
    """The paged pool's row traffic at the served codeqwen decode step (one
    layer: 8 slots at positions 128-156 of 12 blocks of 16 rows, pages
    scattered over a 97-page pool, 32 KV heads of 128, bf16): the gather of
    the slots' pages into the dense (8, 192, 32, 128) view, the scatter of
    the step's new rows and the block-table lookup, each on the card equal
    to the CPU on every live page, and timed per call beside its byte bound
    and the dense cache's row write (``layers.update_rows``). These are
    PyTorch ops (index_select, index_copy_), not kernels of the port: a step
    runs each twice a layer (K and V), the lookup once."""
    import numpy as np
    from repro_torch.models import cache_utils as C
    from repro_torch.models import layers as L

    b, ps, hkv, d = MAX_BATCH, PAGE_SIZE, 32, 128
    t = -(-(PROMPT_LEN + MAX_NEW + 1) // CHUNK) * CHUNK      # the engine's cache length
    nb = t // ps
    npages = b * nb + 1
    gen = torch.Generator(device=dev).manual_seed(5)
    bt = torch.from_numpy(1 + np.random.default_rng(5).permutation(b * nb).reshape(b, nb)
                          .astype(np.int64)).to(dev)            # as the engine pushes it
    pos = torch.tensor([PROMPT_LEN + 4 * i for i in range(b)], dtype=torch.int32, device=dev)
    rows = pos.to(torch.int64)[:, None]
    nc = copies_beyond_l2(npages * ps * hkv * d * 2)
    pools = [torch.randn((npages, ps, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(nc)]
    new = torch.randn((b, 1, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
    phys = C.paged_phys_rows(bt, rows, ps)
    ref = pools[0].cpu()
    C.paged_update_rows(ref, new.cpu(), C.paged_phys_rows(bt.cpu(), rows.cpu(), ps))
    got = pools[0].clone()
    C.paged_update_rows(got, new, phys)
    gathered = C.paged_gather(got, bt, ps)
    if not (torch.equal(got[1:].cpu(), ref[1:])
            and torch.equal(gathered.cpu(), C.paged_gather(ref, bt.cpu(), ps))):
        fail("paged pool: the card's scatter or gather differs from the CPU's on live pages")
    dense = [torch.randn((b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(nc)]
    view = b * t * hkv * d * 2
    rows_bytes = b * hkv * d * 2
    out = {"B": b, "page_size": ps, "blocks": nb, "pages": npages, "Hkv": hkv, "D": d,
           "equal_cpu_on_live_pages": True,
           "gather_ms": graph_ms(torch, lambda p: C.paged_gather(p, bt, ps), [(p,) for p in pools],
                                 100),
           "gather_bound_ms": (2 * view + bt.numel() * 8) / HBM_BYTES_PER_S * 1e3,
           "scatter_ms": graph_ms(torch, lambda p: C.paged_update_rows(p, new, phys),
                                  [(p,) for p in pools], 200),
           "scatter_bound_ms": (2 * rows_bytes + phys.numel() * 8) / HBM_BYTES_PER_S * 1e3,
           "lookup_ms": graph_ms(torch, lambda: C.paged_phys_rows(bt, rows, ps), [()], 200),
           "dense_row_write_ms": graph_ms(torch, lambda c: L.update_rows(c, new, pos),
                                          [(c,) for c in dense], 200)}
    layers = 32
    out["per_step_ms"] = {
        "gather": 2 * layers * out["gather_ms"], "scatter": 2 * layers * out["scatter_ms"],
        "lookup": layers * out["lookup_ms"],
        "dense_row_write": 2 * layers * out["dense_row_write_ms"]}
    del pools, dense
    torch.cuda.empty_cache()
    return out


def bf16_step(x: float) -> float:
    """The bf16 step (unit in the last place) at magnitude |x| > 0."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


@contextlib.contextmanager
def recorded_routes(torch):
    """Record every MoE routing made inside: the experts of each token (T,
    k) and, per token, the router's k-th minus (k+1)-th probability."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def record(params, xf, cfg):
        gates, idx = route(params, xf, cfg)
        probs = torch.softmax(moe.router_logits(xf, params["router"]), dim=-1)
        top = torch.topk(probs, cfg.moe_top_k + 1, dim=-1).values
        seen.append((idx, top[:, -2] - top[:, -1]))
        return gates, idx
    moe.route = record
    try:
        yield seen
    finally:
        moe.route = route


def route_flips(torch, plain, kernel):
    """Tokens whose expert list differs between two runs' routings, with the
    plain run's k-th vs (k+1)-th router probability margin there."""
    flips, margins = 0, []
    for (ip, mp), (ik, _) in zip(plain, kernel):
        rows = (ip != ik).any(dim=-1)
        flips += int(rows.sum())
        margins += mp[rows].tolist()
    return {"routings": len(plain), "tokens_routed": sum(int(i.shape[0]) for i, _ in plain),
            "tokens_flipped": flips, "flip_prob_margins": margins,
            "min_prob_margin": min((float(m.min()) for _, m in plain), default=None)}


def parity_phase(torch, dev, arch: str):
    """Depth-2 parity, kernels vs plain versions on the card; returns the
    readings with ``within_limits`` (the caller fails after every phase has
    run, so one run reads all of them)."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config(arch), n_layers=PARITY_DEPTH.get(arch, 2))
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(3, ccfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (MAX_BATCH, CHUNK), device=dev, generator=gen)
    chunk = torch.randint(0, cfg.vocab, (MAX_BATCH, 1 + DRAFT_LEN), device=dev, generator=gen)
    from repro_torch.kernels import ops
    out, routes = {}, {}
    nxt = None
    with torch.no_grad():
        for name, route in (("plain", plain_versions_on_card), ("kernel", contextlib.nullcontext)):
            ops.reset_launch_counts()
            with route(), recorded_routes(torch) as routes[name]:
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
    attn_layers = getattr(model, "n_attn", cfg.n_layers)
    if cfg.family in ("dense", "moe", "hybrid") and not cfg.kv_lora \
            and launches["decode_attention"] != attn_layers:
        fail(f"depth-2 parity ({arch}): the decode step launched decode attention "
             f"{launches['decode_attention']} times, not once per attention layer: {launches}")
    if not all(torch.isfinite(o).all() for o in out["kernel"]):
        fail(f"depth-2 parity ({arch}): kernel logits not finite")
    res = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "kernel_launches": launches,
           "logit_absmax": float(out["plain"][1].abs().max())}
    parity_readings(torch, res, arch, ("prefill", "decode", "verify"), out)
    if cfg.family == "moe":
        res["routing"] = route_flips(torch, routes["plain"], routes["kernel"])
    if cfg.kv_lora:
        # MLA's absorbed decode dequantizes wkv_b (kv_lora x H*(nope+v)) in
        # every layer of every step (plain work, as in the reference): its
        # time a call, and one depth-2 decode step profiled on the kernels
        from repro_torch.core import cascade
        wkv_b = params["dense_layers"][0]["attn"]["wkv_b"]
        with torch.no_grad():
            step = profile_call(torch, lambda: model.decode_step(
                params, {"tokens": nxt}, cache, ccfg)[0].shape[0])
        res["mla"] = {"wkv_b_shape": [cfg.kv_lora, cfg.n_heads * (cfg.qk_nope_dim
                                                                   + cfg.v_head_dim)],
                      "wkv_b_dequant_ms": graph_ms(
                          torch, lambda: cascade.linear_weight(wkv_b, ccfg), [()], 20),
                      "dequants_per_decode_step": cfg.n_layers,
                      "decode_step": {k: step[k] for k in ("device_busy_ms", "device_kernels",
                                                           "our_kernels", "top_kernels")}}
    return res


def parity_readings(torch, res: dict, arch: str, stages, out: dict):
    """Per stage, the kernel run's logits against the plain run's: into
    ``res`` the largest error, relative L2, error in bf16 steps of
    max|plain|, the share of logits moved and argmax agreement, the path's
    limits and ``within_limits``."""
    rel_limit, step_limit = PARITY_LIMITS[arch]
    res["tol"] = {"rel_l2": rel_limit, "max_bf16_steps": step_limit}
    rels, steps = [], []
    for stage, a, b in zip(stages, out["kernel"], out["plain"]):
        rels.append(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)))
        steps.append(float((a - b).abs().max()) / bf16_step(float(b.abs().max())))
        res.update({f"{stage}_max_abs_err": float((a - b).abs().max()),
                    f"{stage}_rel_l2": rels[-1], f"{stage}_max_bf16_steps": steps[-1],
                    f"{stage}_moved_share": float((a != b).float().mean()),
                    f"{stage}_argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                                   .float().mean())})
    res["within_limits"] = max(rels) <= rel_limit and max(steps) <= step_limit


def profile_step(torch, eng) -> dict:
    """One engine step under torch.profiler: the device's busy time (sum of
    kernel durations) and the kernels that take most of it. The profiler
    slows the host, so this step's wall time is not a step time."""
    return profile_call(torch, eng.step)


def profile_call(torch, fn) -> dict:
    """``fn()`` under torch.profiler, as :func:`profile_step` reads a step
    (``tokens`` is what ``fn`` returns)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        produced = fn()
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
        for k in ("cascade_matmul", "cascade_matmul_grouped", "decode_attention",
                  "flash_attention", "norm", "ssd_scan"):
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
    # the KV rows' reads and writes outside the kernels: the paged pool's
    # gather (index_select) and scatter (index_copy_), the dense cache's row
    # write (index_put_), and Griffin's [ring, chunk] keys and values
    # (torch.cat: every concatenation of the step counts here)
    pool = {}
    for name, (n, us) in by_name.items():
        for key, pat in (("gather", r"index_select|indexSelect|vectorized_gather_kernel"),
                         ("scatter", r"index_copy|index_put"), ("concat", r"CatArrayBatchedCopy")):
            if re.search(pat, name):
                c, t = pool.get(key, (0, 0.0))
                pool[key] = (c + n, t + us)
    # the MoE routing around the expert matmuls, by the ATen op that
    # launched it (device ms of its kernels): the router's f32 product, the
    # softmax, the top-k sort, the dispatch's cumsum and scatter-add, the
    # combine's gather (``aten::index``; the KV row writes are index_put_)
    routing = {}
    for ev in prof.key_averages():
        key = {"aten::mm": "router_mm", "aten::_softmax": "softmax", "aten::sort": "topk_sort",
               "aten::cumsum": "dispatch_cumsum", "aten::index_add_": "dispatch_scatter",
               "aten::index": "combine_gather"}.get(ev.key)
        if key:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            routing[key] = {"count": ev.count, "ms": dev_us / 1e3}
    return {"tokens": produced, "wall_ms_under_profiler": wall_ms,
            "device_busy_ms": busy_ms if by_name else "not measured",
            "device_kernels": sum(n for n, _ in by_name.values()),
            "our_kernels": {k: {"count": n, "ms": us / 1e3} for k, (n, us) in ours.items()},
            "eager_elementwise": eager,
            "kv_rows": {k: {"count": n, "ms": us / 1e3} for k, (n, us) in pool.items()},
            "routing_ops": routing,
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
    rec = {"finite": [], "decode": [], "verify": [], "top2": {}, "admission_tokens": []}
    last = {}

    def wrap(name, per_step):
        fn = getattr(model, name)

        def call(*a, **kw):
            before = dict(ops.LAUNCHES)
            if name == "prefill_extend" and not kw.get("all_logits"):
                rec["admission_tokens"].append(int(kw["n_valid"]))   # one admission chunk
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
    if (opts.get("paged") or opts.get("prefix_cache")) and not (
            eng.paged and m["effective_mode"].endswith("-paged") and not m["downgrades"]):
        fail(f"serve ({arch}, {kind}): the paged run downgraded: {m['effective_mode']}, "
             f"{m['downgrades']}")
    if not all(r.done and len(r.tokens_out) == max_new for r in reqs):
        fail(f"serve ({arch}, {kind}): not every request finished with {max_new} tokens: "
             f"{[len(r.tokens_out) for r in reqs]}")
    if not bool(torch.stack(rec["finite"]).all()):
        fail(f"serve ({arch}, {kind}): non-finite logits")
    decode = "spec" if eng.spec else "plain"
    if eng.fused and not all(launches[k] > 0 for k in RUN_KERNELS[(arch, decode)]):
        fail(f"serve ({arch}, {kind}): a kernel of the run never launched: {launches}")
    if not eng.fused and any(launches.values()):
        fail(f"serve ({arch}, {kind}): the unfused run launched a kernel: {launches}")
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
           "admission_chunks": len(rec["admission_tokens"]),
           "admission_tokens": sum(rec["admission_tokens"]),
           "first_tokens": reqs[0].tokens_out[:8]}
    if eng.paged:
        out.update({k: m[k] for k in ("page_size", "prefix_cache", "prefix_hits",
                                      "prefix_lookups", "prefix_hit_rate", "pages_in_use",
                                      "pages_total", "evictions")})
    if eng.spec:
        out.update({"draft_len": m["draft_len"], "accepted_per_step": m["accepted_per_step"],
                    "draft_tokens_accepted": m["draft_tokens_accepted"]})
        per_verify = {k: sorted({st[k] for st in steps}) for k in steps[0]}
        out["launches_per_verify_step_seen"] = per_verify
        n_layers = model.cfg.n_layers
        want = {"flash_attention": (0 if arch == "mamba2-370m"
                                    else getattr(model, "n_attn", n_layers)),
                "ssd_scan": n_layers * (1 + DRAFT_LEN) if arch == "mamba2-370m" else 0,
                "cascade_matmul_grouped": 3 * n_layers if arch == "olmoe-1b-7b" else 0,
                "decode_attention": 0, "norm": 2 * n_layers + 1}
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
    plain, eng, reqs, prec0 = serve_run(torch, dev, arch, model, params, ccfg, prompts, "plain",
                                        margins=True)
    # after the measured run: 8 more requests fill every slot (the first step
    # admits them all), and the next step, a pure 8-slot decode, is profiled
    for i in range(MAX_BATCH):
        eng.submit(Request(uid=N_REQ + i, prompt=reqs[i].prompt, max_new_tokens=4))
    eng.step()
    profiled = profile_step(torch, eng)
    eng.run_until_drained()
    del eng                    # no earlier run's engine may count in a later run's peak
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
    rep_plain, eng, plain_reqs, prec = serve_run(torch, dev, arch, model, params, ccfg, rep,
                                                 "plain_repetitive", margins=True)
    del eng
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

    diverged, moved = [], []
    for pr, sr in zip(plain_reqs, spec_reqs):
        j = first_departure(pr, sr)
        # before the streams part, how far the spec run's margins sit from the plain run's
        for i in range(MAX_NEW if j is None else j):
            moved.append(abs(top2_margin(prec["top2"][(pr.uid, i)])[1]
                             - top2_margin(srec["top2"][(sr.uid, i)])[1]))
        if j is None:
            continue
        m, steps = top2_margin(prec["top2"][(pr.uid, j)])
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
        # speculative sampling, twice with one seed, on one wave of requests
        opts = dict(draft_len=DRAFT_LEN, temperature=0.8, top_k=50, sample_seed=0)
        runs = [serve_run(torch, dev, arch, model, params, ccfg, rep[:SHORT_REQ], "spec_sampled",
                          **opts)[::2] for _ in range(2)]
        streams = [[r.tokens_out for r in reqs] for _, reqs in runs]
        if streams[0] != streams[1]:
            fail(f"serve ({arch}): two sampled runs with one seed gave different streams")
        out["sampled"] = {**runs[0][0], "same_streams_with_same_seed": True,
                          "temperature": 0.8, "top_k": 50}
        out["long_context"] = long_context_run(torch, dev, arch, model, params, ccfg)
        out.update(paged_runs(torch, dev, arch, model, params, ccfg, prompts, (reqs, prec0), rep,
                              (spec_reqs, srec)))
        out["crest_healthy"] = crest_serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                               reqs)
        out["crest_detection"] = crest_detection(torch, dev, params, ccfg)
        out["fleet"] = fleet_run(torch, dev, arch, model, params, ccfg)
    elif arch == "recurrentgemma-2b":
        out.update(window_crossing_runs(torch, dev, arch, model, params, ccfg))
    elif arch == "olmoe-1b-7b":
        out["dense_shared_prefix"], out["paged_prefix_cache"] = prefix_pair(
            torch, dev, arch, model, params, ccfg, shared_prefix_prompts(cfg.vocab),
            "shared_prefix", PREFIX_LEN)
    return out


def window_crossing_runs(torch, dev, arch, model, params, ccfg):
    """Griffin's streams across the window: CROSS_REQ prompts of CROSS_LEN
    tokens (64 admission chunks of 32 through the 2,048-row ring, which
    wraps), MAX_NEW new tokens each at positions past 2,048, served fused
    and, on the same weights, unfused (every wrapper's plain version: the
    reference's arithmetic on the card; admitted in chunks of
    CROSS_REF_CHUNK, other chunk boundaries). The fused streams must equal the
    unfused ones but where the unfused run's top-2 margin is within twice
    the path's bf16-step limit; each departure is reported with its index
    and margin."""
    import numpy as np
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, CROSS_LEN).astype(np.int32)
               for _ in range(CROSS_REQ)]
    ref, eng, ref_reqs, ref_rec = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                            "cross_window_unfused", margins=True, fused=False,
                                            prefill_chunk=CROSS_REF_CHUNK)
    del eng
    run, eng, reqs, _ = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                  "cross_window")
    del eng
    margin_limit = 2 * PARITY_LIMITS[arch][1]
    departures = []
    for a, b in zip(ref_reqs, reqs):
        j = first_departure(a, b)
        if j is None:
            continue
        m, steps = top2_margin(ref_rec["top2"][(a.uid, j)])
        d = {"uid": a.uid, "index": j, "unfused": a.tokens_out[j], "fused": b.tokens_out[j],
             "unfused_margin": m, "margin_bf16_steps": steps}
        departures.append(d)
        if steps > margin_limit:
            fail(f"serve ({arch}, cross_window): the fused stream departs from the unfused one "
                 f"where its margin is {steps:.2f} bf16 steps (limit {margin_limit}): {d}")
    run.update({"requests": CROSS_REQ, "prompt_len": CROSS_LEN,
                "last_position": CROSS_LEN + MAX_NEW - 1, "window": model.cfg.window,
                "streams_equal_unfused": not departures, "departures": departures,
                "margin_limit_bf16_steps": margin_limit})
    return {"cross_window_unfused": ref, "cross_window": run}


def crest_serve_run(torch, dev, arch, model, params, ccfg, prompts, plain_reqs):
    """A healthy serve run with CREST probe waves every 4 steps on the dense
    f32 lm_head: its streams must equal the CREST-off run's token for token
    and it must confirm no fault. A probe's cost: its device time (CUDA-graph
    replays of ``crest_matmul`` on the engine's weight and state: no host
    gaps) per probe and amortised per step, and its wall time (CUDA events
    over eager probes back to back, which the host's launches bound)."""
    from repro_torch.core import crest
    run, eng, reqs, _ = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                  "crest_healthy", crest_enabled=True, crest_every=4)
    rep = eng.crest_report()
    if [r.tokens_out for r in reqs] != [r.tokens_out for r in plain_reqs]:
        fail(f"serve ({arch}, crest_healthy): the streams differ from the CREST-off run's")
    if rep["confirmed_faults"] != 0:
        fail(f"serve ({arch}, crest_healthy): false positives on healthy weights: {rep}")
    probes = int(eng.crest_state.cursor) // eng.scfg.crest_cfg.n_spares
    n = 20
    for _ in range(3):
        eng._crest_probe()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        eng._crest_probe()
    t1.record()
    t1.synchronize()
    probe_wall_ms = t0.elapsed_time(t1) / n
    x = torch.randn((4, eng._probe_w.shape[0]), device=dev)
    probe_ms = graph_ms(torch, lambda: crest.crest_matmul(x, eng._probe_w, eng.crest_state,
                                                           eng.scfg.crest_cfg), [()], 20)
    run.update({"crest_report": rep, "probes_in_run": probes,
                "probe_weight_gb": eng._probe_w.numel() * 4 / 1e9,
                "probe_device_ms": probe_ms,
                "probe_device_ms_per_step": probe_ms / eng.scfg.crest_every,
                "probe_wall_ms": probe_wall_ms, "streams_equal_crest_off": True})
    del eng
    return run


def crest_detection(torch, dev, params, ccfg):
    """CREST on codeqwen's dense f32 lm_head (its first CREST_COLUMNS
    columns) through ``crest_matmul`` calls: CREST_FAULTS injected columns,
    the reference's defaults (16 spares, threshold 3), CREST_CYCLES full
    cursor cycles on random (4, K) inputs.
    Detected must equal injected, with no false positive and every fault
    repaired, and the repaired output must lie within ``tol`` of the clean
    product (relative, as the compare: |y - y_clean| <= tol (1 + |y_clean|))."""
    from repro_torch.core import cascade, crest

    w = cascade.linear_weight(params["lm_head"], ccfg)[:, :CREST_COLUMNS].to(torch.float32)
    k, n = w.shape
    cfg = crest.CrestConfig()
    gen = torch.Generator(device=dev).manual_seed(7)
    fault = crest.inject_column_faults(gen, n, CREST_FAULTS)
    state = crest.crest_init(n, cfg, device=dev)
    probes = CREST_CYCLES * -(-n // cfg.n_spares)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(probes):
        x = torch.randn((4, k), generator=gen, device=dev)
        _, state = crest.crest_matmul(x, w, state, cfg, fault)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    stats = crest.coverage_stats(state, fault)
    x = torch.randn((4, k), generator=gen, device=dev)
    y, _ = crest.crest_matmul(x, w, state, cfg, fault)
    with crest.full_f32_matmul():
        clean = torch.matmul(x, w)
    rel = float(((y - clean).abs() / (1.0 + clean.abs())).max())
    out = {"columns": n, "lm_head_columns": int(params["lm_head"]["codes"].shape[1]), "K": k, "n_spares": cfg.n_spares, "threshold": cfg.threshold,
           "tol": cfg.tol, "cycles": CREST_CYCLES, "probes": probes, "wall_s": wall,
           "faulty_columns": fault.nonzero().flatten().tolist(), **stats,
           "repaired_output_max_rel_err": rel}
    if not (stats["detected"] == CREST_FAULTS and stats["false_positives"] == 0
            and stats["repaired"] == CREST_FAULTS and rel <= cfg.tol):
        fail(f"CREST detection on the lm_head: {out}")
    del w
    return out


def top2_margin(top):
    """(top-1 minus top-2 logit, that margin in bf16 steps of max|logit|)."""
    top1, top2, absmax = (float(x) for x in top)
    return top1 - top2, (top1 - top2) / bf16_step(absmax)


def first_departure(ref, req):
    """The first token index where ``req``'s stream differs from ``ref``'s."""
    return next((i for i, (a, b) in enumerate(zip(ref.tokens_out, req.tokens_out)) if a != b),
                None)


def shared_prefix_prompts(vocab: int, prefix_len: int = PREFIX_LEN,
                          prompt_len: int = PROMPT_LEN, n: int = N_REQ):
    """``n`` prompts of ``prompt_len`` tokens: one shared ``prefix_len``-token
    prefix (a system prompt, or a code file's head) and unique tokens after
    it."""
    import numpy as np
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, prompt_len - prefix_len)
                            .astype(np.int32)]) for _ in range(n)]


def equal_streams(arch, kind, ref, reqs):
    """Every stream of ``reqs`` equals the dense run's (``ref``: its requests
    and instrumented record), or the smoke fails with the first departing
    token and the dense run's top-2 margin there."""
    ref_reqs, ref_rec = ref
    for a, b in zip(ref_reqs, reqs):
        j = first_departure(a, b)
        if j is not None:
            m, steps = top2_margin(ref_rec["top2"][(a.uid, j)])
            fail(f"serve ({arch}, {kind}): request {a.uid}'s paged stream departs from the "
                 f"dense engine's at token {j} ({b.tokens_out[j]} for {a.tokens_out[j]}), "
                 f"where the dense run's top-2 margin is {steps:.2f} bf16 steps ({m})")
    return True


def prefix_pair(torch, dev, arch, model, params, ccfg, prompts, kind, prefix_len, **opts):
    """The dense engine and the prefix-cached paged engine on one set of
    shared-prefix prompts: streams equal token for token, and the hit rate
    of every later prompt mapping the prefix's full pages; each run's
    flash-attention launches that split over the keys."""
    with recorded_flash_plans() as dplans:
        dense, eng, dreqs, drec = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                            f"dense_{kind}", margins=True, **opts)
    del eng
    with recorded_flash_plans() as pplans:
        run, eng, preqs, _ = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                       f"paged_{kind}", prefix_cache=True, page_size=PAGE_SIZE,
                                       **opts)
    del eng
    run["streams_equal_dense"] = equal_streams(arch, f"paged_{kind}", (dreqs, drec), preqs)
    hit = (len(prompts) - 1) * (prefix_len // PAGE_SIZE * PAGE_SIZE) \
        / sum(len(p) for p in prompts)
    run.update({"prefix_len": prefix_len, "prompt_len": len(prompts[0]),
                "expected_hit_rate": hit})
    for rec, plans in ((dense, dplans), (run, pplans)):
        rec["flash_split_launches"] = sum(1 for _, n in plans if n > 1)
    if not run["prefix_hit_rate"] >= hit - 1e-12:
        fail(f"serve ({arch}, paged_{kind}): prefix hit rate {run['prefix_hit_rate']}, "
             f"expected {hit}")
    return dense, run


def paged_runs(torch, dev, arch, model, params, ccfg, random_prompts, plain_ref, rep, spec_ref):
    """The paged KV pool and the radix prefix cache on the served model, each
    run's streams held to a dense run's token for token (a departure fails,
    reported with its first index and the dense run's top-2 margin):
    (a) ``paged`` on the plain run's random prompts, with one 8-slot paged
    decode step profiled; (b) ``prefix_cache`` on shared-prefix prompts,
    beside the dense engine on them (prefix hit rate >= 0.5; TTFT and the
    admission chunks and prompt tokens spent on both); (c) ``prefix_cache``
    on the random prompts, whose default pool (max_batch * blocks + 1 pages)
    must evict; (d) ``paged`` speculative greedy on the repetitive prompts,
    against the dense speculative run; (e) as (b) on SHORT_REQ prompts of PROMPT_E
    tokens sharing PREFIX_E (not a multiple of the chunk), whose admission
    after a hit runs chunks past 256 live keys, where flash attention splits."""
    from repro_torch.serve.engine import Request

    out = {}
    run, eng, reqs, _ = serve_run(torch, dev, arch, model, params, ccfg, random_prompts,
                                  "paged", paged=True, page_size=PAGE_SIZE)
    run["streams_equal_dense"] = equal_streams(arch, "paged", plain_ref, reqs)
    # as after the plain run: fill every slot, then profile a pure 8-slot step
    for i in range(MAX_BATCH):
        eng.submit(Request(uid=N_REQ + i, prompt=reqs[i].prompt, max_new_tokens=4))
    eng.step()
    run["profiled_decode_step"] = profile_step(torch, eng)
    eng.run_until_drained()
    del eng
    out["paged"] = run

    out["dense_shared_prefix"], out["paged_prefix_cache"] = prefix_pair(
        torch, dev, arch, model, params, ccfg, shared_prefix_prompts(model.cfg.vocab),
        "shared_prefix", PREFIX_LEN)

    run, eng, ereqs, _ = serve_run(torch, dev, arch, model, params, ccfg, random_prompts,
                                 "paged_prefix_evict", prefix_cache=True, page_size=PAGE_SIZE)
    del eng
    run["streams_equal_dense"] = equal_streams(arch, "paged_prefix_evict", plain_ref, ereqs)
    if not run["evictions"] > 0:
        fail(f"serve ({arch}, paged_prefix_evict): the default pool never evicted: {run}")
    out["paged_prefix_evict"] = run

    run, eng, sreqs, _ = serve_run(torch, dev, arch, model, params, ccfg, rep, "paged_spec",
                                 paged=True, page_size=PAGE_SIZE, draft_len=DRAFT_LEN)
    del eng
    run["streams_equal_dense"] = equal_streams(arch, "paged_spec", spec_ref, sreqs)
    out["paged_spec"] = run

    out["dense_prefix_off_chunk"], out["paged_prefix_off_chunk"] = prefix_pair(
        torch, dev, arch, model, params, ccfg,
        shared_prefix_prompts(model.cfg.vocab, PREFIX_E, PROMPT_E, SHORT_REQ),
        "prefix_off_chunk",
        PREFIX_E, max_len=PROMPT_E + MAX_NEW + 1)
    if not out["paged_prefix_off_chunk"]["flash_split_launches"] > 0:
        fail(f"serve ({arch}, paged_prefix_off_chunk): no admission chunk split flash "
             f"attention: {out['paged_prefix_off_chunk']}")
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


def stub_inputs(torch, dev, cfg, seed: int):
    """Seeded stub-frontend inputs for STUB_ROWS rows: embeddings (rows,
    STUB_LEN + STUB_DECODES, d) f32 and, for M-RoPE, (3, rows, same) int32
    positions: a t = 1 image of STUB_GRID x STUB_GRID patches at its (t, h,
    w) positions, then text from the grid's largest position + 1 in all
    three streams, as Qwen2-VL numbers them."""
    n = STUB_LEN + STUB_DECODES
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((STUB_ROWS, n, cfg.d_model), generator=gen, device=dev)
    if not cfg.mrope_sections:
        return emb, None
    g = STUB_GRID
    hh, ww = torch.meshgrid(torch.arange(g), torch.arange(g), indexing="ij")
    img = torch.stack([torch.zeros(g * g, dtype=torch.int64), hh.flatten(), ww.flatten()])
    text = (img.max() + 1 + torch.arange(n - g * g))[None].expand(3, n - g * g)
    pos = torch.cat([img, text], dim=1)[:, None].expand(3, STUB_ROWS, n)
    return emb, pos.to(device=dev, dtype=torch.int32).contiguous()


def stub_batch(emb, pos, lo: int, hi: int) -> dict:
    """Columns lo:hi of the stub inputs as a model batch: M-RoPE positions,
    or (no RoPE: musicgen) the sinusoid's ``pos_offset``."""
    batch = {"inputs_embeds": emb[:, lo:hi]}
    if pos is not None:
        batch["positions"] = pos[:, :, lo:hi]
    else:
        batch["pos_offset"] = lo
    return batch


def stub_parity_phase(torch, dev, arch: str):
    """Depth-2 parity of a modality-stub backbone at full width: a
    STUB_LEN-token prefill of stub embeddings (qwen2-vl: the image's M-RoPE
    positions, then text) and one decode step (musicgen: ``pos_offset``),
    through the kernels and through their plain versions on the card, as
    ``parity_phase`` holds the served paths (a prefill here, not an
    admission chunk: an M-RoPE config cannot extend, as in the reference)."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config(arch), n_layers=2)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(3, ccfg, device=dev)
    emb, pos = stub_inputs(torch, dev, cfg, 4)
    out = {}
    with torch.no_grad():
        for name, route in (("plain", plain_versions_on_card), ("kernel", contextlib.nullcontext)):
            ops.reset_launch_counts()
            with route():
                l1, cache = model.prefill(params, stub_batch(emb, pos, 0, STUB_LEN), ccfg,
                                          max_len=STUB_LEN + STUB_DECODES)
                l2, _ = model.decode_step(params, stub_batch(emb, pos, STUB_LEN, STUB_LEN + 1),
                                          cache, ccfg)
            out[name] = (l1, l2)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["decode_attention"] != cfg.n_layers or launches["flash_attention"] != cfg.n_layers:
        fail(f"depth-2 parity ({arch}): attention launches {launches}, not one flash and one "
             f"decode launch per layer")
    if not all(torch.isfinite(o).all() for o in out["kernel"]):
        fail(f"depth-2 parity ({arch}): kernel logits not finite")
    res = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.resolved_head_dim,
           "codebooks": cfg.n_codebooks, "mrope_sections": list(cfg.mrope_sections),
           "logits_shape": list(out["kernel"][1].shape), "kernel_launches": launches,
           "logit_absmax": float(out["plain"][1].abs().max())}
    parity_readings(torch, res, arch, ("prefill", "decode"), out)
    return res


def check_stub_counts(arch: str, mm: list, atts: list, measured: dict):
    """The kernels line's per-step sums for a modality-stub backbone scale
    per-call times by fixed counts (STUB_MATMUL, STUB_ATTN): each must equal
    the launches the model-level run's decode step made. (No norm count
    enters the line for these configs.)"""
    want = {"cascade_matmul": sum(r["launches_per_decode_step"] for r in mm if r["arch"] == arch),
            "decode_attention": sum(r["launches_per_decode_step"] for r in atts
                                    if STUB_ATTN.get(r["case"], ("",))[0] == arch)}
    got = {k: measured["launches_per_decode_step"].get(k, 0) for k in want}
    if got != want:
        fail(f"model level ({arch}): a decode step launched {got}, where the kernels line "
             f"counts {want}")


def stub_model_phase(torch, dev, arch: str):
    """A modality-stub backbone at full width and depth, at the model level
    (the engine takes token prompts; the reference's cannot serve these
    configs either): STUB_ROWS rows through a STUB_LEN-token ``prefill`` of
    seeded stub embeddings, then STUB_DECODES ``decode_step``s, each fed the
    next seeded embedding with its positions (qwen2-vl) or ``pos_offset``
    (musicgen) advanced. Every logit must be finite, of the config's shape
    (musicgen's (8, 1, 4, 2048)), and every kernel of the path launched in
    the run (counts reset just before, read just after). Reports each
    step's host-clock ms (synchronized), one decode step profiled, and the
    peak memory."""
    import numpy as np
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    cfg, model = registry.load(arch)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    t0 = time.monotonic()
    params = model.init_params(0, ccfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    emb, pos = stub_inputs(torch, dev, cfg, 5)
    want = ((STUB_ROWS, 1, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks
            else (STUB_ROWS, 1, cfg.vocab))
    finite, shapes, step_ms = [], set(), []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with torch.no_grad():
        t0 = time.monotonic()
        logits, cache = model.prefill(params, stub_batch(emb, pos, 0, STUB_LEN), ccfg,
                                      max_len=STUB_LEN + STUB_DECODES)
        finite.append(torch.isfinite(logits).all())
        shapes.add(tuple(logits.shape))
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        per_step = {}
        for i in range(STUB_LEN, STUB_LEN + STUB_DECODES - 1):
            before = dict(ops.LAUNCHES)
            t0 = time.monotonic()
            logits, cache = model.decode_step(params, stub_batch(emb, pos, i, i + 1), cache, ccfg)
            finite.append(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            shapes.add(tuple(logits.shape))
            per_step = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the last decode step, profiled (not timed: the profiler slows the host)
        i = STUB_LEN + STUB_DECODES - 1
        profiled = profile_call(torch, lambda: model.decode_step(
            params, stub_batch(emb, pos, i, i + 1), cache, ccfg)[0].shape[0])
    if not bool(torch.stack(finite).all()):
        fail(f"model level ({arch}): non-finite logits")
    if shapes != {want}:
        fail(f"model level ({arch}): logits of shapes {shapes}, expected {want}")
    if not all(launches[k] > 0 for k in RUN_KERNELS[(arch, "model")]):
        fail(f"model level ({arch}): a kernel of the path never launched: {launches}")
    return {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.resolved_head_dim,
            "codebooks": cfg.n_codebooks, "rows": STUB_ROWS, "prefill_len": STUB_LEN,
            "decode_steps": STUB_DECODES, "logits_shape": list(want), "init_s": init_s,
            "prefill_ms": prefill_ms, "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p99": float(np.percentile(step_ms, 99)), "launches": launches,
            "launches_per_decode_step": per_step, "peak_mem_gb": peak,
            "profiled_decode_step": profiled}


def slotwise_run(torch, dev, model, params, ccfg, prompts, fused: bool):
    """One run of the slot-wise loop (``batched=False``, speculation and
    pages asked for): the prompts, each with as many new tokens, launch
    counts reset just before and read just after. Every logit the loop
    picks from is checked finite, and the top-2 logits and max|logit| of
    the row behind each committed token are kept by (request, token index):
    the loop calls ``prefill`` or ``decode_step`` at B = 1 and commits from
    that call's last row."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    n = len(prompts[0])
    scfg = ServeConfig(max_batch=MAX_BATCH, max_len=2 * n + 1, batched=False, fused=fused,
                       draft_len=DRAFT_LEN, paged=True)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        eng = ServeEngine(model, params, ccfg, scfg, device=dev)
    rec = {"finite": [], "top2": {}, "warnings": len(warned)}
    last = {}
    for name in ("prefill", "decode_step"):
        fn = getattr(model, name)

        def call(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            row = out[0][0, -1]
            rec["finite"].append(torch.isfinite(out[0]).all())
            last["top2"] = torch.cat([torch.topk(row, 2).values, row.abs().amax()[None]])
            return out
        setattr(model, name, call)
    commit = eng._commit_token

    def record(req, tok):
        rec["top2"][(req.uid, len(req.tokens_out))] = last["top2"]
        commit(req, tok)
    eng._commit_token = record
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n) for i, p in enumerate(prompts)]
    try:
        ops.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        rec["wall_s"] = time.monotonic() - t0
        rec["launches"] = dict(ops.LAUNCHES)
    finally:
        for name in ("prefill", "decode_step"):
            model.__dict__.pop(name, None)
    return eng, reqs, rec


def slotwise_phase(torch, dev):
    """The slot-wise loop on the card: codeqwen1.5-7b cut to SLOT_DEPTH
    layers at full width, ``batched=False`` with speculation, fused kernels
    and pages asked for, SLOT_REQ requests. Speculation and pages must
    downgrade with their warnings, listed in ``metrics()["downgrades"]``;
    fused does not: the loop runs ``prefill`` and ``decode_step`` through
    the kernels (mode ``slotwise-greedy-fused``), and every kernel of
    codeqwen's path must launch in the run. The same requests then run the
    loop unfused (no launch), and each kernel stream must equal its unfused
    stream but where the unfused run's top-2 margin is within twice the
    path's bf16-step limit (each such departure counted). Every request
    must end with its tokens and let go of its cache, and every logit must
    be finite."""
    import numpy as np
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry

    arch = "codeqwen1.5-7b"
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=SLOT_DEPTH)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    params = model.init_params(0, ccfg, device=dev)
    n = PROMPT_LEN // 4
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for _ in range(SLOT_REQ)]
    runs = {fused: slotwise_run(torch, dev, model, params, ccfg, prompts, fused)
            for fused in (True, False)}
    eng, reqs, rec = runs[True]
    _, plain_reqs, plain_rec = runs[False]
    m = eng.metrics()
    want = ("speculat", "paged")
    res = {"arch": arch, "layers": SLOT_DEPTH, "requests": SLOT_REQ, "prompt_len": n,
           "max_new": n, "effective_mode": m["effective_mode"], "downgrades": m["downgrades"],
           "warnings": rec["warnings"], "launches": rec["launches"],
           "unfused_mode": runs[False][0].effective_mode,
           "unfused_launches": plain_rec["launches"], "wall_s": rec["wall_s"],
           "unfused_wall_s": plain_rec["wall_s"], "step_ms_p50": m["step_time_p50_s"] * 1e3,
           "decode_tokens_per_s": m["tokens_per_s"], "first_tokens": reqs[0].tokens_out[:8]}
    if not (m["effective_mode"] == "slotwise-greedy-fused" and len(m["downgrades"]) == len(want)
            and all(any(k in d for d in m["downgrades"]) for k in want)
            and rec["warnings"] == len(want)):
        fail(f"slot-wise loop: the downgrades are not speculation and pages alone: {res}")
    if not all(rec["launches"][k] > 0 for k in RUN_KERNELS[(arch, "plain")]):
        fail(f"slot-wise loop: a kernel of the path never launched: {res}")
    if res["unfused_mode"] != "slotwise-greedy" or any(plain_rec["launches"].values()):
        fail(f"slot-wise loop: the unfused run launched a kernel: {res}")
    if not bool(torch.stack(rec["finite"] + plain_rec["finite"]).all()):
        fail("slot-wise loop: non-finite logits")
    for e, rs in ((eng, reqs), (runs[False][0], plain_reqs)):
        if not all(r.done and len(r.tokens_out) == n for r in rs) or any(e.caches):
            fail(f"slot-wise loop: not every request ended with {n} tokens and let go of its "
                 f"cache: {[len(r.tokens_out) for r in rs]}")
    margin_limit = 2 * PARITY_LIMITS[arch][1]
    departures = []
    for pr, r in zip(plain_reqs, reqs):
        j = first_departure(pr, r)
        if j is None:
            continue
        mg, steps = top2_margin(plain_rec["top2"][(pr.uid, j)])
        d = {"uid": r.uid, "index": j, "unfused": pr.tokens_out[j], "fused": r.tokens_out[j],
             "unfused_margin": mg, "margin_bf16_steps": steps}
        departures.append(d)
        if steps > margin_limit:
            fail(f"slot-wise loop: a kernel stream departs from the unfused one where the "
                 f"margin is {steps:.2f} bf16 steps (limit {margin_limit}): {d}")
    res.update({"streams_equal_unfused": len(reqs) - len(departures), "departures": departures,
                "margin_limit_bf16_steps": margin_limit})
    return res


def fleet_run(torch, dev, arch, model, params, ccfg):
    """The --traffic path on the card: FLEET_REPLICAS replicas of the full
    model sharing one params tree (``launch.serve.fleet``), fused, under the
    SLO-aware router, on a seeded Poisson trace (``launch.serve.
    traffic_config``), replica 0 failed FLEET_KILL_S into it, on the wall
    clock. Every request must finish with its ``max_new_tokens`` (none shed
    or rejected), replica 0 must hold nothing at the end, at least one
    stream must have been rebuilt on the survivor (``prompt_carried`` > 0),
    and each rebuilt greedy stream must equal the same request served alone
    by one engine on the same weights, but where that run's top-2 margin is
    within twice the path's bf16-step limit (each such departure counted).
    TTFT and inter-token percentiles are measurements, not limits."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fleet, traffic_config
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.traffic import poisson_trace

    t_phase = time.monotonic()
    scfg = ServeConfig(max_batch=MAX_BATCH, max_len=PROMPT_LEN + MAX_NEW + 1,
                       prefill_chunk=CHUNK, fused=True)
    router = fleet(model, params, ccfg, scfg, FLEET_REPLICAS, dev)
    trace = poisson_trace(traffic_config(model.cfg.vocab, FLEET_REQ, FLEET_RATE, PROMPT_LEN,
                                         MAX_NEW, FLEET_SLO_S, 0.0))
    prompts = {a.request.uid: a.request.prompt.copy() for a in trace}
    engines = router.replicas.engines
    with instrumented(torch, engines[0], margins=False) as rec:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        recs = router.run_trace(trace, kills=[(FLEET_KILL_S, 0)])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    m = router.metrics()
    rebuilt = [r for r in recs if r.prompt_carried > 0]
    res = {"arch": arch, "replicas": FLEET_REPLICAS, "max_batch": MAX_BATCH,
           "requests": FLEET_REQ, "rate_rps": FLEET_RATE, "slo_ttft_s": FLEET_SLO_S,
           "kill_at_s": FLEET_KILL_S, "prompt_lens": [PROMPT_LEN // 2, PROMPT_LEN],
           "output_lens": [MAX_NEW // 2, MAX_NEW], "wall_s": wall, "peak_mem_gb": peak,
           "effective_mode": engines[1].effective_mode, "launches": launches,
           "rebuilt_streams": len(rebuilt), "failover_clones": len(router.replicas.requeued),
           "tokens_carried": sum(r.prompt_carried for r in rebuilt),
           **{k: m[k] for k in ("ttft_p50_s", "ttft_p99_s", "inter_token_p50_s",
                                "inter_token_p99_s", "slo_attainment", "replicas_alive",
                                "requests_offered", "requests_finished", "requests_shed",
                                "requests_rejected")},
           "replica_steps": [h.steps for h in router.replicas.health],
           "replica_step_ewma_ms": [h.ewma_ms for h in router.replicas.health],
           "served_by_replica": [len(e._retired) for e in engines]}
    if not (m["requests_shed"] == 0 and m["requests_rejected"] == 0 and len(recs) == FLEET_REQ
            and all(r.done and len(r.tokens_out) == r.max_new_tokens for r in recs)):
        fail(f"fleet: a request did not finish with its tokens: {res}")
    if engines[0]._active() or engines[0]._staging is not None or engines[0].queue \
            or m["replicas_alive"] != FLEET_REPLICAS - 1:
        fail(f"fleet: the killed replica still holds work: {res}")
    if not rebuilt:
        fail(f"fleet: no stream was rebuilt on the survivor: {res}")
    if not bool(torch.stack(rec["finite"]).all()):
        fail("fleet: non-finite logits")
    if not all(launches[k] > 0 for k in RUN_KERNELS[(arch, "plain")]):
        fail(f"fleet: a kernel of the path never launched: {launches}")
    # each rebuilt stream against the same request served alone on one engine
    margin_limit = 2 * PARITY_LIMITS[arch][1]
    departures = []
    for r in rebuilt:
        _, eng, (alone,), arec = serve_run(torch, dev, arch, model, params, ccfg,
                                           [prompts[r.uid]], f"fleet_alone_{r.uid}",
                                           margins=True, max_new=r.max_new_tokens)
        del eng
        j = first_departure(alone, r)
        if j is None:
            continue
        mg, steps = top2_margin(arec["top2"][(alone.uid, j)])
        d = {"uid": r.uid, "index": j, "carried": r.prompt_carried, "alone": alone.tokens_out[j],
             "fleet": r.tokens_out[j], "alone_margin": mg, "margin_bf16_steps": steps}
        departures.append(d)
        if steps > margin_limit:
            fail(f"fleet: a rebuilt stream departs from the request served alone where the "
                 f"margin is {steps:.2f} bf16 steps (limit {margin_limit}): {d}")
    res.update({"rebuilt_equal_alone": len(rebuilt) - len(departures),
                "departures": departures, "margin_limit_bf16_steps": margin_limit,
                "phase_s": time.monotonic() - t_phase})
    return res


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
    grp = timed("cascade_matmul_grouped", grouped_matmul_phase)
    print(json.dumps({"cascade_matmul_grouped": grp}), flush=True)
    atts = timed("decode_attention", attention_phase)
    att = atts[0]
    from repro_torch.kernels import decode_attention as da
    att_geometry = da.geometry()
    print(json.dumps({"decode_attention": atts, "geometry": att_geometry}), flush=True)
    fla = timed("flash_attention", flash_phase)
    from repro_torch.kernels import flash_attention as fa
    fla_geometry = fa.geometry()
    print(json.dumps({"flash_attention": fla, "geometry": fla_geometry}), flush=True)
    fla_local = timed("flash_attention local", local_flash_phase)
    print(json.dumps({"flash_attention_local": fla_local}), flush=True)
    ring = timed("decode_attention ring", ring_decode_phase)
    print(json.dumps({"decode_attention_ring": ring}), flush=True)
    nrm = timed("norm", norm_phase)
    nrm_fused = timed("norm fused", fused_norm_phase)
    print(json.dumps({"norm": nrm, "norm_fused": nrm_fused}), flush=True)
    ssd = timed("ssd_scan", ssd_phase)
    print(json.dumps({"ssd_scan": ssd}), flush=True)
    pool = timed("paged pool", paged_pool_phase)
    print(json.dumps({"paged_pool": pool}), flush=True)
    par, srv = {}, {}
    for arch in PARITY_ARCHS:
        par[arch] = timed(f"parity {arch}", parity_phase, arch)
        print(json.dumps({"parity_depth2": par[arch]}), flush=True)
    for arch in STUB_ARCHS:
        par[arch] = timed(f"parity {arch}", stub_parity_phase, arch)
        print(json.dumps({"parity_depth2": par[arch]}), flush=True)
    par_failed = [a for a, r in par.items() if not r["within_limits"]]
    stub = {}
    for arch in STUB_ARCHS:
        stub[arch] = timed(f"model level {arch}", stub_model_phase, arch)
        print(json.dumps({"model_level": stub[arch]}), flush=True)
        check_stub_counts(arch, mm, atts, stub[arch])
    slot = timed("slot-wise loop", slotwise_phase)
    print(json.dumps({"slotwise": slot}), flush=True)
    crest_det = None
    for arch in ARCHS:
        srv[arch] = timed(f"serve {arch}", serve_phase, arch)
        crest_det = srv[arch].pop("crest_detection", crest_det)
        for run in srv[arch].values():
            print(json.dumps({"serve": run}), flush=True)
    print(json.dumps({"crest_detection": crest_det}), flush=True)
    fleet = srv[ARCHS[0]]["fleet"]
    phase_s[f"fleet (inside serve {ARCHS[0]})"] = fleet["phase_s"]
    print(json.dumps({"fleet_summary": {
        "gpu": gpu_name_and_power(), **{k: fleet[k] for k in (
            "replicas", "requests", "rate_rps", "kill_at_s", "ttft_p50_s", "ttft_p99_s",
            "inter_token_p50_s", "inter_token_p99_s", "slo_attainment", "replicas_alive",
            "wall_s", "rebuilt_streams", "rebuilt_equal_alone", "departures")}}}), flush=True)

    def step_summary(prof):
        return {"device_busy_ms": prof["device_busy_ms"], "device_kernels": prof["device_kernels"],
                "kv_rows": prof["kv_rows"]}
    paged_vs_dense = {"dense": step_summary(srv[ARCHS[0]]["plain"]["profiled_decode_step"]),
                      "paged": step_summary(srv[ARCHS[0]]["paged"]["profiled_decode_step"]),
                      "pool_ops_per_step_ms": pool["per_step_ms"]}
    print(json.dumps({"paged_decode_step_vs_dense": paged_vs_dense}), flush=True)
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
                for kind, rec in srv[arch].items() if "launches" in rec}

    def model_level(name):
        """Launches in each model-level run of a modality-stub backbone."""
        return {arch: stub[arch]["launches"][name] for arch in STUB_ARCHS}

    cq, mb, om, rg = ARCHS
    fv = next(r for r in fla if r["case"] == "verify")

    def grouped_step(key):
        return sum(r[key] * r["launches_per_decode_step"] for r in grp)

    # olmoe's decode and verify steps profiled, and each kernel of its decode
    # step against its bound (per-call times at the step's shapes, summed)
    oa = next(r for r in atts if r["case"] == "olmoe_step")
    on = next(r for r in nrm_fused if r["case"] == "olmoe_step_add")
    moe_step = {kind: {k: srv[om][run][prof][k] for k in ("device_busy_ms", "device_kernels",
                                                          "our_kernels", "routing_ops")}
                for kind, run, prof in (("decode", "plain", "profiled_decode_step"),
                                        ("verify", "spec", "profiled_verify_step"))}
    moe_step["decode_kernels_vs_bound"] = {
        "cascade_matmul_grouped": {"launches": 48, "ms": grouped_step("ms"),
                                   "bound_ms": grouped_step("bound_ms")},
        "cascade_matmul": {"launches": sum(n for (a, *_), n in MATMUL_LAYERS.items() if a == om),
                           "ms": per_step(om, "ms"), "bound_ms": per_step(om, "bound_ms")},
        "decode_attention": {"launches": 16, "ms": 16 * oa["ms"], "bound_ms": 16 * oa["bound_ms"]},
        "norm": {"launches": 33, "ms": 33 * on["ms"], "bound_ms": 33 * on["bound_ms"],
                 "note": "32 add-norms at 8 x 2048 and the final norm, timed as add-norms"}}
    print(json.dumps({"olmoe_profiled_steps": moe_step}), flush=True)
    # recurrentgemma-2b's served steps: device busy against the host step,
    # launches a step per kernel, TTFT and peak memory per run; CREST's cost
    griffin = {run: {k: srv[rg][run].get(k) for k in (
        "step_ms_p50", "step_ms_p99", "decode_tokens_per_s", "ttft_s_p50", "ttft_s_max",
        "peak_mem_gb", "launches_per_decode_step", "accepted_per_step", "streams_equal_plain",
        "streams_equal_unfused", "departures", "divergences")}
        for run in ("plain", "spec", "cross_window")}
    griffin["profiled_decode_step"] = {k: srv[rg]["plain"]["profiled_decode_step"][k] for k in (
        "device_busy_ms", "device_kernels", "our_kernels")}
    griffin["profiled_verify_step"] = {k: srv[rg]["spec"]["profiled_verify_step"][k] for k in (
        "device_busy_ms", "device_kernels", "our_kernels", "kv_rows")}
    griffin["crest"] = {"healthy": {k: srv[cq]["crest_healthy"][k] for k in (
        "crest_report", "probes_in_run", "probe_weight_gb", "probe_device_ms",
        "probe_device_ms_per_step", "probe_wall_ms", "streams_equal_crest_off",
        "step_ms_p50")}, "detection": crest_det}
    print(json.dumps({"griffin_and_crest": griffin}), flush=True)
    nq = next(r for r in nrm_fused if r["case"] == "codeqwen_step_add")
    gn = {r["case"]: r for r in nrm + nrm_fused if r["case"].startswith("griffin_")}

    def griffin_norms(shape, run):
        """recurrentgemma-2b's norms in one served step: its first block's
        plain norm and an add-norm for every other (and the final norm),
        each timed at the step's shape, summed over the step's launches."""
        n = srv[rg][run]["launches_per_decode_step"]["norm"]
        one, add = gn[f"griffin_{shape}"], gn[f"griffin_{shape}_add"]
        return {"launches": n, **{k: one[k] + (n - 1) * add[k]
                                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
    kernels = [
        {"name": "cascade_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cascade_matmul.cu",
         "replaces": "src/repro/kernels/cascade_matmul.py:98",
         "shape": "one codeqwen decode step at M=8: 32 x [(4096,4096)x4, (4096,13440)x2, "
                  "(13440,4096)] + lm_head (4096,92416); times are summed over its launches "
                  "(mamba2-370m's step: 48 x [(1024,4384), (2048,1024)], under mamba2_370m_step; "
                  "olmoe-1b-7b's: 64 x (2048,2048) + lm_head (2048,50304), under "
                  "olmoe_1b_7b_step)",
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
         "olmoe_1b_7b_step": {key: per_step(om, key)
                              for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "recurrentgemma_2b_step": {key: per_step(rg, key)
                                    for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
         **{f"{a.replace('-', '_').replace('.', '_')}_step": {
             key: per_step(a, key) for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for a in STUB_ARCHS},
         "launches_model_level": model_level("cascade_matmul"),
         "launches_per_model_level_decode_step": {
             a: stub[a]["launches_per_decode_step"]["cascade_matmul"] for a in STUB_ARCHS},
         "verify_step_m40": {a: verify_step(a) for a in (cq, mb, rg)},
         "geometry": mm_geometry,
         "rows_equal_across_m": all(r["rows_equal"] for r in mm_rows),
         "cascade_matmul_shapes": {f"{r['arch']} {r['M']}x{r['K']}->{r['N']}": {k: r[k] for k in (
             "m_tiles", "grid", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err")} for r in mm}},
        {"name": "cascade_matmul_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cascade_matmul.cu",
         "replaces": "no TPU kernel: the reference's expert_linear_apply, "
                     "src/repro/core/cascade.py:154 (an XLA einsum after dequantizing every "
                     "expert)",
         "shape": "one olmoe-1b-7b decode step: 16 x [(64 experts x C=8, 2048->1024) x 2, "
                  "(64 x 8, 1024->2048)], rows routed top-8; times are summed over its 48 "
                  "launches (every shape under grouped_shapes)",
         "launches": srv[om]["plain"]["launches"]["cascade_matmul_grouped"],
         "launches_by_run": by_run("cascade_matmul_grouped"),
         "launches_per_decode_step":
             srv[om]["plain"]["launches_per_decode_step"]["cascade_matmul_grouped"],
         "max_abs_err": max(r["max_abs_err"] for r in grp),
         "tol": "2^-7 * max|plain| + 1e-4 (bf16 out); and bit-equal to per-expert "
                "cascade_matmul calls",
         "equals_per_expert_calls": all(r["equals_per_expert_calls"] for r in grp),
         "ms": grouped_step("ms"), "kernel_ms": grouped_step("ms"),
         "plain_ms": grouped_step("plain_ms"),
         "per_expert_loop_ms": grouped_step("per_expert_loop_ms"),
         "bound_ms": grouped_step("bound_ms"), "bound_by": "bytes",
         "library_ms": grouped_step("library_ms"),
         "library_note": "torch.bmm of bf16 (E, C, K) x dense bf16 (E, K, N) experts",
         "grouped_shapes": {f"{r['arch']} {r['E']}x{r['C']} {r['K']}->{r['N']}": {k: r[k] for k in (
             "experts_with_rows", "ms", "per_expert_loop_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "max_abs_err")} for r in grp}},
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
         "max_abs_err": max(r["max_abs_err"] for r in atts + ring),
         "max_err": max([max(r["max_abs_err"], r["max_abs_err_mask_route"]) for r in atts]
                        + [r["max_abs_err"] for r in ring]),
         "tol": ATTN_ATOL,
         "ms": att["ms"], "kernel_ms": att["ms"], "plain_ms": att["plain_ms"],
         "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
         "library_ms": att["library_ms"],
         "library_note": "scaled_dot_product_attention with the equivalent boolean mask",
         "geometry": att_geometry, "splits": att["splits"],
         "launches_per_griffin_decode_step":
             srv[rg]["plain"]["launches_per_decode_step"]["decode_attention"],
         "launches_model_level": model_level("decode_attention"),
         "decode_attention_shapes": {r["case"]: {k: r[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits", "max_abs_err")}
             for r in atts + ring}},
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
         "max_abs_err": max(r["max_abs_err"] for r in fla + fla_local),
         "max_err_over_tol": max(r["max_err_over_tol"] for r in fla + fla_local),
         "tol": "2^-7 * |plain| + 2^-12 * max|v| (bf16 out)",
         "ms": fv["ms"], "kernel_ms": fv["ms"], "plain_ms": fv["plain_ms"],
         "bound_ms": fv["bound_ms"], "bound_by": fv["bound_by"],
         "library_ms": fv["library_ms"],
         "library_note": "scaled_dot_product_attention with a boolean mask (is_causal at "
                         "offset 0)",
         "geometry": fla_geometry,
         "launches_per_griffin_verify_step":
             srv[rg]["spec"]["launches_per_decode_step"]["flash_attention"],
         "launches_model_level": model_level("flash_attention"),
         "flash_attention_shapes": {r["case"]: {k: r[k] for k in (
             "ms", "ms_one_split", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
             "heads_per_block") if k in r} for r in fla + fla_local},
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
         "recurrentgemma_2b_steps": {"decode": griffin_norms("step", "plain"),
                                     "verify": griffin_norms("verify", "spec")},
         "launches_model_level": model_level("norm"),
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
              "cascade_matmul_rows_across_m": mm_rows, "cascade_matmul_grouped": grp,
              "olmoe_profiled_steps": moe_step,
              "decode_attention": atts, "decode_attention_ring": ring, "flash_attention": fla,
              "flash_attention_local": fla_local, "griffin_and_crest": griffin, "norm": nrm,
              "norm_fused": nrm_fused, "ssd_scan": ssd,
              "parity_depth2": par, "serve": srv, "paged_pool": pool, "model_level": stub,
              "slotwise": slot,
              "paged_decode_step_vs_dense": paged_vs_dense,
              "phase_s": phase_s}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    if par_failed:
        fail(f"depth-2 parity: kernels vs plain versions out of tolerance on {par_failed} "
             f"(the readings are in the parity_depth2 lines above)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
