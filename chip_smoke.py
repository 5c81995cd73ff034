#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

from the root of a checkout. It builds the CUDA kernels from ``src/repro_torch/
kernels/csrc`` with nvcc (sm_90a), all at once, and runs the phases below on
the four served paths, the dense transformer (codeqwen1.5-7b), Mamba-2
(mamba2-370m), the MoE family (olmoe-1b-7b) and Griffin (recurrentgemma-2b),
and on the QAT training path (phi4-mini-3.8b; phase 4); any failure exits
non-zero before the final ``ok`` line is printed.

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
   same rows of a call over 65. The grouped expert matmul runs at olmoe's and
   deepseek-v2's expert shapes with rows routed top-k, one weight stack and
   (olmoe's gate and up) two in one launch, each live row bit-equal to a
   per-expert call and every row past the routed ones an exact zero, each
   shape with its launch plan and the kernel's registers. Decode attention
   runs at three shapes: the served codeqwen step, qwen2.5-32b's GQA heads
   (40 over 8) and a 4096-row cache whose rows are split across blocks. The SSD scan is also held to
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

4. The training side (after the serve runs): the fake-quant kernel at
   phi4-mini-3.8b's weight shapes, codeqwen's 4096 x 13440, a group of 32,
   an olmoe expert stack (one launch) and nemotron4-15b's down projection
   (a group walked in chunks), bf16 and f32, each with its launch plan
   (strip, cluster, rows a block, chunks), and the exact CASCADE kernel at
   M = 8 over codeqwen's widths (with a bias, and rows holding a NaN, an
   inf and a saturating run) and at precision_sim's M = 128 shapes, each
   with its plan (rows a thread, warps a block), its step's SASS
   instructions (no FFMA), and one-thread clock64 chains of one f32 add
   (the chain bound) and of the kernel's step (its latency); each
   bit-equal to its plain version and timed against its bound;
   phi4-mini-3.8b QAT-trained at full
   width (params from seed 0 on the card, bf16, remat "dots", AdamW lr 3e-4
   with 2 warmup steps, 8 steps of 2 x 256 synthetic tokens): every loss
   and gnorm finite, the last loss under the first, the first loss bit-equal
   to the same forward with the fake quantization on its plain version, 448
   fake-quant launches a step (7 linears x 32 layers, forward and
   recompute), one more step profiled; the trained params converted to FP4
   (validation cross entropy dense against FP4) and served (8 requests of
   64 + 16 tokens through all four serving kernels); codeqwen1.5-7b at full
   width and depth 2 through ``precision_sim`` (every linear on the exact
   kernel, 15 launches; finite logits, relative L2 against the FP4 route);
   and a checkpoint restart (smoke phi4-mini, a child process under
   deterministic algorithms: 6 steps, an async save after 3, a fresh state
   restored and run on, its losses equal to the uninterrupted run's bit for
   bit, or within rtol 1e-6 where an op without a deterministic CUDA path
   is named).

5. The examples and the audit (``examples_and_audit``, after the serve
   runs): ``examples/quickstart.py`` and ``examples/fault_tolerance_demo.py``
   with ``--fused`` (every printed number finite; the quickstart's FP4 kernel
   path within 2^-6 of its round-tripped dense forward, its oracle's max
   |sum| equal to the CPU run's on the same inputs; CREST 5 of 5 repaired,
   none falsely; 9 of 9 requests after the failover; the resumed training
   tail bit-equal), a closure reading ``.item()`` that must trip both the
   census and ``torch.cuda.set_sync_debug_mode``, and the audit matrix
   (``repro_torch.analysis``): the four families' smoke configs x {dense,
   fused, paged}, then codeqwen1.5-7b at full width through the kernels on
   the dense and the paged cache (8 requests of 64 + 8 tokens, speculative
   and sampled), each served twice (nothing built or planned anew) and every
   step closure held to the serving contract, with zero gating findings.
   llama3.1-405b, the paper's example model, joins the depth-2 parity
   (128/8 heads: decode attention at G = 16), and the kernel phases hold its
   shapes (the FP4 matmul at M = 8 up to its 16384 x 128000 head, decode
   attention at 128/8 heads, flash attention at its 128/8 prefill).

6. Multi-device serving (``mesh``, last; explicit SPMD on ``torch.distributed``): (a)
   each rank's column band of the FP4 matmul (codeqwen1.5-7b's and llama3.1-405b's
   shapes at m = 2, 4, 8) and of the grouped expert matmul (olmoe's, m = 2, 4) equal,
   bit for bit, those columns of the unsharded call, and decode and flash attention over
   half the slot grid, planned as the whole grid (``ops.planned_rows``), its rows; (b) a
   world of one NCCL rank in this process: ``allreduce_compressed`` bit-equal to the
   same call on the CPU, and a (1, 1) mesh engine's streams (codeqwen, full depth)
   equal to the mesh-less engine's; (c) gloo worlds of 2 and 4 ranks sharing the card
   (spawned processes; NCCL takes one rank a card), codeqwen1.5-7b and olmoe-1b-7b at
   full width cut to ``MESH_DEPTH`` layers: cascade on (1, 2) and (2, 2), plain and
   speculative, every stream equal to one rank's alone and no partial-sum all-reduce
   in any step, megatron on (1, 2) (its all-reduces counted, its first departure read
   with the reference's top-2 margin), megatron on mamba2-370m's tied head (the table
   banded on the vocabulary: every stream served, the ranks agreeing), olmoe cascade on
   (1, 2), and the EP MoE layer on
   (1, 2) within 2^-6 of the unsharded layer; each rank's bands, memory and step times
   (ranks time-slicing one card: not a multi-GPU reading).

7. The dry run and the cache's model bands (``dryrun``, run before ``mesh``):
   decode attention with its log-sum-exp (``return_lse``) at the time-band
   shapes (qwen2.5-32b's 40/8 heads at B = 8 over a 2,048-row band,
   recurrentgemma-2b's ring at 10/1 heads, D = 256, over a 1,024-row band
   with the window mask): the output bit for bit the call's without lse,
   (o, lse) held to the plain version, both calls timed beside
   ``scaled_dot_product_attention`` on the band, with every key live and at
   each count of splits; gloo worlds sharing the card (``BAND_WORLDS``:
   qwen2-vl-2b at one layer and at its 28 on (1, 4), the k/v cache's time band;
   recurrentgemma-2b, the ring's time band and the RG-LRU's ``h``/conv
   channels, deepseek-v2-236b at depth 2, MLA's latent rows with its
   published top-6 routing, and mamba2-370m, the SSD state's heads and conv
   channels, on (1, 2)) at full width, each a prefill then ``BAND_STEPS``
   decode steps through the kernels with the cache placed by the whole
   ``cache_specs``, against the unsharded step on the rank: state bands bit
   for bit, time bands within the run's tolerance on every token whose
   routing held (the flips counted, the router's input held within it
   too), the gathered cache's first layer bit for bit and its later layers
   within the tolerance, each banded leaf 1/m of its bytes, decode attention (and
   the SSD scan) launched for every layer and step; the dry run of
   codeqwen1.5-7b at B = 8, T = 4,096 on a
   world of one beside the same step on the card (``argument_bytes`` equal
   to the step's tensors, FLOPs equal to ``FlopCounterMode`` on the card,
   its ``temp_bytes`` within ``WORLD1_MEM_RTOL`` of the rise of
   ``max_memory_allocated`` across the step); and
   the 16 x 16 dry-run records of every arch at decode_32k and long_500k
   under both policies and, under the reference roofline's optimized
   presets (``optimized_preset``: train ``fulldp`` + ``fsdp`` + ``full_dp``
   with remat ``none``, prefill ``seqpar``, every MoE step kind
   ``moe_ep``), at train_4k and prefill_32k (host work, started after the
   build in ``DRYRUN_WORKERS`` processes beside the card's phases and
   collected here).

8. An FP8 KV cache (``attention fp8 cache``, after the attention phases,
   and ``fp8_cache`` in codeqwen's serve phase): decode attention at the
   served step, a 4,096-row cache and qwen2.5-32b's time band, and flash
   attention at the verify pass and an admission chunk over 4,096 live
   keys, on an e4m3 cache: each bit-equal to the same kernel on the cache
   upcast to bf16 and within its plain version's tolerance, timed beside the
   bf16 kernel, the plain version and SDPA on the upcast (the cast
   included); codeqwen1.5-7b served at full width with
   ``kv_dtype=float8_e4m3fn`` (the plain run's prompts): every kernel of the
   path launched, the cache half the bf16 cache's bytes, and each stream's
   first departure from the bf16-cache run reported with that run's top-2
   margin.

9. The dry run's remaining placements (``placements``, last but one): a
   two-rank gloo world sharing the card (``placement_rank``): codeqwen1.5-7b
   at full width and depth 2, a prefill through the kernels under
   ``seqpar`` on (1, 2), cascade (block outputs back to the rows by
   all-to-all) and megatron (by reduce-scatter), against the unsharded
   prefill; phi4-mini-3.8b at full width and depth 2, three QAT train
   steps under ``zero1`` and ``fsdp`` on (2, 1) against the data-parallel
   step and under ``seqpar`` on (1, 2) against the unsharded step; the
   kernels' launches each step those of the reference run.

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
#     phi4-mini-3.8b (GQA 24/8, partial rotary, the QAT-trained model served
#     after training) takes codeqwen's limits: a dense transformer of the
#     same kind
#     llama31_405b (the paper's example model at full width, 128/8 heads:
#     decode attention at G = 16; K = 65,536 in the down projection) takes
#     codeqwen's limits: a dense transformer of the same kind
PARITY_LIMITS = {"codeqwen1.5-7b": (2.0 ** -6, 2), "mamba2-370m": (2.0 ** -9, 1),
                 "qwen2.5-32b": (2.0 ** -6, 2), "phi4-mini-3.8b": (2.0 ** -6, 2),
                 "olmoe-1b-7b": (2.0 ** -5.5, 10),
                 "deepseek-v2-236b": (2.0 ** -5, 25), "recurrentgemma-2b": (2.0 ** -6, 3),
                 "qwen2-vl-2b": (2.0 ** -6, 2), "musicgen-large": (2.0 ** -6, 2),
                 "llama31_405b": (2.0 ** -6, 2)}
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
#: the depth-2 parity phase also runs a GQA transformer, DeepSeek-V2's MLA
#: (layer 0 dense, layer 1 160 routed experts), neither served here,
#: phi4-mini-3.8b, the model QAT-trained and then served (qat_serve_phase),
#: and llama3.1-405b, the paper's own example model (two of its 80 layers at
#: full width: 7.6 B weights, 4 GB packed, beside a 4.2 GB bf16 embedding)
PARITY_ARCHS = ARCHS + ("qwen2.5-32b", "deepseek-v2-236b", "phi4-mini-3.8b", "llama31_405b")
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
                                             "flash_attention", "norm"),
               ("phi4-mini-3.8b", "train"): ("fake_quant_fp4", "flash_attention", "norm"),
               ("phi4-mini-3.8b", "plain"): ("cascade_matmul", "decode_attention",
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
#: the examples and the audit (phase 5): the quickstart's FP4 kernel path
#: against its bf16 round-tripped dense forward (max|diff| / max|dense|);
#: the audit matrix's modes on the four families' smoke configs, then
#: codeqwen1.5-7b at full width through the kernels on the dense and the
#: paged cache, AUDIT_REQ requests of AUDIT_PROMPT + AUDIT_NEW tokens,
#: speculative and sampled (temperature 0.8, top-k 50), served twice
QUICKSTART_EXACT_TOL = 2.0 ** -6
AUDIT_MODES, AUDIT_FULL_MODES = ("dense", "fused", "paged"), ("fused", "fused-paged")
AUDIT_REQ, AUDIT_PROMPT, AUDIT_NEW = 8, 64, 8
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
#: GeGLU MLP of all 26 layers and its untied head; phi4-mini-3.8b's q/o, k/v
#: (8 KV heads of 128: N = 1,024), gate/up and down in each of 32 layers
#: (its head is tied to the embedding: a plain f32 matmul, as in the
#: reference, not an FP4 one)
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
                 ("recurrentgemma-2b", 2560, 256000, False): 1,
                 ("phi4-mini-3.8b", 3072, 3072, False): 2 * 32,
                 ("phi4-mini-3.8b", 3072, 1024, False): 2 * 32,
                 ("phi4-mini-3.8b", 3072, 8192, False): 2 * 32,
                 ("phi4-mini-3.8b", 8192, 3072, False): 32}
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
#: (arch, K, N, bias) -> launches per decode step of llama3.1-405b at the
#: parity phase's depth 2: q and o (16,384 -> 16,384), k and v (8 KV heads of
#: 128: N = 1,024), gate and up (-> 65,536) and down (65,536 -> 16,384) in
#: each of 2 layers, and its untied 128,000-wide head; each at a decode
#: step's 8 rows
LLAMA_MATMUL = {("llama31_405b", 16384, 16384, False): 2 * 2,
                ("llama31_405b", 16384, 1024, False): 2 * 2,
                ("llama31_405b", 16384, 65536, False): 2 * 2,
                ("llama31_405b", 65536, 16384, False): 2,
                ("llama31_405b", 16384, 128000, False): 1}
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
    rows += [(arch, MAX_BATCH, k, n, bias, count, 0)
             for (arch, k, n, bias), count in LLAMA_MATMUL.items()]
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


#: (arch, experts, top-k, K, N, C, stacks, launches per decode step): the
#: grouped expert matmul at olmoe's gate/up (2048 -> 1024; one stack, and the
#: two stacks of a layer in one launch, as served) and down (1024 -> 2048)
#: at a decode step's C = 8, an admission chunk's 32 and a verify pass's 40,
#: and deepseek-v2's (5120 -> 1536, 1536 -> 5120) at C = 8
GROUPED_SHAPES = ([("olmoe-1b-7b", 64, 8, 2048, 1024, c, stacks,
                    16 if c == MAX_BATCH and stacks == 2 else 0)
                   for stacks in (1, 2) for c in (MAX_BATCH, CHUNK, MAX_BATCH * (1 + DRAFT_LEN))]
                  + [("olmoe-1b-7b", 64, 8, 1024, 2048, c, 1, 16 if c == MAX_BATCH else 0)
                     for c in (MAX_BATCH, CHUNK, MAX_BATCH * (1 + DRAFT_LEN))]
                  + [("deepseek-v2-236b", 160, 6, 5120, 1536, MAX_BATCH, 1, 0),
                     ("deepseek-v2-236b", 160, 6, 1536, 5120, MAX_BATCH, 1, 0)])
#: the earlier grouped kernel (one m-tile and 32 columns a block, a grid
#: layer an expert: the grouped entry of csrc/cascade_matmul.cu at commit
#: b6e8133): ms a call per GROUPED_SHAPES row, bf16 out, as PERF.md section
#: 6 records it (the pair: its two launches);
#: scripts/grouped_matmul_sweep.py --against-grouped times it in turns with
#: the current kernel
EARLIER_GROUPED_MS = {
    **{("olmoe-1b-7b", 2048, 1024, c, st): st * ms
       for c, ms in ((8, 0.0581), (32, 0.0845), (40, 0.0894)) for st in (1, 2)},
    **{("olmoe-1b-7b", 1024, 2048, c, 1): ms
       for c, ms in ((8, 0.0633), (32, 0.0998), (40, 0.1063))},
    ("deepseek-v2-236b", 5120, 1536, 8, 1): 0.1896, ("deepseek-v2-236b", 1536, 5120, 8, 1): 0.2070}


def grouped_stacks(torch, gen, dev, e, k, n, stacks):
    """``stacks`` (packed, scales) expert stacks of e random (k, n) weights."""
    from repro_torch.core import quant
    out = []
    for _ in range(stacks):
        parts = [quant.quantize_weight(torch.randn((k, n), generator=gen, device=dev), 0)
                 for _ in range(e)]
        out.append((torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])))
    return out


def grouped_matmul_phase(torch, dev, registers: list):
    """The grouped expert matmul at the served shapes, its rows routed as a
    step routes its tokens (C tokens, each to top-k distinct experts drawn
    at random; x zero past each expert's rows, as the dispatch builds it),
    one weight stack a launch or (olmoe's gate and up) two: each output held
    to its plain version (bf16 out, as served), bit for bit to a loop of
    per-expert ``ops.cascade_matmul`` calls over each expert's C rows (the
    route it replaces), and to exact zeros past the rows; timed cold beside
    the plain version, ``torch.bmm`` on the dense bf16 experts (both stacks
    side by side for the pair) and that loop, with its bound from the bytes
    of the experts with rows, its launch plan and the kernel's registers
    (``registers``: ptxas' lines)."""
    from repro_torch.core import quant
    from repro_torch.kernels import cascade_matmul as cm
    from repro_torch.kernels import ops

    rows_out = []
    for arch, e, top, k, n, c, nst, per_step in GROUPED_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(e + k + c)
        stacks = grouped_stacks(torch, gen, dev, e, k, n, nst)
        picks = torch.argsort(torch.rand((c, e), generator=gen, device=dev), dim=-1)[:, :top]
        rows = torch.bincount(picks.flatten(), minlength=e).to(torch.int32)
        live = torch.arange(c, device=dev)[None, :] < rows[:, None]
        x = torch.randn((e, c, k), generator=gen, device=dev) / k ** 0.5
        x = torch.where(live[..., None], x, 0.0).to(torch.bfloat16)
        ops.reset_launch_counts()
        if nst == 2:
            got = ops.cascade_matmul_grouped_pair(x, *stacks, rows, out_dtype=torch.bfloat16)
        else:
            got = (ops.cascade_matmul_grouped(x, *stacks[0], rows, out_dtype=torch.bfloat16),)
        launched = ops.LAUNCHES["cascade_matmul_grouped"]
        err, tol, equal, zeros = 0.0, 0.0, True, True
        for out, (packed, scales) in zip(got, stacks):
            want = cm.cascade_matmul_grouped_plain(x, packed, scales, rows, torch.bfloat16)
            loop = torch.stack([ops.cascade_matmul(x[i], packed[i], scales[i],
                                                   out_dtype=torch.bfloat16) for i in range(e)])
            torch.cuda.synchronize()
            err = max(err, float((out.float() - want.float()).abs().max()))
            tol = max(tol, MATMUL_BF16_RTOL * float(want.float().abs().max()) + MATMUL_ATOL)
            equal = equal and bool(torch.equal(out, loop))
            zeros = zeros and not bool(out[~live].any())
        pl = cm.plan_grouped(e, n)
        row = {"arch": arch, "E": e, "top_k": top, "C": c, "K": k, "N": n, "stacks": nst,
               "experts_with_rows": int((rows > 0).sum()), "routed_rows": int(rows.sum()),
               "plan": {**pl, "blocks": cm.grouped_blocks(pl, k, k, torch.bfloat16)},
               "registers": registers, "launches": launched,
               "launches_per_decode_step": per_step, "max_abs_err": err, "tol": tol,
               "equals_per_expert_calls": equal, "zeros_past_rows": zeros}
        if not (err <= tol and equal and zeros and launched == 1):
            fail(f"cascade_matmul_grouped {arch} ({nst} x {e}x{c}, {k}->{n}): {row}")
        nc = copies_beyond_l2(sum(p.numel() + s.numel() * 4 for p, s in stacks))
        sets = [(x, *[t if i == 0 else t.clone() for st in stacks for t in st], rows)
                for i in range(nc)]
        if nst == 2:
            kern = lambda a, p0, s0, p1, s1, r: ops.cascade_matmul_grouped_pair(
                a, (p0, s0), (p1, s1), r, out_dtype=torch.bfloat16)
            plain = lambda a, p0, s0, p1, s1, r: cm.cascade_matmul_grouped_pair_plain(
                a, (p0, s0), (p1, s1), r, torch.bfloat16)
        else:
            kern = lambda a, p, sc, r: ops.cascade_matmul_grouped(a, p, sc, r,
                                                                  out_dtype=torch.bfloat16)
            plain = lambda a, p, sc, r: cm.cascade_matmul_grouped_plain(a, p, sc, r,
                                                                       torch.bfloat16)

        def per_expert(a, *ts):
            return [ops.cascade_matmul(a[i], ts[2 * j][i], ts[2 * j + 1][i],
                                       out_dtype=torch.bfloat16)
                    for j in range(nst) for i in range(e)]
        dense = torch.cat([torch.stack([quant.dequantize_weight(p[i], s[i], torch.bfloat16)
                                        for i in range(e)]) for p, s in stacks], dim=2)
        lib_sets = [(x, dense if i == 0 else dense.clone())
                    for i in range(copies_beyond_l2(dense.numel() * 2))]
        row.update({"ms": graph_ms(torch, kern, sets, 40),
                    "earlier_kernel_ms": EARLIER_GROUPED_MS[(arch, k, n, c, nst)],
                    "per_expert_loop_ms": graph_ms(torch, per_expert, sets, 3),
                    "plain_ms": graph_ms(torch, plain, sets[:1], 2),
                    "library_ms": graph_ms(torch, lambda a, wd: torch.bmm(a, wd), lib_sets, 10),
                    "library_note": "torch.bmm of bf16 (E, C, K) x dense bf16 (E, K, N) experts"
                                    + (" (both stacks side by side: N x 2)" if nst == 2 else "")})
        # the weights of the experts with rows, their live rows of x (read
        # once), every output row written (zeros past the rows included)
        wbytes = sum(p.numel() // e + s.numel() // e * 4 for p, s in stacks) \
            * row["experts_with_rows"]
        nbytes = wbytes + int(rows.sum()) * k * 2 + nst * e * c * n * 2
        flops = 2 * nst * int(rows.sum()) * k * n
        row.update({"bytes": nbytes, "flops": flops,
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
                    "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                                 else "operations")})
        print(json.dumps({"grouped_row": {kk: row[kk] for kk in (
            "arch", "stacks", "C", "K", "N", "ms", "earlier_kernel_ms", "bound_ms",
            "library_ms")}}),
            flush=True)
        rows_out.append(row)
        del sets, lib_sets, dense, stacks
        torch.cuda.empty_cache()
    return rows_out


def decode_attention_cases():
    """(name, B, Hq, Hkv, T, positions, D): the served codeqwen step (8
    slots at 128-156 of the engine's 192-row cache), qwen2.5-32b's GQA
    heads (40 over 8) at the same positions, a long context (T = 4096,
    positions spread over 2,047-4,095, so 2,048-4,096 live keys a row), and
    the modality-stub backbones' steps: musicgen-large's 32 heads at D = 64
    and qwen2-vl-2b's 12 over 2 KV heads (G = 6), phi4-mini-3.8b's step
    after QAT (24 over 8 heads, G = 3, in the qat serve run's 96-row cache),
    and llama3.1-405b's 128 over 8 heads (G = 16: two blocks of 8 heads a
    KV head) in the served 192-row cache."""
    t = -(-(PROMPT_LEN + MAX_NEW + 1) // CHUNK) * CHUNK      # the engine's cache length
    served = [PROMPT_LEN + 4 * i for i in range(MAX_BATCH)]
    t_qat = -(-(QAT_PROMPT + QAT_NEW + 1) // CHUNK) * CHUNK
    served_qat = [QAT_PROMPT + 2 * i for i in range(MAX_BATCH)]
    long_pos = [2047 + round(i * 2048 / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    return [("codeqwen_step", MAX_BATCH, 32, 32, t, served, 128),
            ("olmoe_step", MAX_BATCH, 16, 16, t, served, 128),
            ("qwen2.5-32b_gqa", MAX_BATCH, 40, 8, t, served, 128),
            ("long_4096", MAX_BATCH, 32, 32, 4096, long_pos, 128),
            ("musicgen_step_d64", MAX_BATCH, 32, 32, t, served, 64),
            ("qwen2vl_step_g6", MAX_BATCH, 12, 2, t, served, 128),
            ("phi4_step_g3", MAX_BATCH, 24, 8, t_qat, served_qat, 128),
            ("llama_step_g16", MAX_BATCH, 128, 8, t, served, 128)]


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
                                           "phi4_step_g3": 32, "llama_step_g16": 2,
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
    KV heads) and, at D = 64, an admission chunk of 32 over a 160-row cache;
    phi4-mini-3.8b's QAT training forward (2 rows of 256 tokens, 24 over 8
    heads) and its second admission chunk after QAT (offset 32); llama3.1-
    405b's 8 x 128-token prefill at 128 over 8 heads."""
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
               ("qwen2vl_prefill", MAX_BATCH, 12, 2, 128, 128, True, [0] * MAX_BATCH, d),
               ("phi4_train", TRAIN_BATCH, 24, 8, TRAIN_SEQ, TRAIN_SEQ, True,
                [0] * TRAIN_BATCH, d),
               ("phi4_admit_off32", 1, 24, 8, CHUNK, 2 * CHUNK, True, [CHUNK], d),
               ("llama_prefill_g16", MAX_BATCH, 128, 8, 128, 128, True, [0] * MAX_BATCH, d)])


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


#: the non-default logits scale of the ``softmax_scale`` phase
#: (``AttnConfig.softmax_scale``; 1/sqrt(128) = 0.0884, 1/sqrt(256) = 0.0625)
SOFTMAX_SCALE = 0.07


def softmax_scale_phase(torch, dev):
    """Both attention kernels at a non-default logits scale
    (``AttnConfig.softmax_scale``): decode attention at the served codeqwen
    step, flash attention at its verify pass and an admission chunk, and
    Griffin's local flash attention (head dim 256, ``k_pos``, window) over
    [ring, chunk]. Each kernel call is held to its plain version at that
    scale with the tolerance of its phase above, and must differ from the
    default-scale kernel call; the launches of the scaled calls are
    counted."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    out = {"scale": SOFTMAX_SCALE, "cases": []}
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    launches = {"decode_attention": 0, "flash_attention": 0}

    def counted(fn, *args, **kw):
        ops.reset_launch_counts()
        y = fn(*args, **kw)
        for kind in launches:
            launches[kind] += ops.LAUNCHES[kind]
        return y

    def check(name, kind, scaled, plain, default, tol):
        err = (scaled.float() - plain.float()).abs()
        moved = float((scaled.float() - default.float()).abs().max())
        row = {"case": name, "kernel": kind, "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol).max()), "moved_from_default": moved}
        if not bool((err <= tol).all()) or not moved > 0:
            fail(f"softmax_scale {name}: the {kind} kernel at scale {SOFTMAX_SCALE} against "
                 f"its plain version, or against the default scale: {row}")
        out["cases"].append(row)

    # decode attention: the served step (8 slots of codeqwen's 32 heads)
    t = -(-(PROMPT_LEN + MAX_NEW + 1) // CHUNK) * CHUNK
    pos = torch.tensor([PROMPT_LEN + 4 * i for i in range(MAX_BATCH)], dtype=torch.int32,
                       device=dev)
    q, k, v = rnd(MAX_BATCH, 32, 128), rnd(MAX_BATCH, t, 32, 128), rnd(MAX_BATCH, t, 32, 128)
    scaled = counted(ops.decode_attention, q, k, v, q_pos=pos, scale=SOFTMAX_SCALE)
    check("codeqwen_step", "decode_attention", scaled,
          da.decode_attention_plain(q, k, v, q_pos=pos, scale=SOFTMAX_SCALE),
          ops.decode_attention(q, k, v, q_pos=pos), ATTN_ATOL)
    # flash attention: the verify pass and an admission chunk at offset 96
    n = DRAFT_LEN + 1
    tv = -(-(PROMPT_LEN + MAX_NEW + 1 + DRAFT_LEN) // CHUNK) * CHUNK
    verify_off = [round(i * (tv - n) / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    for name, b, s, tk, offsets, hq, hkv, d, ring, window in (
            ("verify", MAX_BATCH, n, tv, verify_off, 32, 32, 128, 0, 0),
            ("admit_off96", 1, CHUNK, 96 + CHUNK, [96], 32, 32, 128, 0, 0),
            ("griffin_admit_off96", 1, CHUNK, GRIFFIN_WINDOW + CHUNK, [96], GRIFFIN_HEADS, 1,
             GRIFFIN_D, GRIFFIN_WINDOW, GRIFFIN_WINDOW)):
        qv = rnd(b, s, hq, d).transpose(1, 2)
        kc, vc = rnd(b, tk, hkv, d), rnd(b, tk, hkv, d)
        kk, vv = kc.transpose(1, 2), vc.transpose(1, 2)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        k_pos = None
        if ring:
            qrows = off[:, None] + torch.arange(s, device=dev, dtype=torch.int32)
            k_pos = torch.cat([ring_slot_pos(torch, b, ring, offsets, dev), qrows], dim=1)
        kw = dict(q_offset=off, k_pos=k_pos, window=window)
        scaled = counted(ops.flash_attention, qv, kk, vv, scale=SOFTMAX_SCALE, **kw)
        plain = fa.flash_attention_plain(qv, kk, vv, True, SOFTMAX_SCALE, off, k_pos, window)
        tol = FLASH_RTOL * plain.float().abs() + FLASH_VTOL * float(vc.float().abs().max())
        check(name, "flash_attention", scaled, plain, ops.flash_attention(qv, kk, vv, **kw), tol)
    torch.cuda.synchronize()
    out["launches"] = launches
    if launches != {"decode_attention": 1, "flash_attention": 3}:
        fail(f"softmax_scale: the scaled calls launched {launches}, not one decode and three "
             "flash attentions")
    return out


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
    (with bias) at 2,048 in 8, (8, 5) and 32 rows, qwen2-vl-2b's RMSNorm at
    1,536, and phi4-mini-3.8b's at 3,072 in the served three shapes and the
    QAT training forward's 2 x 256 rows."""
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
            ("qwen2vl_step", (MAX_BATCH, 1), 1536, "rmsnorm"),
            ("phi4_step", (MAX_BATCH, 1), 3072, "rmsnorm"),
            ("phi4_verify", v, 3072, "rmsnorm"),
            ("phi4_admit", (1, CHUNK), 3072, "rmsnorm"),
            ("phi4_train", (TRAIN_BATCH, TRAIN_SEQ), 3072, "rmsnorm")]


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
    large's add-LayerNorm (with bias) at 2,048 in 8, (8, 5) and 32 rows, and
    phi4-mini-3.8b's add-norm at 3,072 (a decode step, an admission chunk,
    the QAT training forward's 2 x 256 rows). Rows are bf16 but where
    stated; the norm is RMSNorm but where stated."""
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
            ("musicgen_rows32_add", "add", (1, CHUNK), 2048, "bfloat16", "layernorm"),
            ("phi4_step_add", "add", (MAX_BATCH, 1), 3072, "bfloat16"),
            ("phi4_admit_add", "add", (1, CHUNK), 3072, "bfloat16"),
            ("phi4_train_add", "add", (TRAIN_BATCH, TRAIN_SEQ), 3072, "bfloat16")]


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
def plain_versions_on_card(only: tuple | None = None):
    """Send the wrappers' CUDA tensors to the kernels' plain versions (the
    parity phase's reference run), or only the named launchers' (``only``);
    the launch counts are put back after."""
    from repro_torch.kernels import cascade_exact as ce
    from repro_torch.kernels import cascade_matmul as cm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import norm as nrm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    routes = [(cm, "cascade_matmul_cuda", cm.cascade_matmul_plain),
              (ce, "cascade_matmul_exact_cuda", ce.cascade_matmul_exact_plain),
              (fq, "fake_quant_fp4_cuda", fq.fake_quant_fp4_plain),
              (cm, "cascade_matmul_grouped_cuda", cm.cascade_matmul_grouped_plain),
              (da, "decode_attention_cuda", da.decode_attention_plain),
              (fa, "flash_attention_cuda", fa.flash_attention_plain),
              (nrm, "norm_cuda", nrm.norm_plain),
              (nrm, "add_norm_cuda", nrm.add_norm_plain),
              (nrm, "gated_norm_cuda", nrm.gated_norm_plain),
              (ssd, "ssd_scan_cuda", ssd.ssd_scan_plain)]
    routes = [r for r in routes if only is None or r[1] in only]
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
    from repro_torch.kernels.ops import PLAIN_GRADIENT
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(PLAIN_GRADIENT):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ours = {}                  # the port's kernels, every instantiation (and merge) summed
    for name, (n, us) in by_name.items():
        for k in ("cascade_matmul", "cascade_matmul_grouped", "decode_attention",
                  "flash_attention", "norm", "ssd_scan", "fake_quant_fp4", "cascade_matmul_exact"):
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
    # the plain versions' gradients (ops._PlainGradient's backward, and its
    # recompute of the plain forward inside it): device ms of the kernels
    # launched inside each range
    plain_grad = {}
    for ev in prof.key_averages():
        if ev.key.startswith(PLAIN_GRADIENT) and ev.device_type == DeviceType.CPU:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            plain_grad[ev.key] = {"count": ev.count, "device_ms": dev_us / 1e3}
    return {"tokens": produced, "wall_ms_under_profiler": wall_ms,
            "device_busy_ms": busy_ms if by_name else "not measured",
            "device_kernels": sum(n for n, _ in by_name.values()),
            "our_kernels": {k: {"count": n, "ms": us / 1e3} for k, (n, us) in ours.items()},
            "eager_elementwise": eager,
            "kv_rows": {k: {"count": n, "ms": us / 1e3} for k, (n, us) in pool.items()},
            "routing_ops": routing, "plain_gradient": plain_grad,
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
    if eng.fused and arch == "olmoe-1b-7b":
        # gate and up in one launch, then down: two grouped launches a layer
        seen = sorted({st["cascade_matmul_grouped"] for st in steps})
        if seen != [2 * model.cfg.n_layers]:
            fail(f"serve ({arch}, {kind}): grouped launches a step {seen}, expected "
                 f"{2 * model.cfg.n_layers}")
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
                "cascade_matmul_grouped": 2 * n_layers if arch == "olmoe-1b-7b" else 0,
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
    fp8_run = None
    if arch == "codeqwen1.5-7b":
        fp8_run = fp8_cache_run(torch, dev, arch, model, params, ccfg, prompts, (reqs, prec0),
                                plain)

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
    if fp8_run is not None:
        out["fp8_cache"] = fp8_run

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


# ---------------------------------------------------------------------------
# the training side: QAT fake quantization, the exact CASCADE matmul, the
# full-width QAT train steps, restart, serving after QAT, precision_sim
# ---------------------------------------------------------------------------

#: the full-width QAT run: phi4-mini-3.8b, TRAIN_STEPS AdamW steps on
#: TRAIN_BATCH x TRAIN_SEQ synthetic tokens, remat "dots"; then FP4 serving
#: of QAT_REQ prompts of QAT_PROMPT tokens, QAT_NEW new tokens each
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "phi4-mini-3.8b", 8, 2, 256
QAT_REQ, QAT_PROMPT, QAT_NEW = 8, 64, 16
#: phi4-mini's linears a layer (q, k, v, o, gate, up, down), each fake-
#: quantized once in the forward and once in the recompute of a step
QAT_LINEARS = 7
#: (case, weight shape, group, experts, launches in one phi4-mini forward)
FQ_SHAPES = [("phi4_qo", (3072, 3072), 0, False, 2 * 32),
             ("phi4_kv", (3072, 1024), 0, False, 2 * 32),
             ("phi4_gate_up", (3072, 8192), 0, False, 2 * 32),
             ("phi4_down", (8192, 3072), 0, False, 32),
             ("codeqwen_up", (4096, 13440), 0, False, 0),
             ("phi4_gate_up_g32", (3072, 8192), 32, False, 0),
             ("olmoe_experts", (64, 2048, 1024), 0, True, 0),
             ("nemotron_down", (24576, 6144), 0, False, 0)]
#: precision_sim: codeqwen1.5-7b cut to SIM_DEPTH layers at full width, a
#: forward of SIM_ROWS x SIM_LEN tokens
SIM_DEPTH, SIM_ROWS, SIM_LEN = 2, 8, 16
#: the exact CASCADE matmul: (M, K, N) at codeqwen's widths, each with and
#: without a bias; and precision_sim's forward at M = SIM_ROWS * SIM_LEN,
#: (M, K, N, launches a forward): q/k/v/o, gate/up, down and the head
CE_SHAPES = [(8, 4096, 4096), (8, 4096, 13440), (8, 13440, 4096)]
CE_SIM_SHAPES = [(SIM_ROWS * SIM_LEN, 4096, 4096, 4 * SIM_DEPTH),
                 (SIM_ROWS * SIM_LEN, 4096, 13440, 2 * SIM_DEPTH),
                 (SIM_ROWS * SIM_LEN, 13440, 4096, SIM_DEPTH),
                 (SIM_ROWS * SIM_LEN, 4096, 92416, 1)]
#: the SASS opcodes of one exact step (FMUL, FADD, FMNMX, FRND, LOP3 and the
#: unsigned min): a step's operation count is their number in the kernel's
#: code over its FRND count (one FRND a step), counted at the operation rate
CE_STEP_OPCODES = ("FMUL", "FADD", "FMNMX", "FRND", "LOP3", "IMNMX", "VIMNMX")
#: steps of the one-thread chain probes: of the kernel's step (its latency,
#: a diagnosis) and of plain f32 adds (one operation's latency)
CE_CHAIN_STEPS, CE_ADD_STEPS = 1 << 20, 1 << 24
#: the dependent operations a step needs at least: the add, and one that
#: cuts the sum to FP8 (no instruction of the card does both); K of them at
#: an add's latency are the chain bound
CE_CHAIN_OPS = 2


def sass_opcodes(lib) -> dict:
    """``cuobjdump -sass`` of a built kernel library: each function's SASS
    opcodes (the name before the first '.'), counted. The tool sits beside
    nvcc; its absence fails the smoke, since nvcc built the kernels."""
    import collections
    import re
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {lib} failed: {res.stderr[-2000:]}")
    funcs, cur = {}, None
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    for line in res.stdout.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), collections.Counter())
        elif cur is not None:
            hit = ins.search(line)
            if hit:
                cur[hit.group(1).split(".")[0]] += 1
    return funcs


def same_bits(torch, got, want) -> bool:
    """Bit for bit, but any NaN equals any NaN."""
    nan = torch.isnan(got) & torch.isnan(want)
    iv = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return bool(((got.view(iv) == want.view(iv)) | nan).all())


def event_ms(torch, fn, argsets, iters: int) -> float:
    """Device ms per call of ``iters`` eager calls between CUDA events, after
    one warm-up call (for plain versions whose eager ops a CUDA graph cannot
    capture: they copy small tables from the host)."""
    fn(*argsets[0])
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def fake_quant_phase(torch, dev):
    """The fake-quant kernel at phi4-mini's and codeqwen's weight shapes, a
    group of 32, an olmoe expert stack and a group taller than a cluster
    holds at once, bf16 and f32: bit-equal to its plain version, timed cold
    against its byte bound and the plain version, with its launch plan
    (strip, cluster, rows a block, chunks)."""
    from repro_torch.core import quant
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import ops

    rows = []
    for case, shape, group, experts, per_fwd in FQ_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(len(case) + len(shape))
            w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
            ops.reset_launch_counts()
            got = ops.fake_quant_fp4(w, group, experts=experts)
            torch.cuda.synchronize()
            launched = ops.LAUNCHES["fake_quant_fp4"]
            b = shape[0] if experts else 1
            k = w.numel() // (shape[-1] * b)
            pl = dict(fq.plan(b, k, shape[-1], quant.fake_quant_groups(k, group),
                              w.element_size()))
            want = quant.fake_quant_fp4_plain(w, group, experts)
            if launched != 1 or not same_bits(torch, got, want):
                fail(f"fake_quant_fp4 {case} {dtype}: {launched} launches, or the kernel "
                     f"differs from its plain version")
            nbytes = 2 * w.numel() * w.element_size()
            sets = [(w.clone(),) for _ in range(copies_beyond_l2(nbytes))]
            kern = lambda t: ops.fake_quant_fp4(t, group, experts=experts)
            plain = lambda t: quant.fake_quant_fp4_plain(t, group, experts)
            dt = str(dtype).split(".")[-1]
            rows.append({"case": case, "shape": list(shape), "group": group, "dtype": dt,
                         "experts": experts, "launches_per_phi4_forward": per_fwd,
                         "plan": pl, "slabs_per_sm": pl["slabs"] / fq.SMS,
                         "max_abs_err": float((got.float() - want.float()).abs().max()),
                         "bit_equal": True,
                         "ms": graph_ms(torch, kern, sets, 20),
                         "plain_ms": event_ms(torch, plain, sets, 3),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                         "bytes": nbytes, "library_ms": None,
                         "library_note": "none: no PyTorch call computes it"})
            del sets, got, want, w
            torch.cuda.empty_cache()
    return rows


def cascade_exact_step_ops(torch) -> dict:
    """The exact kernel's step as compiled: its SASS opcodes (every
    function of the library), the instructions of one step (CE_STEP_OPCODES
    in the matmul kernels over their FRND count), and FFMA's count in them,
    which must be 0 (no contraction in the step)."""
    from repro_torch.kernels import build
    funcs = sass_opcodes(build.library_path("cascade_exact"))
    mm = [c for f, c in funcs.items() if "cascade_matmul_exact_kernel" in f]
    if not mm:
        fail(f"cascade_exact: no matmul kernel in the library's SASS ({sorted(funcs)})")
    step = sum(c[o] for c in mm for o in CE_STEP_OPCODES)
    frnd = sum(c["FRND"] for c in mm)
    ffma = sum(c["FFMA"] for c in mm)
    if ffma or not frnd:
        fail(f"cascade_exact: the matmul kernels hold {ffma} FFMA and {frnd} FRND in their SASS")
    return {"ops_per_step": step / frnd, "ffma": ffma,
            "opcodes": {f: dict(c) for f, c in funcs.items()}}


def cascade_exact_phase(torch, dev):
    """The exact CASCADE kernel at M = 8 over codeqwen's 4096 -> 4096, 4096 ->
    13440 and 13440 -> 4096, with and without a bias, and on rows that hold
    a NaN, an inf and a saturating run, and at precision_sim's M = 128
    shapes (the head's 92,416 columns among them): bit-equal to its plain
    version, timed against its bound and the plain version (K dependent
    eager steps), with its launch plan. The bound is the largest of the
    bytes, the step's SASS instructions over all M * N * K steps at the f32
    rate, and the chain: K steps of CE_CHAIN_OPS dependent operations at the
    latency of one f32 add, which a one-thread clock64 chain of adds
    measures. A one-thread chain of the kernel's own step gives its latency
    beside it (a diagnosis, not a bound)."""
    from repro_torch.core import quant
    from repro_torch.kernels import cascade_exact as ce
    from repro_torch.kernels import ops

    sass = cascade_exact_step_ops(torch)
    chain = ce.chain_cycles(CE_CHAIN_STEPS, dev)
    chain.update(cycles_per_step=chain["cycles"] / chain["steps"],
                 ns_per_step=chain["ms"] * 1e6 / chain["steps"])
    add = ce.chain_cycles(CE_ADD_STEPS, dev, add=True)
    ns_add = add["ms"] * 1e6 / add["steps"]
    add.update(cycles_per_add=add["cycles"] / add["steps"], ns_per_add=ns_add)
    rows = []
    cases = [(m, k, n, bias_on, 0) for m, k, n in CE_SHAPES for bias_on in (False, True)]
    cases += [(m, k, n, True, per_fwd) for m, k, n, per_fwd in CE_SIM_SHAPES]
    for m, k, n, bias_on, per_fwd in cases:
        gen = torch.Generator(device=dev).manual_seed(k + n + bias_on + m)
        x4 = quant.fp4_round(torch.randn((m, k), generator=gen, device=dev) * 2.0)
        w4 = quant.fp4_round(torch.randn((k, n), generator=gen, device=dev) * 2.0)
        bias = torch.randn((n,), generator=gen, device=dev) * 4 if bias_on else None
        special = bias_on and (k, n) == (4096, 13440)
        if special:             # a saturating run, a NaN and an inf
            x4[0], w4[:, 0] = 6.0, 6.0
            x4[1, k // 2] = float("nan")
            x4[2, 3] = float("inf")
        ops.reset_launch_counts()
        got = ops.cascade_matmul_exact(x4, w4, bias)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["cascade_matmul_exact"]
        t0 = time.monotonic()
        want = quant.cascade_matmul_exact(x4, w4, bias)
        torch.cuda.synchronize()
        plain_wall_ms = (time.monotonic() - t0) * 1e3
        if launched != 1 or not same_bits(torch, got, want):
            fail(f"cascade_exact {m}x{k}->{n} bias={bias_on}: {launched} launches, or the "
                 f"kernel differs from its plain version")
        if special and not (float(got[0, 0]) == 448.0 and bool(torch.isnan(got[1]).all())):
            fail("cascade_exact: the saturating row or the NaN row came out otherwise")
        nbytes = (x4.numel() + w4.numel() + got.numel() + (n if bias_on else 0)) * 4
        ops_n = sass["ops_per_step"] * m * n * k
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_n / F32_FLOP_PER_S
        t_chain = k * CE_CHAIN_OPS * ns_add * 1e-9
        term = max((t_bytes, "bytes"), (t_ops, "operations"), (t_chain, "chain"))[1]
        sets = [(x4, w4.clone(), bias) for _ in range(copies_beyond_l2(w4.numel() * 4))]
        finite = torch.isfinite(want)
        rows.append({"M": m, "K": k, "N": n, "bias": bias_on, "special_rows": special,
                     "launches_per_sim_forward": per_fwd, "plan": ce.plan(m, n),
                     "bit_equal": True,
                     "max_abs_err": float((got[finite] - want[finite]).abs().max()),
                     "saturated_share": float((want.abs() == 448.0).float().mean()),
                     "ms": graph_ms(torch, lambda a, b, c: ops.cascade_matmul_exact(a, b, c),
                                    sets, 10 if m <= 8 else 3),
                     "plain_ms": plain_wall_ms, "plain_timing": "one eager call, host clock "
                     "around it ending in a synchronize (K dependent steps of eager ops)",
                     "bound_ms": max(t_bytes, t_ops, t_chain) * 1e3, "bound_by": term,
                     "bound_bytes_ms": t_bytes * 1e3,
                     "bound_ops_ms": t_ops * 1e3, "bound_chain_ms": t_chain * 1e3,
                     "bound_ops": ops_n, "bound_bytes": nbytes,
                     "step_chain_ms": k * chain["ns_per_step"] * 1e-6, "library_ms": None,
                     "library_note": "none: no PyTorch call computes it"})
        del sets, got, want
        torch.cuda.empty_cache()
    return {"rows": rows, "chain": chain, "add_chain": add,
            "ops_per_step": sass["ops_per_step"], "sass_ffma": sass["ffma"],
            "sass_opcodes": sass["opcodes"]}


def train_steps(torch, state, step, data):
    """TRAIN_STEPS steps on ``data``'s batches 0, 1, ...: (the state, the
    run's readings: losses (0-d tensors), gnorms, lrs, step ms, peak memory,
    the launches, and the launches of each step)."""
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, lrs, step_ms, per_step = [], [], [], [], []
    ops.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t = time.monotonic()
        state, m = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
        losses.append(m["loss"])
        gnorms.append(float(m["gnorm"]))
        lrs.append(float(m["lr"]))
        per_step.append({k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES})
    p50 = float(sorted(step_ms)[len(step_ms) // 2])
    return state, {"losses": losses, "gnorms": gnorms, "lrs": lrs, "step_ms": step_ms,
                   "step_ms_p50": p50, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / p50,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": dict(ops.LAUNCHES), "launches_by_step": per_step}


def train_phase(torch, dev):
    """phi4-mini-3.8b at full width: params from seed 0 on the card, bf16,
    QAT through the fake-quant kernel, remat "dots", AdamW; TRAIN_STEPS
    steps of synthetic batches. Returns (the readings, the trained params)."""
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import loop as tloop

    cfg, model = registry.load(TRAIN_ARCH)
    ccfg = CascadeConfig(mode="train", qat=True, use_kernel=True, compute_dtype=torch.bfloat16)
    opt = AdamW(lr=3e-4, warmup_steps=2, decay_steps=TRAIN_STEPS)
    t0 = time.monotonic()
    state = tloop.init_state(model, ccfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in T.leaves(state.params))
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    step = tloop.make_train_step(model, ccfg, opt, remat=True, remat_policy="dots")
    # the first batch's loss with the fake quantization on its plain version,
    # the forward run as the train step runs it (recorded, remat "dots")
    b0 = {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(0).items()}
    with plain_versions_on_card(only=("fake_quant_fp4_cuda",)):
        loss_plain_fq = tloop.cross_entropy(
            model.forward(state.params, b0, ccfg, remat=True, remat_policy="dots"),
            b0["labels"]).detach()
    del b0
    state, run = train_steps(torch, state, step, data)
    per_step = run.pop("launches_by_step")
    want_fq = 2 * QAT_LINEARS * cfg.n_layers
    losses = run["losses"]
    rec = {"arch": TRAIN_ARCH, "params": n_params, "steps": TRAIN_STEPS,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat_policy": "dots", "init_s": init_s,
           **run, "losses": [float(x) for x in losses],
           "first_loss_plain_fake_quant": float(loss_plain_fq),
           "first_loss_bit_equal_plain_fake_quant": bool(torch.equal(losses[0], loss_plain_fq)),
           "launches_per_step": per_step[-1],
           "fake_quant_per_step_expected": want_fq,
           "state_gb": sum(p.numel() * (p.element_size() + 8)
                           for p in T.leaves(state.params)) / 1e9}
    launches, gnorms = rec["launches"], rec["gnorms"]
    if not all(math.isfinite(x) for x in rec["losses"] + gnorms):
        fail(f"train: a loss or gnorm is not finite: {rec['losses']}, {gnorms}")
    if not rec["losses"][-1] < rec["losses"][0]:
        fail(f"train: the loss did not fall: {rec['losses']}")
    if not rec["first_loss_bit_equal_plain_fake_quant"]:
        fail(f"train: the first loss {rec['losses'][0]!r} differs from the plain fake "
             f"quantization's {rec['first_loss_plain_fake_quant']!r}")
    if any(s["fake_quant_fp4"] != want_fq for s in per_step):
        fail(f"train: fake-quant launches a step {[s['fake_quant_fp4'] for s in per_step]}, "
             f"expected {want_fq} (7 linears x {cfg.n_layers} layers x forward + recompute)")
    if not all(launches[k] > 0 for k in RUN_KERNELS[(TRAIN_ARCH, "train")]):
        fail(f"train: a kernel of the path never launched: {launches}")
    # one more step under the profiler: device busy time and the top kernels
    prof = profile_call(torch, lambda: step(state, data.batch_at(TRAIN_STEPS)))
    state = prof.pop("tokens")[0]
    rec["profiled_step"] = {k: prof[k] for k in ("wall_ms_under_profiler", "device_busy_ms",
                                                 "device_kernels", "our_kernels",
                                                 "plain_gradient", "top_kernels")}
    params = T.tree_map(lambda p: p.detach(), state.params)
    del state, step
    return rec, params


def qat_serve_phase(torch, dev, params):
    """The QAT-trained full-width params converted to FP4: validation cross
    entropy dense against FP4 on a held-out batch, then QAT_REQ requests
    served through ServeEngine(fused=True)."""
    import numpy as np
    from repro_torch.core import cascade
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.train import loop as tloop

    cfg, model = registry.load(TRAIN_ARCH)
    dense = CascadeConfig(mode="train", use_kernel=True, compute_dtype=torch.bfloat16)
    fp4 = CascadeConfig(mode="serve_fp4", use_kernel=True, compute_dtype=torch.bfloat16)
    t0 = time.monotonic()
    fp4_params = cascade.tree_to_serve_fp4(params, fp4)
    torch.cuda.synchronize()
    convert_s = time.monotonic() - t0
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    val = {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(10_000).items()}
    with torch.no_grad():
        ce_dense = float(tloop.cross_entropy(model.forward(params, val, dense), val["labels"]))
        ce_fp4 = float(tloop.cross_entropy(model.forward(fp4_params, val, fp4), val["labels"]))
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if not (math.isfinite(ce_dense) and math.isfinite(ce_fp4)):
        fail(f"qat serve: validation cross entropy not finite: {ce_dense}, {ce_fp4}")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, QAT_PROMPT).astype(np.int32) for _ in range(QAT_REQ)]
    run, _, _, _ = serve_run(torch, dev, TRAIN_ARCH, model, fp4_params, fp4, prompts,
                             "after_qat", max_new=QAT_NEW, max_len=QAT_PROMPT + QAT_NEW + 1)
    want = {"cascade_matmul": QAT_LINEARS * cfg.n_layers, "decode_attention": cfg.n_layers,
            "norm": 2 * cfg.n_layers + 1}
    got = {k: run["launches_per_decode_step"][k] for k in want}
    if got != want:
        fail(f"qat serve: launches a decode step {got}, expected {want} (an FP4 matmul for "
             f"each of 7 linears, decode attention and two norms a layer, the final norm; "
             f"the head is tied)")
    return {"convert_s": convert_s, "val_ce_dense": ce_dense, "val_ce_fp4": ce_fp4,
            "val_ce_delta": ce_fp4 - ce_dense,
            "fp4_weight_gb": cascade.num_weight_bytes(fp4_params) / 1e9, "serve": run}


#: train_recipe_phase's runs: (name, use_kernel, warmup steps), each on the
#: train phase's seed, batches and steps
RECIPE_RUNS = (("plain_route", False, 2), ("warmup_all_steps", True, TRAIN_STEPS))


def train_recipe_phase(torch, dev, kernel_run: dict):
    """phi4-mini-3.8b's full-width QAT run twice more: with every kernel on
    its plain version (``use_kernel`` off), then on the kernels with the
    learning-rate warmup over all steps. The plain route's first loss must
    be within a bf16 step of the kernel route's (the card test's limit),
    and it must launch no kernel; the curves show whether the kernel route
    or the recipe's two-step warmup makes the train phase's loss spike."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import loop as tloop

    cfg, model = registry.load(TRAIN_ARCH)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    runs = {}
    for name, use_kernel, warmup in RECIPE_RUNS:
        ccfg = CascadeConfig(mode="train", qat=True, use_kernel=use_kernel,
                             compute_dtype=torch.bfloat16)
        opt = AdamW(lr=3e-4, warmup_steps=warmup, decay_steps=TRAIN_STEPS)
        state = tloop.init_state(model, ccfg, opt, seed=0, device=dev)
        step = tloop.make_train_step(model, ccfg, opt, remat=True, remat_policy="dots")
        state, run = train_steps(torch, state, step, data)
        del state, step, run["launches_by_step"]
        run["losses"] = [float(x) for x in run["losses"]]
        runs[name] = {"use_kernel": use_kernel, "warmup_steps": warmup, **run}
        gc.collect()
        torch.cuda.empty_cache()
    plain = runs["plain_route"]
    lk, lp = kernel_run["losses"], plain["losses"]
    rec = {"kernel_route": {k: kernel_run[k] for k in ("losses", "gnorms", "lrs")}, **runs,
           "loss_rel_diff_kernel_vs_plain": [abs(a - b) / abs(b) for a, b in zip(lk, lp)],
           "gnorm_rel_diff_kernel_vs_plain": [abs(a - b) / abs(b) for a, b in
                                              zip(kernel_run["gnorms"], plain["gnorms"])]}
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"] + r["gnorms"]):
        fail(f"train recipe: a loss or gnorm is not finite: {runs}")
    if any(plain["launches"].values()):
        fail(f"train recipe: the plain route launched a kernel: {plain['launches']}")
    if not rec["loss_rel_diff_kernel_vs_plain"][0] <= 2.0 ** -7:
        fail(f"train recipe: the first loss on the kernels {lk[0]!r} is not within a bf16 step "
             f"of the plain route's {lp[0]!r}")
    return rec


def precision_sim_phase(torch, dev):
    """codeqwen1.5-7b at full width, depth SIM_DEPTH: a forward with
    ``precision_sim`` through the exact CASCADE kernel (every linear, the
    92,416-wide head among them), bit-equal to the same forward with that
    kernel on its plain version, and read against the same forward on the
    FP4 kernel route."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config("codeqwen1.5-7b"), n_layers=SIM_DEPTH)
    model = registry.build_model(cfg)
    fp4 = CascadeConfig(mode="serve_fp4", use_kernel=True, compute_dtype=torch.bfloat16)
    sim = dataclasses.replace(fp4, precision_sim=True)
    params = model.init_params(5, fp4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (SIM_ROWS, SIM_LEN), device=dev,
                                     generator=gen)}
    with torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out_sim = model.forward(params, batch, sim)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(ops.LAUNCHES)
        out_fp4 = model.forward(params, batch, fp4)
        prof = profile_call(torch, lambda: model.forward(params, batch, sim).shape[0])
        t0 = time.monotonic()
        with plain_versions_on_card(only=("cascade_matmul_exact_cuda",)):
            out_plain = model.forward(params, batch, sim)
        torch.cuda.synchronize()
        plain_wall = time.monotonic() - t0
    want = QAT_LINEARS * SIM_DEPTH + 1
    if launches["cascade_matmul_exact"] != want or launches["cascade_matmul"]:
        fail(f"precision_sim: launches {launches}, expected {want} cascade_matmul_exact and no "
             f"cascade_matmul")
    if not bool(torch.isfinite(out_sim).all()):
        fail("precision_sim: non-finite logits")
    if not same_bits(torch, out_sim, out_plain):
        fail("precision_sim: the forward through the exact kernel differs from the same "
             "forward with the kernel on its plain version")
    rel = float(torch.linalg.vector_norm(out_sim - out_fp4)
                / torch.linalg.vector_norm(out_fp4))
    top1 = float((out_sim.argmax(-1) == out_fp4.argmax(-1)).float().mean())
    return {"arch": "codeqwen1.5-7b", "layers": SIM_DEPTH, "rows": [SIM_ROWS, SIM_LEN],
            "launches": launches, "wall_s": wall, "plain_route_wall_s": plain_wall,
            "bit_equal_plain_route": True, "rel_l2_vs_fp4_route": rel,
            "top1_agreement": top1, "logit_absmax": float(out_sim.abs().max()),
            "profiled_forward": {k: prof[k] for k in ("device_busy_ms", "device_kernels",
                                                      "our_kernels", "top_kernels")}}


RESTART_DIR = ROOT / "results" / "restart_ckpt"


def restart_child() -> int:
    """The restart phase's body, in its own process (cuBLAS reads
    CUBLAS_WORKSPACE_CONFIG when it starts): smoke phi4-mini on the card
    through the kernels, 6 steps uninterrupted with an async save after step
    3, then a fresh state restored from it and steps 4-6 again, under
    deterministic algorithms. Prints one JSON line."""
    import shutil
    import warnings

    import torch
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda")
    shutil.rmtree(RESTART_DIR, ignore_errors=True)
    cfg, model = registry.load(TRAIN_ARCH, smoke=True)
    ccfg = CascadeConfig(mode="train", qat=True, use_kernel=True, compute_dtype=torch.bfloat16)
    opt = AdamW(lr=3e-3, warmup_steps=2, decay_steps=6)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    step = tloop.make_train_step(model, ccfg, opt, remat=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = tloop.init_state(model, ccfg, opt, seed=0, device=dev)
        losses, saver = [], None
        for i in range(6):
            state, m = step(state, data.batch_at(i))
            losses.append(m["loss"])
            if i == 2:
                saver = ckpt.save(state, str(RESTART_DIR), 3, extra={"data_step": 3},
                                  async_=True)
        saver.join()
        resumed, extra = ckpt.restore(tloop.init_state(model, ccfg, opt, seed=1, device=dev),
                                      str(RESTART_DIR))
        tail = []
        for i in range(extra["data_step"], 6):
            resumed, m = step(resumed, data.batch_at(i))
            tail.append(m["loss"])
    shutil.rmtree(RESTART_DIR, ignore_errors=True)
    named = sorted({str(w.message).split(" does not have a deterministic")[0]
                    for w in caught if "deterministic" in str(w.message)})
    print(json.dumps({
        "losses": [float(x) for x in losses], "resumed_tail": [float(x) for x in tail],
        "tail_bit_equal": all(torch.equal(a, b) for a, b in zip(tail, losses[3:])),
        "params_bit_equal": all(torch.equal(a.detach(), b.detach()) for a, b in
                                zip(T.leaves(resumed.params), T.leaves(state.params))),
        "max_rel_diff": max(abs(float(a) - float(b)) / abs(float(b))
                            for a, b in zip(tail, losses[3:])),
        "nondeterministic_ops": named}), flush=True)
    return 0


def restart_phase(torch, dev):
    """Checkpoint and restart on the card, in a subprocess with
    CUBLAS_WORKSPACE_CONFIG set: the resumed tail's losses must equal the
    uninterrupted run's bit for bit, or, where an op with no deterministic
    CUDA path ran (named), within the reference demo's rtol 1e-6."""
    import os
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--restart-child"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    if res.returncode != 0:
        fail(f"restart: the child failed ({res.returncode}): {res.stderr[-3000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    ok = rec["tail_bit_equal"] or (rec["nondeterministic_ops"] and rec["max_rel_diff"] <= 1e-6)
    if not ok:
        fail(f"restart: the resumed losses differ from the uninterrupted run's: {rec}")
    return rec


def examples_phase(torch, dev):
    """Both examples with ``--fused`` on the card (the replicas and the FP4
    forward through the kernels), their printed numbers checked: every one
    finite; the quickstart's FP4 kernel path within QUICKSTART_EXACT_TOL of
    its bf16 round-tripped dense forward and its oracle's max |sum| equal to
    the CPU run's on the same inputs; CREST 5 of 5 detected, none falsely, 5
    repaired; 9 of 9 requests completed after the failover; the resumed
    tail bit-equal to the uninterrupted one, or, where an op with no
    deterministic CUDA path ran (named by a rerun under deterministic
    algorithms), within the reference demo's rtol 1e-6."""
    import warnings
    from repro_torch.examples import fault_tolerance_demo as demo
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    ops.reset_launch_counts()
    qs = quickstart.main(["--fused"])
    qs["launches"] = dict(ops.LAUNCHES)
    ins = quickstart.inputs(registry.get_config(quickstart.ARCH, smoke=True).vocab)
    qs["cpu_oracle_max_abs_sum"] = quickstart.matmul_three_ways(ins["w"], ins["x"])[
        "oracle_max_abs_sum"]
    numbers = [qs[k] for k in ("dense_bytes", "fp4_bytes", "exactness", "fp4_vs_dense",
                               "kernel_vs_ref", "oracle_max_abs_sum")]
    if not (all(math.isfinite(v) for v in numbers) and qs["finite"]):
        fail(f"quickstart --fused: a number is not finite: {qs}")
    if not qs["exactness"] <= QUICKSTART_EXACT_TOL:
        fail(f"quickstart --fused: FP4 kernel path vs round-tripped dense {qs['exactness']} > "
             f"{QUICKSTART_EXACT_TOL}")
    if qs["oracle_max_abs_sum"] != qs["cpu_oracle_max_abs_sum"]:
        fail(f"quickstart --fused: the oracle's max |sum| {qs['oracle_max_abs_sum']} differs "
             f"from the CPU run's {qs['cpu_oracle_max_abs_sum']}")
    for k in ("cascade_matmul", "flash_attention", "norm", "cascade_matmul_exact"):
        if not qs["launches"][k]:
            fail(f"quickstart --fused launched no {k}: {qs['launches']}")

    ops.reset_launch_counts()
    dm = demo.main(["--fused"])
    dm["launches"] = dict(ops.LAUNCHES)
    cr, fip, ck = dm["crest"], dm["fail_in_place"], dm["checkpoint_restart"]
    if (cr["detected"], cr["false_positives"], cr["repaired"]) != (5, 0, 5) \
            or not math.isfinite(cr["post_repair_max_err"]):
        fail(f"fault_tolerance_demo --fused: CREST {cr}")
    if fip["completed"] != fip["requests"] or fip["effective_mode"] != "batched-greedy-fused":
        fail(f"fault_tolerance_demo --fused: fail-in-place {fip}")
    for k in ("cascade_matmul", "decode_attention", "flash_attention", "norm"):
        if not dm["launches"][k]:
            fail(f"fault_tolerance_demo --fused launched no {k}: {dm['launches']}")
    if not all(math.isfinite(v) for v in ck["losses"] + ck["resumed_tail"]):
        fail(f"fault_tolerance_demo --fused: a loss is not finite: {ck}")
    ck["nondeterministic_ops"] = []
    if not ck["tail_bit_equal"]:
        from repro_torch.core.cascade import CascadeConfig
        from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
        from repro_torch.optim.adamw import AdamW
        cfg, model = registry.load("phi4-mini-3.8b", smoke=True)
        tccfg = CascadeConfig(mode="train", compute_dtype=torch.float32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                demo.demo_checkpoint_restart(
                    model, tccfg, model.init_params(0, tccfg, device=dev),
                    SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)),
                    AdamW(lr=1e-3, warmup_steps=2, decay_steps=10))
            finally:
                torch.use_deterministic_algorithms(False)
        ck["nondeterministic_ops"] = sorted({str(w.message).split(" does not have a "
                                                                  "deterministic")[0]
                                             for w in caught
                                             if "deterministic" in str(w.message)})
        if not (ck["nondeterministic_ops"] and ck["max_rel_diff"] <= 1e-6):
            fail(f"fault_tolerance_demo --fused: the resumed tail differs: {ck}")
    fip.pop("streams")
    return {"quickstart": qs, "fault_tolerance_demo": dm}


def sync_contrast(torch, dev):
    """A closure that reads ``.item()`` on the card must trip both witnesses:
    the census (``aten._local_scalar_dense``) and
    ``torch.cuda.set_sync_debug_mode`` (a warning under "warn", an error
    under "error"); the same closure without the read trips neither."""
    from repro_torch.analysis import census, contract
    from repro_torch.analysis.findings import gating

    x = torch.arange(8, dtype=torch.float32, device=dev)
    reading = lambda t: t * t.sum().item()
    _, c = census.record(reading, (x,))
    _, fs = contract.audit_step("contrast", reading, (x,), contract.ServingContract(),
                                takes_params=False)
    _, clean = census.record(lambda t: t * 2, (x,))
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        reading(x)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    res = {"census_host_reads": c.host_reads, "sync_warnings": c.sync_warnings,
           "error_mode_raised": raised, "gating_findings": [f.to_dict() for f in gating(fs)],
           "clean_host_reads": len(clean.host_reads),
           "clean_sync_warnings": len(clean.sync_warnings)}
    if not (c.host_reads and c.sync_warnings and "synchroniz" in raised and gating(fs)
            and not clean.host_reads and not clean.sync_warnings):
        fail(f"sync contrast: the .item() closure did not trip both witnesses: {res}")
    return res


def audit_phase(torch, dev):
    """The audit matrix on the card (``repro_torch.analysis.audit.run_cell``):
    the four families' smoke configs x AUDIT_MODES, and codeqwen1.5-7b at full
    width x AUDIT_FULL_MODES (one FP4 params tree). Each cell serves its trace
    twice (the second run may build or plan nothing new), then every step
    closure is called under the census and the sync witness and held to the
    serving contract. Fails on any gating finding, a cell whose trace did not
    complete, a lint finding that gates, a downgraded cell that
    ``audit.EXPECTED_DOWNGRADES`` does not name (the full-width pair
    included), or a fused cell off the kernel route."""
    from repro_torch.analysis import audit, lint
    from repro_torch.analysis.findings import Finding, gating
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry

    cells = [audit.run_cell(family, arch, mode, dev)
             for family, arch in registry.FAMILY_SMOKE.items() for mode in AUDIT_MODES]
    arch = registry.FAMILY_SMOKE["transformer"]
    _, model = registry.load(arch)
    params = model.init_params(0, CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16),
                               device=dev)
    for mode in AUDIT_FULL_MODES:
        cells.append(audit.run_cell(
            "transformer", arch, mode, dev, smoke=False, n_requests=AUDIT_REQ,
            prompt_len=AUDIT_PROMPT, max_new=AUDIT_NEW, params=params, max_batch=MAX_BATCH,
            max_len=AUDIT_PROMPT + AUDIT_NEW + CHUNK, prefill_chunk=CHUNK, temperature=0.8,
            top_k=50, draft_len=DRAFT_LEN, page_size=PAGE_SIZE))
    del params
    # a cell the engine downgrades passes no closure through the audit: only
    # the table's cells may, and every other fused cell runs the kernels
    downgraded = {(c["family"], c["mode"]) for c in cells if c["status"] == "downgraded"}
    expected = {(f, m) for f in registry.FAMILY_SMOKE for m in AUDIT_MODES
                if (f, m) in audit.EXPECTED_DOWNGRADES}
    if downgraded != expected:
        fail(f"audit: downgraded cells {sorted(downgraded)}, expected {sorted(expected)}")
    unfused = [(c["arch"], c["mode"], c["smoke"]) for c in cells if c["status"] == "audited"
               and c["mode"].startswith("fused") and c.get("route") != "kernel"]
    if unfused:
        fail(f"audit: fused cells not on the kernel route: {unfused}")
    lint_fs = lint.lint_paths(["src/repro_torch"], base=ROOT)
    out = {"lint_findings": len(lint_fs), "lint_allowlisted": [f.where for f in lint_fs
                                                               if f.allowlisted],
           "cells": []}
    bad = gating(lint_fs)
    for cell in cells:
        fs = [Finding.from_dict(d) for d in cell["findings"]]
        bad += gating(fs)
        n = cell.get("trace", {}).get("requests", 0)
        if cell["status"] == "audited" and cell["trace"]["completed"] != 2 * n:
            fail(f"audit {cell['arch']}/{cell['mode']}: the trace did not complete: "
                 f"{cell['trace']}")
        out["cells"].append({
            "family": cell["family"], "arch": cell["arch"], "mode": cell["mode"],
            "smoke": cell["smoke"], "status": cell["status"], "route": cell.get("route"),
            "effective_mode": cell["effective_mode"], "downgrades": cell["downgrades"],
            "closures": {name: {k: st.get(k) for k in (
                "ops", "out_bytes", "host_reads", "host_transfers", "data_shaped_ops",
                "f64_outputs", "densified", "sync_warnings", "cache_major_leaves",
                "cache_leaves_in_place", "packed_params")} for name, st in cell["closures"].items()},
            "allowlisted": [f"{f.check}: {f.where} — {f.detail}" for f in fs if f.allowlisted],
            "info": [f"{f.check}: {f.where}" for f in fs if f.level == "info"]})
    out["gating"] = [f.to_dict() for f in bad]
    if bad:
        fail(f"audit: {len(bad)} gating finding(s): {out['gating']}")
    return out


#: the serve CLI's ``--audit`` runs: (name, arguments, the closures its
#: engine names: ``ServeEngine.step_closures`` of a greedy engine, dense or
#: paged)
SERVE_AUDIT_RUNS = (
    ("codeqwen_fused", ["--arch", "codeqwen1.5-7b", "--fused", "--requests", "4",
                        "--prompt-len", "64", "--max-new", "8", "--max-batch", str(MAX_BATCH)],
     ("decode", "extend", "write", "pick")),
    ("codeqwen_fused_prefix", ["--arch", "codeqwen1.5-7b", "--fused", "--prefix-cache",
                               "--requests", "4", "--prompt-len", "64", "--max-new", "8",
                               "--max-batch", str(MAX_BATCH)],
     ("decode", "extend", "copy_page", "reset_pos", "pick")),
    ("smoke_mesh_1x2", ["--smoke", "--host-devices", "2", "--mesh", "1x2", "--fused",
                        "--requests", "4", "--max-new", "4"],
     ("decode", "extend", "write", "pick")))


def serve_audit_runs() -> dict:
    """``python -m repro_torch.launch.serve ... --audit`` in a child process
    for each of ``SERVE_AUDIT_RUNS``, as a user runs it: it must exit 0,
    print one ``audit <closure>:`` line for every closure its engine names
    and a summary with no gating finding, and then serve (the mesh run: two
    gloo ranks sharing the card, each auditing its own engine)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {}
    for name, args, closures in SERVE_AUDIT_RUNS:
        t0 = time.monotonic()
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args, "--audit"],
                             capture_output=True, text=True, timeout=600, env=env,
                             cwd=str(ROOT))
        lines = res.stdout.splitlines()
        closure_lines = [ln for ln in lines if re.match(r"audit \w+:", ln)]
        audited = [ln.split(":")[0].split()[1] for ln in closure_lines]
        summary = [ln for ln in lines if ln.startswith("audit: ")]
        rec = {"rc": res.returncode, "wall_s": time.monotonic() - t0, "closures": audited,
               "summary": summary, "served": [ln for ln in lines if ln.startswith("served")],
               "closure_lines": closure_lines}
        if res.returncode != 0 or sorted(audited) != sorted(closures) or len(summary) != 1 \
                or not summary[0].endswith(" 0 gating") or not rec["served"] \
                or "SERVING CONTRACT VIOLATED" in res.stdout:
            fail(f"serve --audit {name}: {rec}; stderr: {res.stderr[-3000:]}")
        out[name] = rec
    return out


def examples_and_audit_phase(torch, dev):
    """Phase 5: the two examples, the audit matrix, the serve CLI's
    ``--audit`` runs and the sync contrast."""
    t0 = time.monotonic()
    ex = examples_phase(torch, dev)
    t1 = time.monotonic()
    contrast = sync_contrast(torch, dev)
    au = audit_phase(torch, dev)
    t2 = time.monotonic()
    cli = serve_audit_runs()
    return {"gpu": gpu_name_and_power(), "examples": ex, "sync_contrast": contrast,
            "audit": au, "serve_audit": cli, "examples_s": t1 - t0, "audit_s": t2 - t1,
            "serve_audit_s": time.monotonic() - t2}


# ---------------------------------------------------------------------------
# phase 6: multi-device serving (explicit SPMD on torch.distributed)
# ---------------------------------------------------------------------------

#: the mesh phase: MESH_REQ requests of MESH_PROMPT + MESH_NEW tokens a run,
#: MAX_BATCH slots, chunks of CHUNK; the contexts stay under 256 keys, where
#: no attention launch splits over the keys at any batch (a data shard runs
#: half the grid's rows: past 256 live keys the attention kernels' plans
#: follow the rows of the call)
MESH_REQ, MESH_PROMPT, MESH_NEW = 8, 64, 16
#: column bands held to the unsharded FP4 matmul: model ranks, rows, shapes
#: (codeqwen1.5-7b's projections and head, llama3.1-405b's)
MESH_BANDS = (2, 4, 8)
MESH_ROWS = MAX_BATCH
MESH_MATMUL = (("codeqwen1.5-7b", 4096, 4096), ("codeqwen1.5-7b", 4096, 13440),
               ("codeqwen1.5-7b", 13440, 4096), ("codeqwen1.5-7b", 4096, 92416),
               ("llama31_405b", 16384, 16384), ("llama31_405b", 16384, 65536),
               ("llama31_405b", 65536, 16384), ("llama31_405b", 16384, 128000))
#: the grouped expert kernel on olmoe-1b-7b's N bands: (K, N, pair) at C =
#: MAX_BATCH rows an expert, top-8 of 64 routed
MESH_GROUPED = ((2048, 1024, True), (1024, 2048, False))
MESH_GROUPED_BANDS = (2, 4)
#: EP MoE layer (olmoe-1b-7b at full width, bf16, the grouped kernel) on
#: (1, 2) against the unsharded drop-free layer: bf16 outputs of the same
#: expert products summed in another grouping
MESH_EP_RTOL = 2.0 ** -6
#: keys of the attention band check: past 256, where a launch over half the
#: grid's rows would split otherwise than one over all of them
MESH_ATTN_T = 1024
#: layers of the gloo worlds' models (full width): ranks sharing the card
#: all-gather each linear's bands through gloo, which makes a step several
#: times slower than one rank alone, so depth is cut to keep the phase near
#: two minutes (codeqwen's 16 cut to 8 when the placements phase came, to
#: keep the whole smoke near its earlier length)
MESH_DEPTH = {"codeqwen1.5-7b": 8, "olmoe-1b-7b": 8, "mamba2-370m": 8}


def random_fp4(torch, gen, dev, k: int, n: int, experts: int = 0):
    """Random packed FP4 codes and positive per-column scales (the band
    check needs no quantized matrix: every code pattern is a weight)."""
    lead = (experts,) if experts else ()
    codes = torch.randint(0, 256, lead + (k // 2, n), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.uint8)
    scales = torch.rand(lead + (1, n), generator=gen, device=dev) * 0.02 + 1e-3
    return codes, scales


def column_band_phase(torch, dev):
    """(a) each rank's output columns, computed from its band of the packed
    weight (its own contiguous copy, as ``shard_tree`` cuts it), equal the
    same columns of the unsharded kernel's output bit for bit."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []
    for arch, k, n in MESH_MATMUL:
        codes, scales = random_fp4(torch, gen, dev, k, n)
        x = torch.randn((MESH_ROWS, k), generator=gen, device=dev).to(torch.bfloat16)
        full = ops.cascade_matmul(x, codes, scales, out_dtype=torch.bfloat16)
        for m in MESH_BANDS:
            w = n // m
            equal = all(torch.equal(
                ops.cascade_matmul(x, codes[:, r * w:(r + 1) * w].contiguous(),
                                   scales[:, r * w:(r + 1) * w].contiguous(),
                                   out_dtype=torch.bfloat16),
                full[:, r * w:(r + 1) * w]) for r in range(m))
            rows.append({"kernel": "cascade_matmul", "arch": arch, "K": k, "N": n, "m": m,
                         "band": w, "band_mod_32": w % 32, "bit_equal": equal})
        del codes, scales, full
    e, top = 64, 8
    for k, n, pair in MESH_GROUPED:
        stacks = [random_fp4(torch, gen, dev, k, n, e) for _ in range(2 if pair else 1)]
        # C tokens routed top-8 of 64: each expert's rows, x zero past them
        choice = torch.stack([torch.randperm(e, generator=gen, device=dev)[:top]
                              for _ in range(MAX_BATCH)])
        rcount = torch.bincount(choice.reshape(-1), minlength=e).to(torch.int32)
        x = torch.randn((e, MAX_BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
        x = x * (torch.arange(MAX_BATCH, device=dev)[None, :, None] < rcount[:, None, None])
        if pair:
            full = ops.cascade_matmul_grouped_pair(x, stacks[0], stacks[1], rcount,
                                                   out_dtype=torch.bfloat16)
        else:
            full = (ops.cascade_matmul_grouped(x, *stacks[0], rcount, out_dtype=torch.bfloat16),)
        for m in MESH_GROUPED_BANDS:
            w = n // m
            band = lambda t, r: t[..., r * w:(r + 1) * w].contiguous()
            equal = True
            for r in range(m):
                parts = [(band(c, r), band(s, r)) for c, s in stacks]
                got = (ops.cascade_matmul_grouped_pair(x, parts[0], parts[1], rcount,
                                                       out_dtype=torch.bfloat16) if pair
                       else (ops.cascade_matmul_grouped(x, *parts[0], rcount,
                                                        out_dtype=torch.bfloat16),))
                equal &= all(torch.equal(g, f[..., r * w:(r + 1) * w]) for g, f in zip(got, full))
            rows.append({"kernel": "cascade_matmul_grouped" + ("_pair" if pair else ""),
                         "arch": "olmoe-1b-7b", "E": e, "C": MAX_BATCH, "K": k, "N": n, "m": m,
                         "band": w, "bit_equal": bool(equal)})
    rows += attention_band_rows(torch, dev, gen)
    bad = [r for r in rows if not r["bit_equal"]]
    if bad:
        fail(f"mesh: a rank's band differs from the unsharded kernel's output: {bad}")
    return rows


def attention_band_rows(torch, dev, gen):
    """Decode attention (codeqwen's step) and flash attention (its verify
    pass) over half the slot grid, as a data shard runs them, under
    ``ops.planned_rows``: each row equal to the whole grid's call bit for
    bit at MESH_ATTN_T keys (unplanned, the half's plan splits otherwise)."""
    from repro_torch.kernels import ops
    b, h, d, t, s = MAX_BATCH, 32, 128, MESH_ATTN_T, 1 + DRAFT_LEN
    half = b // 2
    k = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.randint(t // 2, t, (b,), generator=gen, device=dev, dtype=torch.int32)
    qv = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
    off = (pos - s).clamp(min=0).to(torch.int32)
    calls = {"decode_attention": lambda lo, hi: ops.decode_attention(
                 q[lo:hi], k[lo:hi], v[lo:hi], q_pos=pos[lo:hi]),
             "flash_attention": lambda lo, hi: ops.flash_attention(
                 qv[lo:hi], k[lo:hi].transpose(1, 2), v[lo:hi].transpose(1, 2),
                 q_offset=off[lo:hi])}
    rows = []
    for name, call in calls.items():
        full = call(0, b)
        unplanned = all(torch.equal(call(r * half, (r + 1) * half), full[r * half:(r + 1) * half])
                        for r in range(2))
        with ops.planned_rows(half, b):
            planned = all(torch.equal(call(r * half, (r + 1) * half),
                                      full[r * half:(r + 1) * half]) for r in range(2))
        rows.append({"kernel": name, "B": b, "rows": half, "T": t, "H": h, "N": None, "m": 2,
                     "bit_equal": planned, "bit_equal_unplanned": unplanned})
    return rows


def mesh_prompts(vocab: int, repetitive: bool):
    import numpy as np
    rng = np.random.default_rng(11)
    if repetitive:
        return [np.tile(rng.integers(0, vocab, 4).astype(np.int32), MESH_PROMPT // 4)
                for _ in range(MESH_REQ)]
    return [rng.integers(0, vocab, MESH_PROMPT).astype(np.int32) for _ in range(MESH_REQ)]


def mesh_scfg(**kw):
    from repro_torch.serve.engine import ServeConfig
    return ServeConfig(**{"max_batch": MAX_BATCH, "max_len": MESH_PROMPT + MESH_NEW + 1,
                          "prefill_chunk": CHUNK, "fused": True, **kw})


def mesh_serve(torch, eng, prompts) -> dict:
    """Serve ``prompts`` through a (mesh) engine: the streams, the launches
    (counted from zero just before), each closure's collectives in its last
    call, step times and peak memory."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MESH_NEW) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = collectives.snapshot()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    m = eng.metrics()
    return {"streams": [r.tokens_out for r in reqs], "launches": dict(ops.LAUNCHES),
            "wall_s": time.monotonic() - t0, "step_ms_p50": m["step_time_p50_s"] * 1e3,
            "step_ms_p99": m["step_time_p99_s"] * 1e3, "effective_mode": m["effective_mode"],
            "collectives_per_closure": dict(getattr(eng, "collectives", {})),
            "collectives_run": collectives.since(before),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def mesh_model(arch: str):
    """(cfg, model) of ``arch`` at full width, cut to ``MESH_DEPTH`` layers."""
    import dataclasses
    from repro_torch.models import registry
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=MESH_DEPTH[arch])
    return cfg, registry.build_model(cfg)


def mesh_rank(rank: int, shape: tuple, runs: tuple) -> dict:
    """One rank of a gloo world sharing the card: each run of ``runs``
    ((name, arch, tp_policy, draft_len)) draws the arch's seeded params
    (full width, ``MESH_DEPTH`` layers) a fragment at a time, keeping this
    rank's bands of each (``sharding.param_placer``), builds a ServeEngine
    on a ``shape`` mesh from them and serves the mesh prompts; on (1, 2)
    also the EP MoE layer. The peak memory of each run: while the params
    are drawn and cut (``init_peak_gb``), and while it serves
    (``serve_peak_gb``)."""
    import gc as gc_
    import torch
    from repro_torch.core import cascade
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeEngine
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(shape, ("data", "model"))
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    out = {"coords": dict(mesh.coords), "runs": {}}
    for name, arch, policy, draft in runs:
        gc_.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        cfg, model = mesh_model(arch)
        params = model.init_params(0, ccfg, device=dev, place=sharding.param_placer(
            mesh, policy, bool(cfg.tie_embeddings)))
        eng = ServeEngine(model, params, ccfg, mesh_scfg(tp_policy=policy, draft_len=draft),
                          mesh=mesh, device=dev)
        del params
        gc_.collect()
        torch.cuda.synchronize()
        init = {"init_s": time.monotonic() - t0,
                "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "bands_gb": cascade.num_weight_bytes(eng.params) / 1e9,
                "held_gb": torch.cuda.memory_allocated() / 1e9}
        torch.cuda.reset_peak_memory_stats()
        res = mesh_serve(torch, eng, mesh_prompts(cfg.vocab, repetitive=draft > 0))
        out["runs"][name] = {**res, **init}
        del eng
    gc_.collect()
    torch.cuda.empty_cache()
    if shape == (1, 2):
        out["ep"] = mesh_ep_layer(torch, dev, mesh)
    return out


def mesh_ep_layer(torch, dev, mesh) -> dict:
    """``moe_ffn_apply_ep`` on this rank's 32 of olmoe-1b-7b's 64 experts
    (layer 0 of the seeded full-width model, FP4, the grouped kernel)
    against the unsharded drop-free layer on the same 8 tokens."""
    import dataclasses
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.distributed import sharding
    from repro_torch.models import registry
    from repro_torch.models.moe import moe_ffn_apply, moe_ffn_init
    from repro_torch.models.moe_shardmap import moe_ffn_apply_ep
    cfg = dataclasses.replace(registry.get_config("olmoe-1b-7b"), moe_capacity_factor=50.0)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    layer = moe_ffn_init(gen, cfg, ccfg, device=dev)
    x = (torch.randn((MAX_BATCH, 1, cfg.d_model), generator=gen, device=dev)).to(torch.bfloat16)
    specs = sharding.filter_divisible(sharding.param_specs(layer, "megatron"), layer, mesh)
    local = sharding.shard_tree(layer, specs, mesh)
    y_ep = moe_ffn_apply_ep(local, x, cfg, ccfg, mesh)
    y = moe_ffn_apply(layer, x, cfg, ccfg, no_drop=True)
    err = (y_ep.float() - y.float()).abs()
    return {"experts_local": int(local["wg"]["codes"].shape[0]),
            "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / (MESH_EP_RTOL * y.float().abs().amax())).max())}


def first_stream_departure(ref: list, got: list):
    """(request, token index) of the first token where ``got`` departs from
    ``ref``, or None."""
    for i, (a, b) in enumerate(zip(ref, got)):
        j = next((t for t, (p, q) in enumerate(zip(a, b)) if p != q), None)
        if j is not None:
            return i, j
    return None


class _MeshRank:
    """Rank ``model`` of a (1, m) mesh, as ``sharding.shard_tree`` reads it."""

    def __init__(self, m: int, model: int):
        self.shape, self.coords = {"data": 1, "model": m}, {"data": 0, "model": model}

    def size(self, axis):
        return self.shape.get(axis, 1)

    def coord(self, axis):
        return self.coords.get(axis, 0)


def llama_bands(torch, m: int = 8) -> dict:
    """llama3.1-405b's packed FP4 weights, whole and rank 0's cascade bands
    on a (1, ``m``) mesh, from its tree drawn on the meta device (no
    memory): what one rank of ``torchrun --nproc-per-node 8 ... --mesh
    1x8`` would hold."""
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.distributed import sharding
    from repro_torch.models import registry
    cfg = registry.get_config("llama31_405b")
    meta = registry.build_model(cfg).init_params(
        0, CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16), device="meta")
    mesh = _MeshRank(m, 0)
    band = sharding.shard_tree(meta, sharding.placed_param_specs(meta, mesh), mesh)
    gb = lambda tree: sum(t.numel() * t.element_size() for t in T.leaves(tree)) / 1e9
    layer = T.tree_map(lambda t: t[0], meta["layers"])
    return {"layers": cfg.n_layers, "m": m, "whole_gb": gb(meta), "rank_bands_gb": gb(band),
            "whole_layer_gb": gb(layer), "embed_gb": gb(meta["embed"])}


def mesh_phase(torch, dev):
    """Phase 6 (``mesh``): (a) column bands bit-equal at full width; (b) a
    world of one rank over NCCL: ``allreduce_compressed`` bit-equal to the
    same call on the CPU, and the (1, 1) mesh engine's streams equal to the
    mesh-less engine's; (c) gloo worlds of 2 and 4 ranks sharing the card:
    codeqwen1.5-7b cascade on (1, 2) and (2, 2), plain and speculative,
    every stream the single-rank fused engine's and no partial-sum
    all-reduce; megatron on (1, 2) (its all-reduces counted, its first
    departure from cascade read with the reference's top-2 margin);
    olmoe-1b-7b cascade on (1, 2); the EP MoE layer on (1, 2)."""
    import gc as gc_
    import torch.distributed as dist
    from repro_torch.core import cascade
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import registry
    from repro_torch.optim import grad_compression as gcmp
    from repro_torch.serve.engine import ServeEngine

    out = {"gpu": gpu_name_and_power(),
           "note": "ranks of a gloo world share ONE H100 (time-sliced processes): the step "
                   "times are not a multi-GPU reading",
           "requests": MESH_REQ, "prompt_len": MESH_PROMPT, "max_new": MESH_NEW,
           "max_batch": MAX_BATCH,
           "cuts": [f"the gloo worlds' models at {MESH_DEPTH} layers (full width): each "
                    "linear's bands meet through gloo between ranks sharing one card, "
                    "which at full depth takes the phase well past two minutes",
                    "contexts of 64 + 16 tokens in the served runs (the attention bands "
                    f"are checked at {MESH_ATTN_T} keys in (a))"]}
    print(json.dumps({"mesh_cuts": out["cuts"]}), flush=True)
    out["llama31_405b_bands"] = llama_bands(torch)
    t0 = time.monotonic()
    out["column_bands"] = column_band_phase(torch, dev)
    out["column_bands_s"] = time.monotonic() - t0

    # (b) NCCL, a world of one rank, in this process
    meshlib.init_world(0, 1, meshlib.free_port(), "nccl")
    try:
        cpu_group = dist.new_group(backend="gloo")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(3)
        grads = {"w": torch.randn((4096, 1024), generator=gen), "b": torch.randn((4096,), generator=gen)}
        res = {k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in grads.items()}
        m_cpu, r_cpu = gcmp.allreduce_compressed(grads, res, cpu_group)
        m_gpu, r_gpu = gcmp.allreduce_compressed({k: v.to(dev) for k, v in grads.items()},
                                                 {k: v.to(dev) for k, v in res.items()},
                                                 dist.group.WORLD)
        comp_equal = all(torch.equal(m_cpu[k], m_gpu[k].cpu()) and
                         torch.equal(r_cpu[k], r_gpu[k].cpu()) for k in grads)
        if not comp_equal:
            fail("mesh: allreduce_compressed over NCCL differs from the same call on the CPU")
        out["nccl_world1"] = {"allreduce_compressed_bit_equal": comp_equal,
                              "backend": dist.get_backend()}

        arch = "codeqwen1.5-7b"
        cfg, model = registry.load(arch)
        ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
        params = model.init_params(0, ccfg, device=dev)
        out["packed_weights_gb"] = {arch: cascade.num_weight_bytes(params) / 1e9}
        prompts = mesh_prompts(cfg.vocab, repetitive=False)
        alone, _, reqs, _ = serve_run(torch, dev, arch, model, params, ccfg, prompts,
                                      "mesh_meshless", max_new=MESH_NEW,
                                      max_len=MESH_PROMPT + MESH_NEW + 1)
        mesh11 = meshlib.make_mesh((1, 1), ("data", "model"))
        eng = ServeEngine(model, params, ccfg, mesh_scfg(), mesh=mesh11, device=dev)
        one = mesh_serve(torch, eng, prompts)
        del eng, params
        if one["streams"] != [r.tokens_out for r in reqs]:
            fail(f"mesh: the (1, 1) NCCL mesh engine departs from the mesh-less engine at "
                 f"{first_stream_departure([r.tokens_out for r in reqs], one['streams'])}")
        out["nccl_world1"]["mesh_1x1"] = {
            "layers": cfg.n_layers, "streams_equal": True, "step_ms_p50": one["step_ms_p50"],
            "meshless_step_ms_p50": alone["step_ms_p50"], "collectives": one["collectives_run"]}
        # the gloo worlds' references: one rank alone, the same cut models
        refs = {}
        for key, rarch, draft in (("plain", arch, 0), ("spec", arch, DRAFT_LEN),
                                  ("olmoe", "olmoe-1b-7b", 0)):
            gc_.collect()
            torch.cuda.empty_cache()
            rcfg, rmodel = mesh_model(rarch)
            rparams = rmodel.init_params(0, ccfg, device=dev)
            run, _, reqs, rec = serve_run(torch, dev, rarch, rmodel, rparams, ccfg,
                                          mesh_prompts(rcfg.vocab, repetitive=draft > 0),
                                          f"mesh_ref_{key}", margins=True, max_new=MESH_NEW,
                                          max_len=MESH_PROMPT + MESH_NEW + 1, draft_len=draft)
            refs[key] = {"streams": [r.tokens_out for r in reqs], "top2": rec["top2"],
                         "step_ms_p50": run["step_ms_p50"], "peak_mem_gb": run["peak_mem_gb"],
                         "packed_weights_gb": cascade.num_weight_bytes(rparams) / 1e9}
            del rparams
        out["references"] = {k: {f: v[f] for f in ("step_ms_p50", "peak_mem_gb",
                                                   "packed_weights_gb")}
                             for k, v in refs.items()}
    finally:
        dist.destroy_process_group()
    gc_.collect()
    torch.cuda.empty_cache()

    # (c) gloo worlds sharing the card
    t1 = time.monotonic()
    two = meshlib.run_local_ranks(2, mesh_rank, (1, 2), (
        ("cascade_plain", "codeqwen1.5-7b", "cascade", 0),
        ("cascade_spec", "codeqwen1.5-7b", "cascade", DRAFT_LEN),
        ("megatron_plain", "codeqwen1.5-7b", "megatron", 0),
        ("megatron_tied", "mamba2-370m", "megatron", 0),
        ("olmoe_cascade", "olmoe-1b-7b", "cascade", 0)), threads=2)
    four = meshlib.run_local_ranks(4, mesh_rank, (2, 2), (
        ("cascade_plain", "codeqwen1.5-7b", "cascade", 0),
        ("cascade_spec", "codeqwen1.5-7b", "cascade", DRAFT_LEN)), threads=2)
    out["gloo_worlds_s"] = time.monotonic() - t1
    worlds = {"1x2": two, "2x2": four}
    summary = {}
    for wname, ranks in worlds.items():
        for run in ranks[0]["runs"]:
            tied = run == "megatron_tied"        # mamba2-370m: no single-rank reference
            ref = refs["olmoe" if run.startswith("olmoe") else
                       "spec" if run.endswith("spec") else "plain"]
            per_rank = [r["runs"][run] for r in ranks]
            dec = "verify" if run.endswith("spec") else "decode"
            psum = [collectives.partial_sum_allreduces(p["collectives_per_closure"][dec])
                    for p in per_rank]
            rec = {"streams_equal_single_rank": None if tied else all(
                       p["streams"] == ref["streams"] for p in per_rank),
                   "ranks_agree": all(p["streams"] == per_rank[0]["streams"] for p in per_rank),
                   f"{dec}_collectives_rank0": per_rank[0]["collectives_per_closure"][dec],
                   "partial_sum_allreduces_per_step": psum,
                   "launches_rank0": per_rank[0]["launches"],
                   "step_ms_p50": [p["step_ms_p50"] for p in per_rank],
                   "single_rank_step_ms_p50": None if tied else ref["step_ms_p50"],
                   "init_s": [p["init_s"] for p in per_rank],
                   "init_peak_gb": [p["init_peak_gb"] for p in per_rank],
                   "bands_gb": [p["bands_gb"] for p in per_rank],
                   "held_gb": [p["held_gb"] for p in per_rank],
                   "serve_peak_gb": [p["peak_mem_gb"] for p in per_rank]}
            need = ("cascade_matmul", "norm") + (
                ("ssd_scan",) if tied else
                ("decode_attention" if dec == "decode" else "flash_attention",)) + (
                ("cascade_matmul_grouped",) if run.startswith("olmoe") else ())
            if not all(per_rank[0]["launches"][k] > 0 for k in need):
                fail(f"mesh {wname} {run}: a kernel of the run never launched: "
                     f"{per_rank[0]['launches']}")
            if not rec["ranks_agree"]:
                fail(f"mesh {wname} {run}: the ranks committed different streams")
            if run.startswith("megatron"):
                if not all(len(s) == MESH_NEW for s in per_rank[0]["streams"]) or min(psum) == 0:
                    fail(f"mesh {wname} {run}: megatron did not serve every stream with its "
                         f"all-reduces: {psum}")
                if tied:
                    # the head's vocabulary bands of logits are all-gathered
                    if per_rank[0]["collectives_per_closure"]["decode"]["all_gather"]["calls"] < 1:
                        fail(f"mesh {wname} {run}: the tied head gathered no logits")
                    summary[f"{wname} {run}"] = rec
                    continue
                dep = first_stream_departure(refs["plain"]["streams"], per_rank[0]["streams"])
                rec["first_departure_from_cascade"] = None if dep is None else {
                    "request": dep[0], "token": dep[1],
                    "reference_top2_margin_bf16_steps":
                        top2_margin(refs["plain"]["top2"][dep])[1]}
            else:
                if any(psum):
                    fail(f"mesh {wname} {run}: cascade made partial-sum all-reduces: {psum}")
                if not rec["streams_equal_single_rank"]:
                    fail(f"mesh {wname} {run}: a stream departs from the single-rank fused "
                         f"engine's at {first_stream_departure(ref['streams'], per_rank[0]['streams'])}")
            summary[f"{wname} {run}"] = rec
    out["gloo"] = summary
    ep = two[0]["ep"], two[1]["ep"]
    out["ep_moe_1x2"] = list(ep)
    if max(e["max_err_over_tol"] for e in ep) > 1.0:
        fail(f"mesh: moe_ffn_apply_ep on (1, 2) outside {MESH_EP_RTOL} * max|y|: {ep}")
    return out


# ---------------------------------------------------------------------------
# phase 7 (run before 6): the dry run and the cache's model bands
# ---------------------------------------------------------------------------

#: decode attention with its log-sum-exp at the time-band shapes: (name, B,
#: Hq, Hkv, band rows, D, live): qwen2.5-32b's heads over one 2,048-row band
#: of a 32,768-row cache on a 16-wide axis (rows live up to each slot's
#: position in the band; one slot's position before the band, one past it),
#: and recurrentgemma-2b's ring (10 over 1 head, D = 256) over a 1,024-row
#: band of its 2,048-row ring, live by the window mask
LSE_CASES = (("qwen2.5-32b_time_band", 8, 40, 8, 2048, 128, "q_pos"),
             ("griffin_ring_band", 8, 10, 1, 1024, 256, "mask"))
#: the lse against its plain version: the same f32 max and sum in another
#: order, then a log
LSE_ATOL = 1e-4
#: splits along T at which the lse calls are timed again (where the time goes)
LSE_SPLITS = (1, 2, 4, 8, 16, 32)
#: gloo worlds sharing the card, each family at full width and its
#: published routing with the cache placed by the whole ``cache_specs``:
#: (world shape, ((arch, layers, leading layers whose cache rows must be
#: bit-equal (None: all), the time band's relative tolerance), ...)).
#: qwen2-vl-2b at one layer (no banded attention before a cache write: the
#: whole cache bit-equal) and at its full 28; deepseek-v2-236b at the parity
#: phase's depth 2 (layer 0 dense, layer 1 MLA with 160 experts, top-6), so
#: a routing flip moves only that token's logits; recurrentgemma-2b one (R,
#: R, A) group; mamba2-370m (state bands only) at MESH_DEPTH. A layer after
#: a time-banded attention writes rows computed from the merge's rounding,
#: so past the first layer the rows are held within the tolerance
BAND_WORLDS = (((1, 4), (("qwen2-vl-2b", 1, None, 2.0 ** -6),
                         ("qwen2-vl-2b", 28, 1, 2.0 ** -5))),
               ((1, 2), (("recurrentgemma-2b", 3, None, 2.0 ** -6),
                         ("deepseek-v2-236b", 2, 1, 2.0 ** -6),
                         ("mamba2-370m", MESH_DEPTH["mamba2-370m"], None, 0.0))))
BAND_ROWS, BAND_PROMPT, BAND_STEPS, BAND_MAX_LEN = 4, 64, 8, 128
#: time-band logits against the unsharded step's: the bands' attentions are
#: merged in another order than the one-band softmax sums, in f32, then
#: rounded to bf16 before wo, so a bf16 edge may fall on the other side:
#: max|banded - unsharded| <= rtol * max|unsharded| (the run's rtol in
#: BAND_WORLDS); the same for the cache rows of the layers past the
#: bit-equal ones and for a MoE layer's router input. Logits are held on
#: every token whose routing did not flip: a last-bit difference in the
#: router's input may swap a token's 6th expert for its 7th, and the flips
#: are counted. Past one layer the differences compound through every later
#: layer's bf16 roundings: qwen2-vl-2b at 28 layers read 0.0176 of
#: max|unsharded| on an H100 (its later layers' cache 0.0132), so its rtol
#: is 2^-5, about twice that, as the parity limits are set. Beside it, the
#: same unsharded step through the plain versions (another summation order
#: everywhere, no band) is read as a yardstick
#: the world-1 check: a cell that fits one card, traced by the dry run and
#: run for real beside it (plain route, as the dry run lowers)
WORLD1_ARCH = "codeqwen1.5-7b"
WORLD1_SHAPE = ("decode_b8_t4096", 4096, 8, "decode")
#: the dry run's memory against the card's across the step (the peak of
#: ``max_memory_allocated`` over what was allocated before it): the caching
#: allocator rounds every block up to 512 bytes and cuBLAS takes its
#: workspace from it
WORLD1_MEM_RTOL, WORLD1_MEM_ATOL = 0.02, 64 << 20
#: the 16 x 16 decode cells printed for every arch, under both policies,
#: traced by this many processes at once (host work, 8 cores)
DRYRUN_SHAPES = ("decode_32k", "long_500k")
#: the reference's optimized presets (``optimized_preset``) at these shapes
PRESET_SHAPES = ("train_4k", "prefill_32k")
#: the serving cells traced again under ``--act-policy fulldp`` (cascade)
FULLDP_SHAPES = ("decode_32k", "prefill_32k")
#: sweep processes, started after the build and run beside the card's phases
DRYRUN_WORKERS = 4


def lse_phase(torch, dev):
    """Decode attention with ``return_lse`` at ``LSE_CASES``: the output bit
    for bit the call's without lse, (o, lse) against the plain version's,
    and both calls timed beside ``scaled_dot_product_attention`` on the
    band (it returns no lse: a floor for the library). Where the time goes:
    the kernel again with every key of the band live, and at each count of
    splits along T (``LSE_SPLITS``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    rows = []
    for name, b, hq, hkv, t, d, live in LSE_CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = kc[1], vc[1]
        pos = mask = None
        if live == "q_pos":
            # this band's rows of positions 0 .. 16 * T: one slot before the
            # band (no live key), one past it (every key), the rest inside
            pos = torch.tensor([-1, t + 5] + [t * i // (b - 1) for i in range(1, b - 1)],
                               dtype=torch.int32, device=dev)
            keys = torch.arange(t, device=dev)[None, :] <= pos[:, None]
        else:
            # the ring's first band of rows, as ring_decode_phase's wrapped ring
            positions = [2040 + 300 * i for i in range(b)]
            sp = ring_slot_pos(torch, b, GRIFFIN_WINDOW, [q_ + 1 for q_ in positions], dev)
            p = torch.tensor(positions, dtype=torch.int32, device=dev)
            whole = (sp >= 0) & (sp <= p[:, None]) & (p[:, None] - sp < GRIFFIN_WINDOW)
            mask = whole[:, :t].contiguous()
            keys = mask
        got, lse = ops.decode_attention(q, k, v, mask, q_pos=pos, return_lse=True)
        alone = ops.decode_attention(q, k, v, mask, q_pos=pos)
        want, want_lse = da.decode_attention_plain(q, k, v, mask, None, pos, return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(got, alone):
            fail(f"decode_attention {name}: the output with lse differs from the call without")
        err = float((got - want).abs().max())
        none_live = ~keys.any(dim=1)
        if not torch.equal(torch.isneginf(lse), none_live[:, None].expand_as(lse)):
            fail(f"decode_attention {name}: lse is -inf on other rows than those with no live key")
        fin = ~none_live
        lse_err = float((lse[fin] - want_lse[fin]).abs().max()) if bool(fin.any()) else 0.0
        if not (err <= ATTN_ATOL and lse_err <= LSE_ATOL):
            fail(f"decode_attention {name}: max|err| {err} (tol {ATTN_ATOL}), lse {lse_err} "
                 f"(tol {LSE_ATOL})")
        nc = copies_beyond_l2(k.numel() * 4)
        sets = [(q, k if i == 0 else k.clone(), v if i == 0 else v.clone()) for i in range(nc)]
        with_lse = lambda a, kk, vv: ops.decode_attention(a, kk, vv, mask, q_pos=pos,
                                                          return_lse=True)
        without = lambda a, kk, vv: ops.decode_attention(a, kk, vv, mask, q_pos=pos)
        plain = lambda a, kk, vv: da.decode_attention_plain(a, kk, vv, mask, None, pos,
                                                            return_lse=True)
        lib = lambda a, kk, vv: F.scaled_dot_product_attention(
            a[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=keys[:, None, None, :], enable_gqa=hq != hkv)
        every_key = lambda a, kk, vv: ops.decode_attention(a, kk, vv, return_lse=True)
        by_splits = {s: graph_ms(torch, lambda a, kk, vv, s=s: da.decode_attention_cuda(
            a, kk, vv, mask, q_pos=pos, splits=s, return_lse=True), sets, 50)
            for s in LSE_SPLITS}
        n_live = int(keys.sum())
        nbytes = q.numel() * 2 + 2 * n_live * hkv * d * 2 + b * hq * (d + 1) * 4 + (
            b * 4 if mask is None else b * t)
        flops = 4 * n_live * hq * d
        rows.append({"case": name, "B": b, "Hq": hq, "Hkv": hkv, "band_rows": t, "D": d,
                     "live_keys": n_live, "rows_without_live_key": int(none_live.sum()),
                     "splits": da.choose_splits(b, hkv, hq // hkv, t),
                     "out_bit_equal_without_lse": True, "max_abs_err": err, "tol": ATTN_ATOL,
                     "lse_max_abs_err": lse_err, "lse_tol": LSE_ATOL,
                     "ms": graph_ms(torch, with_lse, sets, 100),
                     "ms_without_lse": graph_ms(torch, without, sets, 100),
                     "plain_ms": graph_ms(torch, plain, sets, 20),
                     "library_ms": graph_ms(torch, lib, sets, 100),
                     "library_note": "scaled_dot_product_attention with the band's boolean "
                                     "mask, no lse (NaN on a row with no live key)",
                     "ms_every_key_live": graph_ms(torch, every_key, sets, 100),
                     "ms_by_splits": by_splits,
                     "bytes": nbytes, "flops": flops,
                     "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
                     "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                                  else "operations")})
        del sets, kc, vc
        torch.cuda.empty_cache()
    return rows


def band_inputs(cfg, seed: int = 29) -> dict:
    """Prompt and decode inputs of a band run, numpy from a seed: tokens, or
    a stub frontend's embeddings and (M-RoPE) positions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = BAND_PROMPT + BAND_STEPS
    if cfg.input_embeds:
        out = {"embeds": rng.standard_normal((BAND_ROWS, n, cfg.d_model)).astype(np.float32)}
        if cfg.mrope_sections:
            out["positions"] = np.broadcast_to(np.arange(n, dtype=np.int32),
                                               (3, BAND_ROWS, n)).copy()
        return out
    return {"tokens": rng.integers(0, cfg.vocab, (BAND_ROWS, n)).astype(np.int32)}


def band_rank(rank: int, shape: tuple, runs: tuple) -> dict:
    """One rank of a gloo world sharing the card: each family of ``runs``
    at full width, a prefill then ``BAND_STEPS`` decode steps through the
    kernels, once unsharded and once with the params on their cascade
    bands and the cache cut by the whole ``cache_specs``; the readings,
    with each decode step's routings (experts and router input) of both."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, registry
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(shape, ("data", "model"))
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    route = moe.route
    rel = lambda g, w: float((g.float() - w.float()).abs().max() / w.float().abs().max())
    out = {}
    for arch, layers, bit_layers, _ in runs:
        t0 = time.monotonic()
        cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers)
        model = registry.build_model(cfg)
        params = model.init_params(0, ccfg, device=dev)
        inp = band_inputs(cfg)

        def batch(lo, hi):
            if "embeds" in inp:
                b = {"inputs_embeds": torch.from_numpy(inp["embeds"][:, lo:hi]).to(dev)}
                if "positions" in inp:
                    b["positions"] = torch.from_numpy(inp["positions"][:, :, lo:hi]).to(dev)
                return b
            return {"tokens": torch.from_numpy(inp["tokens"][:, lo:hi]).to(dev)}

        def run(p, policy, place):
            routes = []

            def record(rp, xf, rcfg):
                gates, idx = route(rp, xf, rcfg)
                routes.append((idx.clone(), xf.float().clone()))
                return gates, idx
            with sharding.activation_policy(policy):
                logits, cache = model.prefill(p, batch(0, BAND_PROMPT), ccfg,
                                              max_len=BAND_MAX_LEN)
                cache = place(cache)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                before = collectives.snapshot()
                got = []
                moe.route = record
                try:
                    for j in range(BAND_STEPS):
                        s = BAND_PROMPT + j
                        logits, cache = model.decode_step(p, batch(s, s + 1), cache, ccfg)
                        got.append(logits.float())
                finally:
                    moe.route = route
                torch.cuda.synchronize()
            return got, cache, dict(ops.LAUNCHES), collectives.since(before), routes

        want, want_cache, _, _, want_routes = run(params, None, lambda c: c)
        with plain_versions_on_card():
            plain = run(params, None, lambda c: c)[0]
        pspecs = sharding.placed_param_specs(params, mesh, "cascade", bool(cfg.tie_embeddings))
        local = sharding.shard_tree(params, pspecs, mesh)
        del params
        cspecs = sharding.cache_specs(want_cache, mesh)
        pol = sharding.ActivationPolicy(mesh, "cascade", local, pspecs, cache_bands=cspecs)
        got, cache, launches, colls, routes = run(
            local, pol, lambda c: sharding.shard_tree(c, cspecs, mesh))
        whole = sharding.gather_tree(cache, cspecs, mesh)
        leaves = {"/".join(p): (t, sharding._spec_at(cspecs, p))
                  for p, t in T.leaves_with_paths(cache)}
        ref_leaves = dict(("/".join(p), t) for p, t in T.leaves_with_paths(want_cache))
        # a token whose expert list differs in any routing of its step: its
        # logits are left out of the tolerance, and counted
        flipped = [torch.zeros(w.shape[0], dtype=torch.bool, device=dev) for w in want]
        per_step = len(want_routes) // BAND_STEPS
        for i, ((iw, _), (ig, _)) in enumerate(zip(want_routes, routes)):
            flipped[i // per_step] |= (iw != ig).any(dim=-1).reshape(flipped[0].shape[0], -1) \
                .any(dim=-1)
        kept = [(g[~f], w[~f]) for g, w, f in zip(got, want, flipped)]
        cache_rel, cache_first_equal = {}, {}
        for p, t in T.leaves_with_paths(whole):
            k = "/".join(p)
            ref = ref_leaves[k]
            n = bit_layers or t.shape[0]
            cache_first_equal[k] = bool(torch.equal(t[:n], ref[:n]))
            if n < t.shape[0] and t.is_floating_point():
                cache_rel[k] = rel(t[n:], ref[n:])
            elif n < t.shape[0]:
                cache_first_equal[k] &= bool(torch.equal(t, ref))
        expect = {}
        if pol.cache_band("k") == -3:              # every attention layer, each step
            expect["decode_attention"] = BAND_STEPS * getattr(model, "n_attn", cfg.n_layers)
        if pol.cache_band("state") is not None:
            expect["ssd_scan"] = BAND_STEPS * cfg.n_layers
        out[f"{arch}@{layers}"] = {
            "layers": layers, "top_k": cfg.moe_top_k if cfg.n_experts else None,
            "cache_bit_equal_layers": bit_layers or "all",
            "model_bands": dict(pol._cache_bands),
            "logits_bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
            "logits_max_rel_err": max((rel(g, w) for g, w in kept if w.numel()), default=None),
            "logits_max_rel_err_with_flips": max(rel(g, w) for g, w in zip(got, want)),
            "logits_rel_l2": max(float((g - w).norm() / w.norm()) for g, w in zip(got, want)),
            "plain_versions_logits_max_rel_err": max(rel(g, w) for g, w in zip(plain, want)),
            "routings": len(routes), "tokens_flipped": int(sum(int(f.sum()) for f in flipped)),
            "router_input_max_rel_err": max((rel(xg, xw) for (_, xw), (_, xg)
                                             in zip(want_routes, routes)), default=None),
            "cache_bit_equal": cache_first_equal, "cache_later_layers_max_rel_err": cache_rel,
            "band_bytes": {k: [t.numel() * t.element_size(),
                               ref_leaves[k].numel() * ref_leaves[k].element_size(),
                               "model" in spec] for k, (t, spec) in leaves.items()},
            "launches": launches, "launches_expected": expect, "collectives": colls,
            "s": time.monotonic() - t0}
        del local, cache, whole, want_cache
        torch.cuda.empty_cache()
    return out


def world1_phase(torch, dev) -> dict:
    """The dry run of ``WORLD1_ARCH`` at ``WORLD1_SHAPE`` on a fake world of
    one rank, beside the same step run on the card: the dry run's
    ``argument_bytes`` against the summed bytes of the tensors the step
    holds, its FLOPs against ``FlopCounterMode`` on the real step, and its
    ``temp_bytes`` (``peak_bytes``) against the rise of
    ``torch.cuda.max_memory_allocated`` across the step (plus the held
    tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    shape = ShapeConfig(*WORLD1_SHAPE)
    t0 = time.monotonic()
    with dryrun.fake_world(1):
        rec = dryrun.run_cell(WORLD1_ARCH, shape, make_mesh((1, 1), ("data", "model")),
                              verbose=False)
    trace_s = time.monotonic() - t0
    cfg, model = registry.load(WORLD1_ARCH)
    ccfg = CascadeConfig(mode="serve_fp4")        # the dry run's: the plain route, bf16
    params = model.init_params(0, ccfg, device=dev)
    cache = model.init_cache(shape.global_batch, shape.seq_len, dtype=ccfg.resolved_kv_dtype,
                             device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (shape.global_batch, 1), generator=gen,
                                     device=dev, dtype=torch.int32)}
    held = sum(t.numel() * t.element_size() for t in T.leaves([params, batch, cache]))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    flops = FlopCounterMode(display=False)
    with flops:
        logits, _ = model.decode_step(params, batch, cache, ccfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits).all()):
        fail("dryrun world-1 check: the real step's logits are not finite")
    mem = rec["memory"]
    card_temp = peak - base
    out = {"arch": WORLD1_ARCH, "shape": WORLD1_SHAPE, "trace_s": trace_s,
           "argument_bytes": mem["argument_bytes"], "card_held_bytes": held,
           "card_allocated_before_step": base,
           "temp_bytes": mem["temp_bytes"], "card_temp_bytes": card_temp,
           "peak_bytes": mem["peak_bytes"], "card_peak_bytes": held + card_temp,
           "card_max_memory_allocated": peak,
           "flops": rec["flops_per_device"], "card_flops": flops.get_total_flops(),
           "mem_tol": f"{WORLD1_MEM_RTOL} * card + {WORLD1_MEM_ATOL} bytes"}
    if mem["argument_bytes"] != held:
        fail(f"dryrun world-1 check: argument_bytes {mem['argument_bytes']} != the step's "
             f"tensors {held}")
    if rec["flops_per_device"] != out["card_flops"]:
        fail(f"dryrun world-1 check: FLOPs {rec['flops_per_device']} != the real step's "
             f"{out['card_flops']}")
    if abs(mem["temp_bytes"] - card_temp) > WORLD1_MEM_RTOL * card_temp + WORLD1_MEM_ATOL:
        fail(f"dryrun world-1 check: temp {mem['temp_bytes']} vs the card's {card_temp} "
             f"(peak {mem['peak_bytes']} vs {held + card_temp})")
    del params, cache, logits
    return out


def dryrun_cells(policy: str, cells: list) -> list:
    """A worker of the 16 x 16 sweep: ``cells`` ((arch, shape, placement
    keywords)) traced in one fake world of 256 ranks under ``policy``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        return [dryrun.run_cell(arch, shape, mesh, tp_policy=policy, verbose=False, **kw)
                for arch, shape, kw in cells]


def optimized_preset(arch: str, shape: str) -> dict:
    """The reference roofline's "optimized" placement of a cell
    (``benchmarks/roofline.py``'s ``OPT_BY_KIND`` and ``OPT_MOE``): train
    ``fulldp`` + ``fsdp`` + ``full_dp`` with remat ``none``, prefill
    ``seqpar``, and every MoE step kind the expert-parallel dispatch
    (cascade, remat ``dots``)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import registry
    if registry.get_config(arch).n_experts:
        return {"moe_ep": True}
    if cfgbase.SHAPES[shape].kind == "train":
        return {"act_policy": "fulldp", "dp_shard": "fsdp", "full_dp": True,
                "remat_policy": "none"}
    return {"act_policy": "seqpar"}


def start_dryrun_sweep():
    """Start the 16 x 16 sweep in ``DRYRUN_WORKERS`` spawned processes (host
    work beside the card's phases): every arch at ``DRYRUN_SHAPES`` under
    both policies, at ``PRESET_SHAPES`` under the reference's optimized
    presets and at ``FULLDP_SHAPES`` under serving fulldp (cascade), largest
    cells first. :func:`dryrun_sweep` collects."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import registry
    ok = lambda arch, shape: cfgbase.shape_applicable(registry.get_config(arch),
                                                      cfgbase.SHAPES[shape])
    cells = [(arch, shape, {}) for arch in registry.ALIASES for shape in DRYRUN_SHAPES
             if ok(arch, shape)]
    presets = [(arch, shape, optimized_preset(arch, shape)) for shape in PRESET_SHAPES
               for arch in registry.ALIASES if ok(arch, shape)]
    # the fsdp train preset's pair: the same cell gathering the params whole
    presets += [(arch, shape, dict(kw, dp_shard="none")) for arch, shape, kw in presets
                if kw.get("dp_shard") == "fsdp"]
    # serving fulldp: each rank's rows of the batch over model between blocks
    presets += [(arch, shape, {"act_policy": "fulldp"}) for shape in FULLDP_SHAPES
                for arch in registry.ALIASES if ok(arch, shape)]
    n = DRYRUN_WORKERS
    jobs = ([("cascade", presets[i::n]) for i in range(n)]
            + [(policy, cells[i::n]) for policy in ("cascade", "megatron") for i in range(n)])
    ex = cf.ProcessPoolExecutor(n, mp_context=mp.get_context("spawn"))
    return ex, [ex.submit(dryrun_cells, *job) for job in jobs], time.monotonic()


def dryrun_sweep(pending) -> list:
    """The records of the sweep :func:`start_dryrun_sweep` started."""
    ex, futures, _ = pending
    try:
        return [r for f in futures for r in f.result()]
    finally:
        ex.shutdown()


def dryrun_phase(torch, dev, sweep):
    """Phase ``dryrun``: decode attention with its lse at the time-band
    shapes; gloo worlds sharing the card decoding with the cache placed by
    the whole ``cache_specs`` (``BAND_WORLDS``); the world-1 check; the
    16 x 16 records of every arch at ``DRYRUN_SHAPES`` under both
    policies and at ``PRESET_SHAPES`` under the optimized presets
    (``sweep``, started before the card's phases)."""
    from repro_torch.launch import mesh as meshlib
    out = {"gpu": gpu_name_and_power()}
    out["lse"] = lse_phase(torch, dev)
    print(json.dumps({"decode_attention_lse": out["lse"], "gpu": out["gpu"]}), flush=True)
    t0 = time.monotonic()
    worlds = {}
    for shape, runs in BAND_WORLDS:
        ranks = meshlib.run_local_ranks(math.prod(shape), band_rank, shape, runs, threads=2)
        m = shape[1]
        for arch, layers, _, rtol in runs:
            run_key = f"{arch}@{layers}"
            per = [r[run_key] for r in ranks]
            res = per[0]
            time_band = any(d in (-3, -2) and k in ("k", "c_kv")
                            for k, d in res["model_bands"].items())
            errs = [p["logits_max_rel_err"] for p in per]
            if time_band and not all(e is not None and e <= rtol for e in errs):
                fail(f"dryrun bands {run_key}: logits of the tokens whose routing held {errs} "
                     f"past {rtol} of max|unsharded|")
            if not time_band and not all(p["logits_bit_equal"] for p in per):
                fail(f"dryrun bands {run_key}: state-band logits not bit-equal to the unsharded")
            if not all(all(p["cache_bit_equal"].values()) for p in per):
                fail(f"dryrun bands {run_key}: the gathered cache's first "
                     f"{res['cache_bit_equal_layers']} layers differ from the unsharded: "
                     f"{[p['cache_bit_equal'] for p in per]}")
            later = [e for p in per for e in p["cache_later_layers_max_rel_err"].values()]
            routers = [p["router_input_max_rel_err"] for p in per
                       if p["router_input_max_rel_err"] is not None]
            if not all(e <= rtol for e in later + routers):
                fail(f"dryrun bands {run_key}: later layers' cache {later} or router input "
                     f"{routers} past {rtol} of max|unsharded|")
            for p in per:
                for leaf, (local, whole, banded) in p["band_bytes"].items():
                    if local * (m if banded else 1) != whole:
                        fail(f"dryrun bands {run_key}: {leaf} holds {local} of {whole} bytes")
            if not any(b for _, _, b in res["band_bytes"].values()):
                fail(f"dryrun bands {run_key}: no leaf of the cache is banded over model")
            for p in per:
                for k, n in p["launches_expected"].items():
                    if p["launches"][k] != n:
                        fail(f"dryrun bands {run_key}: {k} launched {p['launches'][k]} times "
                             f"in the banded decode steps, not {n}")
            worlds[f"{run_key} {shape}"] = {
                **res, "world": list(shape),
                "logits_max_rel_err_ranks": [p["logits_max_rel_err"] for p in per],
                "tokens_flipped_ranks": [p["tokens_flipped"] for p in per],
                "logit_tol": "bit-equal" if not time_band else f"{rtol} * max|unsharded|"}
    out["bands"] = worlds
    out["bands_s"] = time.monotonic() - t0
    print(json.dumps({"dryrun_bands": worlds}), flush=True)
    out["world1"] = world1_phase(torch, dev)
    print(json.dumps({"dryrun_world1": out["world1"], "gpu": out["gpu"]}), flush=True)
    t1 = time.monotonic()
    recs = dryrun_sweep(sweep)
    out["sweep_wait_s"] = time.monotonic() - t1
    out["sweep_s"] = time.monotonic() - sweep[2]
    out["sweep_trace_s"] = sum(r.get("trace_s", 0) for r in recs)
    failed = [r for r in recs if r["status"] != "ok"]
    if failed:
        fail(f"dryrun: cells failed: {failed}")
    out["fsdp_vs_whole_params"] = fsdp_layer_gathers(recs)
    out["records"] = [{
        "arch": r["arch"], "shape": r["shape"], "tp_policy": r["tp_policy"],
        "placement": {k: r[k] for k in ("act_policy", "dp_shard", "full_dp", "moe_ep")},
        "argument_gb": r["memory"]["argument_bytes"] / 1e9, "temp_gb": r["memory"]["temp_bytes"] / 1e9,
        "peak_gb": r["memory"]["peak_bytes"] / 1e9, "flops": r["flops_per_device"],
        "collectives": {k: v for k, v in r["collectives"].items() if k != "total_bytes"},
        "trace_s": r["trace_s"]} for r in recs]
    print(json.dumps({"dryrun_16x16": out["records"], "note": "counts of a traced step on "
                      "fake tensors, not measurements"}), flush=True)
    print(json.dumps({"dryrun_fsdp_vs_whole_params": out["fsdp_vs_whole_params"]}), flush=True)
    return out


def fsdp_layer_gathers(recs: list) -> dict:
    """For each arch's train_4k cell under the optimized preset (full data
    parallelism with FSDP), its temp against the same cell's gathering the
    params whole at the step's start: the drop must be at least half the
    whole params' bytes (one layer at a time is live, not all of them)."""
    from repro_torch import tree as T
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry
    out = {}
    pairs = {}
    for r in recs:
        if r["shape"] == "train_4k" and r["full_dp"]:
            pairs.setdefault(r["arch"], {})[r["dp_shard"]] = r
    for arch, pair in sorted(pairs.items()):
        model = registry.build_model(registry.get_config(arch))
        whole = sum(t.numel() * t.element_size() for t in T.leaves(
            model.init_params(0, CascadeConfig(mode="train"), device="meta")))
        drop = pair["none"]["memory"]["temp_bytes"] - pair["fsdp"]["memory"]["temp_bytes"]
        if drop < whole / 2:
            fail(f"dryrun {arch} train_4k: fsdp's temp is only {drop} bytes below the whole "
                 f"params' cell, under half the params' {whole}")
        out[arch] = {"whole_params_gb": whole / 1e9, "temp_gb_whole": pair["none"]["memory"]
                     ["temp_bytes"] / 1e9, "temp_gb_fsdp": pair["fsdp"]["memory"]["temp_bytes"]
                     / 1e9, "drop_over_params": drop / whole}
    return out



# ---------------------------------------------------------------------------
# an FP8 (e4m3) KV cache through both attention kernels
# ---------------------------------------------------------------------------

def fp8_decode_cases():
    """(name, B, Hq, Hkv, T, positions, D): the served codeqwen step, the
    4,096-row cache (split along T) and qwen2.5-32b's 2,048-row time band
    (positions as ``LSE_CASES``': one slot before the band, one past it)."""
    t = -(-(PROMPT_LEN + MAX_NEW + 1) // CHUNK) * CHUNK
    served = [PROMPT_LEN + 4 * i for i in range(MAX_BATCH)]
    long_pos = [2047 + round(i * 2048 / (MAX_BATCH - 1)) for i in range(MAX_BATCH)]
    band = [-1, 2048 + 5] + [2048 * i // (MAX_BATCH - 1) for i in range(1, MAX_BATCH - 1)]
    return [("codeqwen_step", MAX_BATCH, 32, 32, t, served, 128),
            ("long_4096", MAX_BATCH, 32, 32, 4096, long_pos, 128),
            ("qwen2.5-32b_time_band", MAX_BATCH, 40, 8, 2048, band, 128)]


#: (name, B, Hq, Hkv, S, T, offsets, D): the codeqwen verify pass and an
#: admission chunk over 4,096 live keys (split over the keys)
FP8_FLASH_CASES = (("verify", MAX_BATCH, 32, 32, 5, 192,
                    [0, 27, 53, 80, 107, 133, 160, 187], 128),
                   ("admit4064_live", 1, 32, 32, 32, 4096, [4064], 128))


def fp8_attention_phase(torch, dev):
    """Decode and flash attention over an e4m3 cache (``FP8_*`` cases): each
    output bit-equal to the same kernel's on the cache upcast to bf16 (the
    codes convert exactly), within the plain version's tolerance, and timed
    beside the bf16 kernel, the plain version and
    ``scaled_dot_product_attention`` on the bf16 upcast (the cast inside the
    timed call); bounds at one byte a cache value."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    rows = []

    def cache(gen, shape):
        return torch.randn((2,) + shape, generator=gen, device=dev).to(fp8)[1]

    def bound(nbytes, flops):
        return {"bytes": nbytes, "flops": flops,
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                             else "operations")}

    for name, b, hq, hkv, t, positions, d in fp8_decode_cases():
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(bf16)
        k, v = cache(gen, (b, t, hkv, d)), cache(gen, (b, t, hkv, d))
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        mask = torch.arange(t, device=dev)[None, :] <= pos[:, None]
        got = ops.decode_attention(q, k, v, q_pos=pos)
        same = ops.decode_attention(q, k.to(bf16), v.to(bf16), q_pos=pos)
        want = da.decode_attention_plain(q, k, v, q_pos=pos)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, same) or not err <= ATTN_ATOL:
            fail(f"decode_attention fp8 {name}: bit-equal to the bf16 upcast "
                 f"{torch.equal(got, same)}, max|err| {err} (tol {ATTN_ATOL})")
        live = int(mask.sum())
        nc = copies_beyond_l2(k.numel() * 2)
        sets8 = [(q, k.clone(), v.clone(), pos) for _ in range(nc)]
        sets16 = [(q, kk.to(bf16), vv.to(bf16), p) for _, kk, vv, p in sets8]
        kern = lambda a, kk, vv, p: ops.decode_attention(a, kk, vv, q_pos=p)
        plain = lambda a, kk, vv, p: da.decode_attention_plain(a, kk, vv, q_pos=p)
        lib = lambda a, kk, vv, p: F.scaled_dot_product_attention(
            a[:, :, None], kk.to(bf16).transpose(1, 2), vv.to(bf16).transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=hq != hkv)
        big = t > 1024
        row = {"case": name, "kernel": "decode_attention", "B": b, "Hq": hq, "Hkv": hkv,
               "T": t, "D": d, "q_pos": positions, "live_keys": live,
               "bit_equal_bf16_upcast": True, "max_abs_err": err, "tol": ATTN_ATOL,
               "ms": graph_ms(torch, kern, sets8, 20 if big else 100),
               "ms_bf16_cache": graph_ms(torch, kern, sets16, 20 if big else 100),
               "plain_ms": graph_ms(torch, plain, sets8, 5 if big else 20),
               "library_ms": graph_ms(torch, lib, sets8, 20 if big else 100),
               "library_note": "scaled_dot_product_attention on the cache cast to bf16, "
                               "the cast included"}
        row.update(bound(q.numel() * 2 + 2 * live * hkv * d + b * 4 + b * hq * d * 4,
                         4 * live * hq * d))
        rows.append(row)
        del sets8, sets16, k, v
        torch.cuda.empty_cache()
    for name, b, hq, hkv, s, t, offsets, d in FP8_FLASH_CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(s + t)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(bf16).transpose(1, 2)
        k = cache(gen, (b, t, hkv, d)).transpose(1, 2)
        v = cache(gen, (b, t, hkv, d)).transpose(1, 2)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        got = ops.flash_attention(q, k, v, q_offset=off)
        same = ops.flash_attention(q, k.to(bf16), v.to(bf16), q_offset=off)
        want = fa.flash_attention_plain(q, k, v, True, None, off)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = FLASH_RTOL * want.float().abs() + FLASH_VTOL * float(v.float().abs().max())
        if not torch.equal(got, same) or not bool((err <= tol).all()):
            fail(f"flash_attention fp8 {name}: bit-equal to the bf16 upcast "
                 f"{torch.equal(got, same)}, max err/tol {float((err / tol).max())}")
        vis = [[min(t, o + i + 1) for i in range(s)] for o in offsets]
        kv_rows = sum(max(r) for r in vis)
        mask = (torch.arange(t, device=dev)[None, None, :]
                <= off[:, None, None] + torch.arange(s, device=dev)[None, :, None])[:, None]
        nc = copies_beyond_l2(2 * kv_rows * hkv * d)
        sets8 = [(q, k.clone(), v.clone(), off) for _ in range(nc)]
        sets16 = [(a, kk.to(bf16), vv.to(bf16), o) for a, kk, vv, o in sets8]
        kern = lambda a, kk, vv, o: ops.flash_attention(a, kk, vv, q_offset=o)
        plain = lambda a, kk, vv, o: fa.flash_attention_plain(a, kk, vv, True, None, o)
        lib = lambda a, kk, vv, o: F.scaled_dot_product_attention(
            a, kk.to(bf16), vv.to(bf16), attn_mask=mask, enable_gqa=hq != hkv)
        row = {"case": name, "kernel": "flash_attention", "B": b, "Hq": hq, "Hkv": hkv,
               "S": s, "T": t, "D": d, "q_offset": offsets, "bit_equal_bf16_upcast": True,
               "max_abs_err": float(err.max()), "max_err_over_tol": float((err / tol).max()),
               "ms": graph_ms(torch, kern, sets8, 100),
               "ms_bf16_cache": graph_ms(torch, kern, sets16, 100),
               "plain_ms": graph_ms(torch, plain, sets8, 20),
               "library_ms": graph_ms(torch, lib, sets8, 100),
               "library_note": "scaled_dot_product_attention on the cache cast to bf16 (a "
                               "boolean mask), the cast included"}
        row.update(bound(2 * q.numel() * 2 + 2 * kv_rows * hkv * d,
                         4 * d * hq * sum(sum(r) for r in vis)))
        rows.append(row)
        del sets8, sets16, k, v
        torch.cuda.empty_cache()
    return rows


def cache_bytes(model, dtype) -> int:
    """Bytes of the K/V leaves of the served engine's cache (MAX_BATCH slots
    of the serve runs' length) stored as ``dtype`` (its int32 positions
    apart)."""
    from repro_torch import tree as T
    c = model.init_cache(MAX_BATCH, PROMPT_LEN + MAX_NEW + 1, dtype=dtype, device="meta")
    return sum(t.numel() * t.element_size() for t in T.leaves(c) if t.dtype == dtype)


def fp8_cache_run(torch, dev, arch, model, params, ccfg, prompts, plain_ref, plain_rec):
    """The plain run's prompts served with ``kv_dtype=float8_e4m3fn``: every
    kernel of the path launched on the FP8 cache, the cache half the bf16
    cache's bytes, and each stream's first departure from the bf16-cache
    run with that run's top-2 margin there (reported: an FP8 cache is
    another function of the same weights)."""
    ccfg8 = dataclasses.replace(ccfg, kv_dtype=torch.float8_e4m3fn)
    run, eng, reqs, _ = serve_run(torch, dev, arch, model, params, ccfg8, prompts, "fp8_cache")
    del eng
    ref_reqs, ref_rec = plain_ref
    departures = []
    for a, b in zip(ref_reqs, reqs):
        j = first_departure(a, b)
        if j is not None:
            m, steps = top2_margin(ref_rec["top2"][(a.uid, j)])
            departures.append({"uid": a.uid, "index": j, "bf16_cache": a.tokens_out[j],
                               "fp8_cache": b.tokens_out[j], "bf16_margin": m,
                               "margin_bf16_steps": steps})
    kv8, kv16 = cache_bytes(model, torch.float8_e4m3fn), cache_bytes(model, torch.bfloat16)
    if not 0 < 2 * kv8 == kv16:
        fail(f"serve ({arch}, fp8_cache): the FP8 cache takes {kv8} bytes, the bf16 "
             f"cache {kv16}")
    run.update({"kv_dtype": "float8_e4m3fn", "cache_bytes": kv8, "bf16_cache_bytes": kv16,
                "bf16_run_peak_mem_gb": plain_rec["peak_mem_gb"],
                "streams_equal_bf16_cache": not departures,
                "departures": departures,
                "streams_departing": len(departures)})
    return run


# ---------------------------------------------------------------------------
# the dry run's remaining placements on gloo worlds sharing the card
# ---------------------------------------------------------------------------

#: ``placements``: codeqwen1.5-7b at full width, depth PLACE_DEPTH, a
#: prefill of PLACE_ROWS x PLACE_PROMPT tokens under seqpar (1, 2), cascade
#: and megatron, through the kernels; phi4-mini-3.8b at full width, depth
#: PLACE_DEPTH, PLACE_STEPS QAT train steps of PLACE_ROWS x TRAIN_SEQ
#: tokens (bf16, remat "dots", the fake quant on its kernel) under zero1
#: and fsdp on (2, 1) against the data-parallel step, and under seqpar on
#: (1, 2) against the unsharded step on the rank
PLACE_DEPTH, PLACE_ROWS, PLACE_PROMPT, PLACE_STEPS = 2, 4, 128, 3
#: seqpar's logits against the unsharded prefill's, as max|diff| /
#: max|unsharded|: the same kernels on column bands (bit-equal to the whole
#: call) but megatron's row bands, whose f32 partial sums add in another
#: order, then one bf16 rounding: codeqwen's parity limit
PLACE_LOGIT_RTOL = 2.0 ** -6
#: the train runs' params after the steps against the reference run's, as
#: max|diff| / max|leaf| over the leaves: ZeRO's clip norm sums its squares
#: in another order (the last bits of one scalar), seqpar's column-banded
#: f32 products in cuBLAS's other tilings; every param is bf16, so a last
#: bit moved by either is one bf16 step (2^-8 of the leaf's scale): limits
#: of two steps; the losses within PLACE_LOSS_RTOL relative
PLACE_PARAM_RTOL, PLACE_LOSS_RTOL = 2.0 ** -7, 2.0 ** -10
#: serving fulldp on (1, 2): codeqwen1.5-7b at full width, depth PLACE_DEPTH,
#: FULLDP_ROWS rows (3 over the 2-wide model axis: a rank's share padded),
#: the dry run's prefill cell over PLACE_PROMPT tokens and its decode cell
#: (one step over a cache of FULLDP_CACHE rows filled by the unsharded
#: prefill), through the kernels: the mixers and MLPs run on the gathered
#: rows, the norms on a rank's rows, so the logits and the new cache must
#: equal the unsharded step's bit for bit, with its launches
FULLDP_ROWS, FULLDP_CACHE = 3, PLACE_PROMPT + CHUNK


def fulldp_runs(torch, dev, cols, arch, cfg, model, params, ccfg) -> dict:
    """Serving fulldp on ``cols`` (1, 2): the dry run's prefill cell over
    FULLDP_ROWS x PLACE_PROMPT tokens and its decode cell (one step over a
    FULLDP_CACHE-row cache filled by the unsharded prefill) against the
    unsharded prefill and decode step: logits and caches (gathered whole)
    compared bit for bit, the launches and the counted collectives."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    rel = lambda g, w: float((g.float() - w.float()).abs().max() / w.float().abs().max())
    out = {}
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (FULLDP_ROWS, PLACE_PROMPT + 1))
    prompt = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev)}
    step_tok = {"tokens": torch.from_numpy(toks[:, -1:].astype(np.int32)).to(dev)}
    zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=dev)

    def fulldp_cell(kind, seq_len):
        cell = dryrun.build_cell(arch, ShapeConfig(f"fulldp_{kind}", seq_len, FULLDP_ROWS,
                                                   kind),
                                 cols, ccfg, act_policy="fulldp", cfg=cfg)
        args = cell.local_args(zeros)
        for a, p in zip(T.leaves(args["params"]),
                        T.leaves(sharding.shard_tree(params, cell.trees["params"][1],
                                                     cols))):
            a.copy_(p)
        return cell, args

    def run_cell(cell, args):
        ops.reset_launch_counts()
        before = collectives.snapshot()
        with sharding.activation_policy(cell.policy(args)):
            got = cell.step(args)
        torch.cuda.synchronize()
        return got, dict(ops.LAUNCHES), collectives.since(before)

    ops.reset_launch_counts()
    want, want_cache = model.prefill(params, prompt, ccfg, max_len=PLACE_PROMPT)
    want_launches = dict(ops.LAUNCHES)
    cell, args = fulldp_cell("prefill", PLACE_PROMPT)
    args["batch"] = prompt
    (got, got_cache), launches, coll = run_cell(cell, args)
    bands = dryrun._without_axes(sharding.cache_specs(want_cache, cols), cell.batch_axes)
    got_cache = sharding.gather_tree(got_cache, bands, cols)
    out[("fulldp", "prefill")] = {
        "logits_bit_equal": bool(torch.equal(got, want)),
        "logits_max_rel_err": rel(got, want),
        "cache_bit_equal": all(torch.equal(a, b) for a, b in
                               zip(T.leaves(got_cache), T.leaves(want_cache))),
        "launches": launches, "unsharded_launches": want_launches, "collectives": coll}
    del cell, args, got, got_cache, want_cache
    # the decode cell: its cache args the unsharded prefill's cut by cache_specs
    _, cache = model.prefill(params, prompt, ccfg, max_len=FULLDP_CACHE)
    cell, args = fulldp_cell("decode", FULLDP_CACHE)
    cspecs = cell.trees["cache"][1]
    for a, c in zip(T.leaves(args["cache"]), T.leaves(sharding.shard_tree(cache, cspecs,
                                                                           cols))):
        a.copy_(c)
    args["batch"] = step_tok
    got, launches, coll = run_cell(cell, args)
    ops.reset_launch_counts()
    want, want_cache = model.decode_step(params, step_tok, cache, ccfg)
    torch.cuda.synchronize()
    got_cache = sharding.gather_tree(args["cache"], cspecs, cols)
    out[("fulldp", "decode")] = {
        "logits_bit_equal": bool(torch.equal(got, want)),
        "logits_max_rel_err": rel(got, want),
        "cache_bit_equal": all(torch.equal(a, b) for a, b in
                               zip(T.leaves(got_cache), T.leaves(want_cache))),
        "launches": launches, "unsharded_launches": dict(ops.LAUNCHES),
        "collectives": coll}
    del cell, args, cache, got_cache, want_cache
    return out


def placement_rank(rank: int) -> dict:
    """One rank of a two-rank gloo world sharing the card, on meshes (1, 2)
    and (2, 1): the ``placements`` phase's runs; each rank computes its own
    unsharded reference."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import loop
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cols, rows = make_mesh((1, 2), ("data", "model")), make_mesh((2, 1), ("data", "model"))
    rel = lambda g, w: float((g.float() - w.float()).abs().max() / w.float().abs().max())
    out = {}

    # codeqwen1.5-7b's prefill under sequence parallelism
    arch = "codeqwen1.5-7b"
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=PLACE_DEPTH)
    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16, use_kernel=True)
    params = model.init_params(0, ccfg, device=dev)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (PLACE_ROWS, PLACE_PROMPT))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}
    with torch.no_grad():
        ops.reset_launch_counts()
        want, _ = model.prefill(params, batch, ccfg, max_len=PLACE_PROMPT)
        want_launches = dict(ops.LAUNCHES)
        shape = ShapeConfig("place_prefill", PLACE_PROMPT, PLACE_ROWS, "prefill")
        for tp in ("cascade", "megatron"):
            cell = dryrun.build_cell(arch, shape, cols, ccfg, tp, act_policy="seqpar", cfg=cfg)
            args = {"params": sharding.shard_tree(params, cell.trees["params"][1], cols),
                    "batch": batch}
            ops.reset_launch_counts()
            before = collectives.snapshot()
            with sharding.activation_policy(cell.policy(args)):
                got, _ = cell.step(args)
            torch.cuda.synchronize()
            out[("seqpar_prefill", tp)] = {
                "logits_max_rel_err": rel(got, want), "launches": dict(ops.LAUNCHES),
                "unsharded_launches": want_launches,
                "collectives": collectives.since(before)}
            del args, got
        out.update(fulldp_runs(torch, dev, cols, arch, cfg, model, params, ccfg))
    del params, model
    torch.cuda.empty_cache()

    # phi4-mini-3.8b's QAT train steps under zero1, fsdp and seqpar
    arch = "phi4-mini-3.8b"
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=PLACE_DEPTH)
    model = registry.build_model(cfg)
    tccfg = CascadeConfig(mode="train", qat=True, use_kernel=True, compute_dtype=torch.bfloat16)
    params = model.init_params(0, tccfg, device=dev)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (PLACE_ROWS, TRAIN_SEQ + 1))
    tokens = torch.from_numpy(toks.astype(np.int32)).to(dev)
    shape = ShapeConfig("place_train", TRAIN_SEQ, PLACE_ROWS, "train")

    def cell_run(mesh, **kw):
        cell = dryrun.build_cell(arch, shape, mesh, tccfg, "cascade", cfg=cfg, **kw)
        cell_step = cell.step
        pspecs = cell.trees["params"][1]
        args = cell.local_args(lambda s, dt: torch.zeros(s, dtype=dt, device=dev))
        with torch.no_grad():
            for a, p in zip(T.leaves(args["params"]),
                            T.leaves(sharding.shard_tree(params, pspecs, mesh))):
                a.copy_(p)
        b0, nb = dryrun._data_rows(mesh, cell.batch_axes, PLACE_ROWS)
        args["batch"] = {"tokens": tokens[b0:b0 + nb, :-1], "labels": tokens[b0:b0 + nb, 1:]}
        local = {"params": [(tuple(t.shape), t.numel()) for t in T.leaves(args["params"])],
                 "mu": [t.numel() for t in T.leaves(args["opt"].mu)]}
        losses, launches = [], []
        for _ in range(PLACE_STEPS):
            ops.reset_launch_counts()
            with sharding.activation_policy(cell.policy(args)):
                got = cell_step(args)
            torch.cuda.synchronize()
            launches.append(dict(ops.LAUNCHES))
            losses.append(float(got["loss"]))
            args["opt"] = args["opt"]._replace(step=args["opt"].step + 1)
        whole = sharding.gather_tree(T.tree_map(lambda t: t.detach(), args["params"]), pspecs,
                                     mesh)
        return {"losses": losses, "launches": launches, "params": T.leaves(whole),
                "local": local}

    def unsharded():
        state = loop.TrainState(params=T.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params), opt=AdamW().init(params),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        step = loop.make_train_step(model, tccfg, AdamW(), remat=True)
        losses, launches = [], []
        for _ in range(PLACE_STEPS):
            ops.reset_launch_counts()
            state, m = step(state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
            torch.cuda.synchronize()
            launches.append(dict(ops.LAUNCHES))
            losses.append(float(m["loss"]))
        return {"losses": losses, "launches": launches,
                "params": [t.detach() for t in T.leaves(state.params)]}

    whole_numel = [t.numel() for t in T.leaves(params)]

    def compare(got, ref):
        return {"losses": got["losses"], "ref_losses": ref["losses"],
                "loss_max_rel_err": max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ref["losses"])),
                "params_max_rel_err": max(rel(g, w) for g, w in zip(got["params"],
                                                                    ref["params"])),
                "params_bit_equal_share": float(np.mean(
                    [bool(torch.equal(g, w)) for g, w in zip(got["params"], ref["params"])])),
                "launches_per_step": got["launches"], "ref_launches_per_step": ref["launches"],
                "local": got.get("local"), "whole_numel": whole_numel}

    ref = cell_run(rows)
    for dp_shard in ("zero1", "fsdp"):
        out[("train", dp_shard)] = compare(cell_run(rows, dp_shard=dp_shard), ref)
    del ref
    out[("train", "seqpar")] = compare(cell_run(cols, act_policy="seqpar"), unsharded())
    return out


def placements_phase(torch, dev):
    """Phase ``placements``: a two-rank gloo world sharing the card
    (``placement_rank``): sequence parallelism's prefill logits against the
    unsharded prefill (``PLACE_LOGIT_RTOL``), serving fulldp's prefill and
    decode step against the unsharded ones (bit for bit), the train steps under zero1
    and fsdp against the data-parallel step and under seqpar against the
    unsharded step (``PLACE_PARAM_RTOL``, ``PLACE_LOSS_RTOL``); every run's
    kernel launches those of its reference, step by step; each data band
    half its leaf."""
    from repro_torch.launch import mesh as meshlib
    t0 = time.monotonic()
    ranks = meshlib.run_local_ranks(2, placement_rank, threads=2, timeout=900)
    out = {"gpu": gpu_name_and_power(), "world_s": time.monotonic() - t0}
    for key in sorted(ranks[0], key=str):
        per = [r[key] for r in ranks]
        name = "/".join(key)
        if key[0] == "fulldp":
            if not all(p["logits_bit_equal"] and p["cache_bit_equal"] for p in per):
                readings = [{k: p[k] for k in ("logits_bit_equal", "logits_max_rel_err",
                                               "cache_bit_equal")} for p in per]
                fail(f"placements {name}: the logits or the cache differ from the unsharded "
                     f"step's: {readings}")
            if any(p["launches"] != p["unsharded_launches"] for p in per):
                fail(f"placements {name}: launches {per[0]['launches']}, the unsharded "
                     f"step's {per[0]['unsharded_launches']}")
            attention = "flash_attention" if key[1] == "prefill" else "decode_attention"
            if not all(per[0]["launches"][k] > 0 for k in ("cascade_matmul", attention, "norm")):
                fail(f"placements {name}: a kernel of the step never launched: "
                     f"{per[0]['launches']}")
            if not per[0]["collectives"]["all_to_all"]["calls"]:
                fail(f"placements {name}: no block output returned to the rows")
            out[name] = {"logits_bit_equal": True, "cache_bit_equal": True,
                         "launches": per[0]["launches"], "collectives": per[0]["collectives"]}
            continue
        if key[0] == "seqpar_prefill":
            errs = [p["logits_max_rel_err"] for p in per]
            if not all(e <= PLACE_LOGIT_RTOL for e in errs):
                fail(f"placements {name}: logits {errs} of max|unsharded| past "
                     f"{PLACE_LOGIT_RTOL}")
            if any(p["launches"] != p["unsharded_launches"] for p in per):
                fail(f"placements {name}: launches {per[0]['launches']}, the unsharded "
                     f"prefill's {per[0]['unsharded_launches']}")
            if not per[0]["collectives"]["all_to_all" if key[1] == "cascade"
                                         else "reduce_scatter"]["calls"]:
                fail(f"placements {name}: no block output returned to the rows")
            out[name] = {"logits_max_rel_err_ranks": errs, "tol": PLACE_LOGIT_RTOL,
                         "launches": per[0]["launches"],
                         "collectives": per[0]["collectives"]}
            continue
        for p in per:
            if p["params_max_rel_err"] > PLACE_PARAM_RTOL or \
                    p["loss_max_rel_err"] > PLACE_LOSS_RTOL:
                fail(f"placements {name}: params {p['params_max_rel_err']} (tol "
                     f"{PLACE_PARAM_RTOL}), losses {p['loss_max_rel_err']} (tol "
                     f"{PLACE_LOSS_RTOL}) from the reference run")
            if p["launches_per_step"] != p["ref_launches_per_step"]:
                fail(f"placements {name}: launches a step {p['launches_per_step']}, the "
                     f"reference's {p['ref_launches_per_step']}")
            if not all(s[k] > 0 for s in p["launches_per_step"]
                       for k in RUN_KERNELS[(TRAIN_ARCH, "train")]):
                fail(f"placements {name}: a kernel of the train step never launched")
            if key[1] in ("zero1", "fsdp"):
                # each moment leaf half its elements on a data band, or whole where
                # no dim divides the data axis
                local = p["local"]["mu"]
                if not all(m in (w, w // 2) for m, w in zip(local, p["whole_numel"])) or \
                        sum(m * 2 == w for m, w in zip(local, p["whole_numel"])) < len(local) // 2:
                    fail(f"placements {name}: the moments are not on their data bands")
        out[name] = {k: per[0][k] for k in ("losses", "ref_losses", "loss_max_rel_err",
                                            "params_max_rel_err", "params_bit_equal_share")}
        out[name].update({"params_max_rel_err_ranks": [p["params_max_rel_err"] for p in per],
                          "launches_per_step": per[0]["launches_per_step"][-1],
                          "tol": {"params": PLACE_PARAM_RTOL, "loss": PLACE_LOSS_RTOL}})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA GPU")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not importable ({e}); run chip_smoke.py from a checkout")
    if sys.argv[1:] == ["--restart-child"]:
        return restart_child()
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
    sweep = start_dryrun_sweep()

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
    grouped_ptxas = [ln.strip() for ln in libs["cascade_matmul_grouped"].with_suffix(".log")
                     .read_text().splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    grp = timed("cascade_matmul_grouped", grouped_matmul_phase, grouped_ptxas)
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
    scaled = timed("attention softmax_scale", softmax_scale_phase)
    print(json.dumps({"attention_softmax_scale": scaled, "gpu": gpu_name_and_power()}),
          flush=True)
    fp8 = timed("attention fp8 cache", fp8_attention_phase)
    print(json.dumps({"attention_fp8_cache": fp8, "gpu": gpu_name_and_power()}), flush=True)
    ring = timed("decode_attention ring", ring_decode_phase)
    print(json.dumps({"decode_attention_ring": ring}), flush=True)
    nrm = timed("norm", norm_phase)
    nrm_fused = timed("norm fused", fused_norm_phase)
    print(json.dumps({"norm": nrm, "norm_fused": nrm_fused}), flush=True)
    ssd = timed("ssd_scan", ssd_phase)
    print(json.dumps({"ssd_scan": ssd}), flush=True)
    pool = timed("paged pool", paged_pool_phase)
    print(json.dumps({"paged_pool": pool}), flush=True)
    fqs = timed("fake_quant", fake_quant_phase)
    print(json.dumps({"fake_quant_fp4": fqs}), flush=True)
    ce_res = timed("cascade_exact", cascade_exact_phase)
    ces = ce_res["rows"]
    print(json.dumps({"cascade_exact": ces, "chain": ce_res["chain"],
                      "add_chain": ce_res["add_chain"],
                      "ops_per_step": ce_res["ops_per_step"]}), flush=True)
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
    exa = timed("examples_and_audit", examples_and_audit_phase)
    print(json.dumps({"examples_and_audit": exa}), flush=True)
    train, trained = timed("train", train_phase)
    print(json.dumps({"train": train}), flush=True)
    qat = timed("qat serve", qat_serve_phase, trained)
    del trained
    print(json.dumps({"qat_serve": qat}), flush=True)
    recipe = timed("train recipe", train_recipe_phase, train)
    print(json.dumps({"train_recipe": recipe}), flush=True)
    sim = timed("precision_sim", precision_sim_phase)
    print(json.dumps({"precision_sim": sim}), flush=True)
    restart = timed("restart", restart_phase)
    print(json.dumps({"restart": restart}), flush=True)
    dry = timed("dryrun", dryrun_phase, sweep)
    print(json.dumps({"dryrun": {k: dry[k] for k in ("gpu", "bands_s", "sweep_s", "sweep_wait_s",
                                                     "sweep_trace_s")}}), flush=True)
    place = timed("placements", placements_phase)
    print(json.dumps({"placements": place}), flush=True)
    mesh = timed("mesh", mesh_phase)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"phase_s": phase_s}), flush=True)

    def per_step(arch, key, per="launches_per_decode_step"):
        return sum(r[key] * r[per] for r in mm if r["arch"] == arch)

    def verify_step(arch):
        return {key: per_step(arch, key, "launches_per_verify_step")
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")}

    def launches(name):
        return {arch: srv[arch]["plain"]["launches"][name] for arch in ARCHS}

    def by_run(name):
        """Launches in every serve run (phi4-mini's after QAT among them),
        each counted from zero."""
        return {**{f"{arch}/{kind}": rec["launches"][name] for arch in ARCHS
                   for kind, rec in srv[arch].items() if "launches" in rec},
                f"{TRAIN_ARCH}/after_qat": qat["serve"]["launches"][name]}

    def model_level(name):
        """Launches in each model-level run of a modality-stub backbone."""
        return {arch: stub[arch]["launches"][name] for arch in STUB_ARCHS}

    cq, mb, om, rg = ARCHS

    def fp8_rows(kernel):
        """The FP8-cache rows of one attention kernel, by case."""
        return {r["case"]: {k: r[k] for k in (
            "ms", "ms_bf16_cache", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "bit_equal_bf16_upcast")} for r in fp8 if r["kernel"] == kernel}
    fv = next(r for r in fla if r["case"] == "verify")
    ce_row = next(r for r in ces
                  if (r["M"], r["K"], r["N"], r["bias"]) == (8, 4096, 13440, False))

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
        "cascade_matmul_grouped": {"launches": 32, "ms": grouped_step("ms"),
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
            for a in STUB_ARCHS + (TRAIN_ARCH,)},
         "llama31_405b_depth2_step": {key: per_step("llama31_405b", key)
                                      for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
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
         "source": "src/repro_torch/kernels/csrc/cascade_matmul_grouped.cu",
         "replaces": "no TPU kernel: the reference's expert_linear_apply, "
                     "src/repro/core/cascade.py:154 (an XLA einsum after dequantizing every "
                     "expert)",
         "shape": "one olmoe-1b-7b decode step: 16 x [(64 experts x C=8, 2048->1024, gate "
                  "and up in one launch), (64 x 8, 1024->2048)], rows routed top-8; times are "
                  "summed over its 32 launches (every shape under grouped_shapes)",
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
         "grouped_shapes": {f"{r['arch']} {r['stacks']} x {r['E']}x{r['C']} "
                            f"{r['K']}->{r['N']}": {k: r[k] for k in (
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
             for r in atts + ring},
         "fp8_cache_shapes": fp8_rows("decode_attention"),
         "launches_fp8_cache_run": srv[cq]["fp8_cache"]["launches"]["decode_attention"]},
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
         "long_context_launches_by_splits": srv[cq]["long_context"]["flash_launches_by_splits"],
         "fp8_cache_shapes": fp8_rows("flash_attention"),
         "launches_fp8_cache_run": srv[cq]["fp8_cache"]["launches"]["flash_attention"]},
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
        {"name": "fake_quant_fp4", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fake_quant.cu",
         "replaces": "no TPU kernel: the reference's fake_quant_fp4, "
                     "src/repro/core/quant.py:257 (plain XLA, QAT's weight fake quantization)",
         "shape": "one phi4-mini-3.8b QAT train step (bf16): 32 layers x [(3072,3072) x 2, "
                  "(3072,1024) x 2, (3072,8192) x 2, (8192,3072)], each launched in the "
                  "forward and again in the remat recompute; times are summed over the step's "
                  "448 launches (every shape under fake_quant_shapes)",
         "launches": train["launches"]["fake_quant_fp4"],
         "launches_per_train_step": train["launches_per_step"]["fake_quant_fp4"],
         "max_abs_err": max(r["max_abs_err"] for r in fqs),
         "tol": "bit-equal to the plain version (any NaN equal to any NaN)",
         **{key: sum(2 * r[key] * r["launches_per_phi4_forward"] for r in fqs
                     if r["dtype"] == "bfloat16")
            for key in ("ms", "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library_ms": None,
         "library_note": "none: no PyTorch call computes it",
         "fake_quant_shapes": {f"{r['case']} {r['dtype']}": {k: r[k] for k in (
             "shape", "group", "plan", "ms", "plain_ms", "bound_ms",
             "max_abs_err")}
             for r in fqs}},
        {"name": "cascade_matmul_exact", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cascade_exact.cu",
         "replaces": "no TPU kernel: the reference's cascade_matmul_exact, "
                     "src/repro/core/quant.py:180 (an XLA fori_loop over K)",
         "shape": "M=8, 4096 -> 13440 without a bias (every shape under cascade_exact_shapes; "
                  "the precision_sim forward runs it at M=128, 15 launches)",
         "launches": sim["launches"]["cascade_matmul_exact"],
         "max_abs_err": max(r["max_abs_err"] for r in ces),
         "tol": "bit-equal to the plain version (any NaN equal to any NaN)",
         **{k: ce_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "library_note": "none: no PyTorch call computes it",
         "sim_forward_exact_ms": {key: sum(r[key] * r["launches_per_sim_forward"]
                                           for r in ces) for key in ("ms", "bound_ms")},
         "chain_ns_per_add": ce_res["add_chain"]["ns_per_add"],
         "chain_ops_per_step": CE_CHAIN_OPS,
         "step_latency_ns": ce_res["chain"]["ns_per_step"],
         "ops_per_step": ce_res["ops_per_step"],
         "cascade_exact_shapes": {f"{r['M']}x{r['K']}->{r['N']} bias={r['bias']}": {k: r[k] for k in (
             "plan", "ms", "plain_ms", "bound_ms", "bound_by", "step_chain_ms",
             "saturated_share", "max_abs_err")}
             for r in ces}},
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
              "fake_quant_fp4": fqs, "cascade_exact": ce_res, "train": train, "qat_serve": qat,
              "train_recipe": recipe,
              "precision_sim": sim, "restart": restart, "examples_and_audit": exa,
              "dryrun": dry, "mesh": mesh, "attention_fp8_cache": fp8, "placements": place,
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
