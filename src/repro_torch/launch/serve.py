"""Serving launcher: random FP4 weights, continuous batching.

On the H100 (the default device; ``--fused`` runs the CUDA kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused

CPU smoke (plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --smoke --device cpu --fused

Mamba-2 (``--arch mamba2-370m``; ``--fused`` adds the SSD scan kernel for
the decode recurrence), on the H100 and as a CPU smoke:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --smoke --device cpu --fused

Speculative decode and sampling, on the H100 and as a CPU smoke:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused \
        --draft-len 4 --temperature 0.8 --top-k 50 --sample-seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --fused --draft-len 4

``--draft-len K`` drafts K tokens per slot per step by prompt lookup and
verifies them in one pass (greedy: the stream stays the greedy stream; the
output adds ``accepted/step``). ``--temperature`` > 0 (with ``--top-k``)
samples on the device, seeded by ``--sample-seed``; with ``--draft-len`` it
runs speculative sampling. Compute is bf16 on the card and f32 on the CPU.
In FP4 mode each matrix is quantized as it is drawn, so full width never
holds dense f32 weights.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--no-fp4", action="store_true", help="serve the dense baseline")
    ap.add_argument("--fused", action="store_true",
                    help="route every linear through the FP4 CUDA matmul and "
                         "decode attention through the CUDA kernel (needs FP4 "
                         "params; with --no-fp4 it downgrades with a warning)")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="speculative decode: K drafted tokens per slot per step (0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 samples on the device (default: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best logits (0 = all)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of the engine's sampling generator")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg, model = registry.load(args.arch, smoke=args.smoke)
    compute = torch.float32 if device.type == "cpu" else torch.bfloat16
    ccfg = CascadeConfig(mode="train" if args.no_fp4 else "serve_fp4", compute_dtype=compute)
    params = model.init_params(0, ccfg, device=device)
    scfg = ServeConfig(max_batch=args.max_batch,
                       max_len=args.prompt_len + args.max_new + 1, fused=args.fused,
                       draft_len=args.draft_len, temperature=args.temperature,
                       top_k=args.top_k, sample_seed=args.sample_seed)
    eng = ServeEngine(model, params, ccfg, scfg, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new) for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    total = 0
    while eng.busy():
        total += eng.step()
    dt = time.time() - t0
    m = eng.metrics()
    print(f"mode={m['effective_mode']} device={m['device']}"
          + (f" (downgraded: {'; '.join(m['downgrades'])})" if m["downgrades"] else ""))
    print(f"served {args.requests} requests, {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s), p99 step {m['step_time_p99_s'] * 1e3:.1f} ms, "
          f"admission wait {m['admission_wait_s_mean'] * 1e3:.1f} ms")
    if m["spec"]:
        print(f"spec draft_len={m['draft_len']} accepted/step={m['accepted_per_step']:.2f}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.tokens_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
