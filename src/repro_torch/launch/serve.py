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

The MoE family: olmoe-1b-7b at full width on the H100 (its expert matmuls
one grouped FP4 launch each with ``--fused``), and DeepSeek-V2 (MLA) as a
CPU smoke (at full width it does not fit one card):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --device cpu --fused

Griffin (recurrentgemma-2b: RG-LRU blocks and local attention over a
2,048-row ring; prompts are not bounded by --max-len, admission chunks and
drafts are clamped to the ring), on the H100 and as a CPU smoke:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --smoke --device cpu --fused

Speculative decode and sampling, on the H100 and as a CPU smoke:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused \
        --draft-len 4 --temperature 0.8 --top-k 50 --sample-seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --fused --draft-len 4

The paged KV pool and the radix prefix cache, on the H100 and as a CPU
smoke (the demo prompts then share their first half, so every admission
after the first maps the shared pages instead of prefilling them):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --requests 16 --prompt-len 128 --max-new 32 --max-batch 8 --fused \
        --prefix-cache --page-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --fused --prefix-cache

Open-loop traffic over a fleet of replicas (``--traffic``): a seeded
Poisson trace of ``--requests`` arrivals at ``--rate`` req/s (prompts of
``--prompt-len``/2 to ``--prompt-len`` tokens, outputs of ``--max-new``/2 to
``--max-new``), routed by the SLO-aware router over ``--replicas`` engines
that share one params tree; ``--kill-at T`` fails replica 0 T seconds into
the trace (its streams are rebuilt on the survivor). The replicas step in
turn on one thread. On the H100 and as a CPU smoke:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --traffic --replicas 2 --requests 24 --rate 4 --prompt-len 128 \
        --max-new 32 --max-batch 8 --slo-ttft 1.0 --kill-at 2.0 --fused
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --traffic --kill-at 0.2

The modality-stub configs (qwen2-vl-2b, musicgen-large) take embeddings from
a stub frontend, not token prompts: the engine refuses them, as the
reference's engine cannot serve them either. They run at the model level
(``prefill``, ``decode_step``; see ``chip_smoke.py``).

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
from repro_torch.serve.elastic import ReplicaSet
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.serve.router import SLORouter
from repro_torch.serve.traffic import TrafficConfig


def fleet(model, params, ccfg, scfg: ServeConfig, replicas: int, device=None) -> SLORouter:
    """``replicas`` engines sharing ``params``, under one router, on the wall
    clock."""
    engines = [ServeEngine(model, params, ccfg, scfg, device=device) for _ in range(replicas)]
    return SLORouter(ReplicaSet(engines))


def traffic_config(vocab: int, requests: int, rate: float, prompt_len: int, max_new: int,
                   slo_ttft: float, deadline: float) -> TrafficConfig:
    """The CLI's trace: prompts of prompt_len/2..prompt_len tokens, outputs of
    max_new/2..max_new, every request stamped with the SLO and deadline."""
    return TrafficConfig(rate_rps=rate, n_requests=requests,
                         prompt_lens=((max(1, prompt_len // 2), prompt_len),),
                         output_lens=((max(1, max_new // 2), max_new),), vocab=vocab,
                         slo_ttft_s=slo_ttft, deadline_s=deadline)


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
    ap.add_argument("--ngram-max", type=int, default=3,
                    help="longest suffix n-gram the prompt-lookup drafter matches")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 samples on the device (default: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best logits (0 = all)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of the engine's sampling generator")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve from the paged KV pool with the radix-tree prefix cache: "
                         "shared prompt prefixes admit through resident pages instead of "
                         "being prefilled again (token-exact with the dense cache; Mamba-2 "
                         "downgrades with a warning)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page under --prefix-cache")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--traffic", action="store_true",
                    help="route a seeded open-loop Poisson trace (--rate, --requests "
                         "arrivals) over --replicas engines through the SLO-aware router; "
                         "prints TTFT and inter-token percentiles and SLO attainment")
    ap.add_argument("--replicas", type=int, default=2, help="engine replicas under --traffic")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate (requests/s) under --traffic")
    ap.add_argument("--slo-ttft", type=float, default=0.5,
                    help="per-request TTFT SLO seconds under --traffic (0 = none)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="admission deadline seconds under --traffic (0 = never shed)")
    ap.add_argument("--kill-at", type=float, default=None, metavar="T",
                    help="with --traffic: fail replica 0 T seconds into the trace (its "
                         "streams are rebuilt on a survivor)")
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
                       draft_len=args.draft_len, ngram_max=args.ngram_max,
                       temperature=args.temperature,
                       top_k=args.top_k, sample_seed=args.sample_seed,
                       prefix_cache=args.prefix_cache, page_size=args.page_size)

    if args.traffic:
        from repro_torch.serve.traffic import poisson_trace
        router = fleet(model, params, ccfg, scfg, args.replicas, device)
        trace = poisson_trace(traffic_config(cfg.vocab, args.requests, args.rate,
                                             args.prompt_len, args.max_new, args.slo_ttft,
                                             args.deadline))
        kills = [(args.kill_at, 0)] if args.kill_at is not None else []
        t0 = time.time()
        recs = router.run_trace(trace, kills=kills)
        dt = time.time() - t0
        m = router.metrics()
        print(f"mode={router.replicas.engines[0].effective_mode} device={device}")
        print(f"traffic: {m['requests_offered']} arrivals at {args.rate:g} req/s over "
              f"{args.replicas} replicas ({m['replicas_alive']} alive after {len(kills)} "
              f"kill(s), {len(router.replicas.requeued)} stream(s) rebuilt) in {dt:.2f}s")
        print(f"  ttft p50/p99 {m['ttft_p50_s'] * 1e3:.1f}/{m['ttft_p99_s'] * 1e3:.1f} ms, "
              f"inter-token p50/p99 {m['inter_token_p50_s'] * 1e3:.1f}/"
              f"{m['inter_token_p99_s'] * 1e3:.1f} ms")
        print(f"  SLO attainment {m['slo_attainment']:.3f} (finished {m['requests_finished']}, "
              f"shed {m['requests_shed']}, rejected {m['requests_rejected']})")
        for r in recs[:3]:
            print(f"  req {r.uid}: {r.tokens_out}")
        return 0

    eng = ServeEngine(model, params, ccfg, scfg, device=device)

    rng = np.random.default_rng(0)
    # under --prefix-cache the requests share their first half (one system
    # prompt, different user turns): the radix cache's traffic
    shared = (rng.integers(0, cfg.vocab, args.prompt_len // 2).astype(np.int32)
              if args.prefix_cache else np.zeros((0,), np.int32))

    def prompt():
        tail = rng.integers(0, cfg.vocab, args.prompt_len - len(shared)).astype(np.int32)
        return np.concatenate([shared, tail])

    reqs = [Request(uid=i, prompt=prompt(), max_new_tokens=args.max_new)
            for i in range(args.requests)]
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
    if m["paged"]:
        print(f"prefix cache: hit rate {m['prefix_hit_rate']:.2f} ({m['prefix_hits']}/"
              f"{m['prefix_lookups']} tokens), pages {m['pages_in_use']}/{m['pages_total']} "
              f"(page_size={m['page_size']}), evictions {m['evictions']}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.tokens_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
