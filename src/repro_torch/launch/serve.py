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

Mesh serving (explicit SPMD on ``torch.distributed``): ``--host-devices N``
starts N local ranks in one gloo world (on the CPU, or N ranks sharing one
card), ``--mesh DxM`` (or ``auto``) lays them out as (data, model), and
``--tp-policy`` places the params (``cascade``: column bands, no partial-sum
all-reduce; ``megatron``: the row+column baseline). Each rank draws the
seeded params a layer at a time and keeps only its bands of each
(``sharding.param_placer``): it never holds the whole model, only its
bands (twice over while the layers' bands are stacked) and one whole
fragment (a layer, the embedding or the head) as it is drawn. Under
``torchrun`` the world comes from its environment (NCCL, one card a
rank). Every rank serves the same requests; rank 0 prints.
``--verify-collectives`` prints the decode (and verify) step's counted
collectives and exits 1 if any partial-sum all-reduce appears (cascade
passes; megatron, which has them by design, fails). Under
``--host-devices`` the exit code is the largest of the ranks', and the
FAIL lines of every rank that failed are printed with its number. The
torchrun line needs eight cards (llama3.1-405b's bands a rank: the smoke's ``mesh``
phase prints them); it has not been run:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --host-devices 4 --mesh 2x2 --verify-collectives
    torchrun --nproc-per-node 8 -m repro_torch.launch.serve \
        --arch llama31_405b --mesh 1x8 --fused --verify-collectives

``--audit`` holds every step closure of the engine just built to the serving
contract (``analysis/contract.py``: no read to the host inside a step, the
cache updated in place, packed weights on the FP4 path, no weight densified
on the kernel route, on a mesh no partial-sum all-reduce under cascade)
before anything is served: one line a closure, the findings and a summary,
and exit 1 with ``SERVING CONTRACT VIOLATED`` on a gating finding. It
composes with ``--fused``, ``--prefix-cache`` and ``--mesh`` (every rank
audits its own engine), on the H100 and as a CPU smoke:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
        --requests 4 --prompt-len 128 --max-new 8 --max-batch 8 --fused --audit
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --audit

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
import torch.distributed as dist

from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives, sharding
from repro_torch.launch import mesh as meshlib
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


def parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--host-devices", type=int, default=0,
                    help="start N local ranks in one gloo world (the CPU stand-in for a "
                         "mesh of cards; on a card, N ranks sharing it)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) mesh, e.g. 2x2 ('auto' splits the ranks)")
    ap.add_argument("--tp-policy", default="cascade", choices=["cascade", "megatron"],
                    help="param placement when --mesh is set")
    ap.add_argument("--verify-collectives", action="store_true",
                    help="print the decode (and verify) step's counted collectives; exit 1 "
                         "if a step has a partial-sum all-reduce (the CASCADE invariant: "
                         "cascade passes, the megatron baseline fails)")
    ap.add_argument("--audit", action="store_true",
                    help="audit every step closure of the constructed engine against the "
                         "serving contract (host reads, in-place cache, packed weights, "
                         "densified weights, collective budget) and exit 1 on any gating "
                         "finding, before serving; composes with --mesh/--fused/--prefix-cache")
    return ap


def main(argv=None, checks: tuple = ()) -> int:
    """The CLI. ``checks``: callables ``check(engine) -> FAIL lines`` run on
    every rank after ``--audit``, before serving (they must pickle under
    ``--host-devices``)."""
    args = parser().parse_args(argv)

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.traffic and (args.mesh or args.verify_collectives or args.audit):
        print("error: --traffic is a replica-fleet demo; run it without "
              "--mesh/--verify-collectives/--audit", file=sys.stderr)
        return 2
    if args.verify_collectives and not args.mesh:
        print("error: --verify-collectives reads a mesh engine's collectives: add --mesh",
              file=sys.stderr)
        return 2
    if args.host_devices > 1:
        runs = meshlib.run_local_ranks(args.host_devices, _rank_main, argv, tuple(checks))
        print("\n".join(runs[0][0]))
        for rank, (_, rc, fails) in enumerate(runs):
            if rc:
                print(f"rank {rank} of {len(runs)}: exit {rc}")
                print("\n".join(f"rank {rank}: {line}" for line in fails))
        return max(rc for _, rc, _ in runs)
    own_world = False
    if args.mesh and not meshlib.init_from_env():
        # one process, no launcher: a world of one rank
        meshlib.init_world(0, 1, meshlib.free_port(),
                           "nccl" if resolve_device(args.device).type == "cuda" else "gloo")
        own_world = True
    try:
        lines, rc, _ = serve(args, checks)
    finally:
        if own_world:
            dist.destroy_process_group()
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("\n".join(lines))
    return rc


def _rank_main(rank: int, argv, checks: tuple) -> tuple:
    """One local rank of ``--host-devices``: serve, and hand the lines back."""
    return serve(parser().parse_args(argv), checks)


def audit(eng) -> tuple:
    """``--audit``: every step closure of ``eng`` held to its serving contract
    (``analysis.contract.audit_engine``). Returns (the lines to print, the
    FAIL lines: the gating findings and the verdict, empty when it holds).
    A closure's line gives its host transfers and reads, its packed params,
    its cache leaves updated in place (the reference's donation aliases) and,
    on a mesh, its partial-sum all-reduces."""
    from repro_torch.analysis import contract, format_findings, gating
    res = contract.audit_engine(eng)
    lines = []
    for name, st in res["closures"].items():
        lines.append(f"audit {name}: in_place={st.get('cache_leaves_in_place', '-')}"
                     f"/{st.get('cache_major_leaves', '-')} host_xfer={st['host_transfers']} "
                     f"host_reads={st['host_reads']} "
                     f"psum_ar={st.get('partial_sum_allreduces', '-')} "
                     f"packed_params={st.get('packed_params', '-')}")
    bad = gating(res["findings"])
    if res["findings"]:
        lines.append(format_findings(res["findings"]))
    lines.append(f"audit: {len(res['closures'])} closure(s), {len(res['findings'])} "
                 f"finding(s), {len(bad)} gating")
    fails = []
    if bad:
        fails = format_findings(bad).splitlines() + ["SERVING CONTRACT VIOLATED"]
        lines.append(fails[-1])
    return lines, fails


def _any_rank(failed: bool) -> bool:
    """Whether any rank of the world failed (every rank learns the same)."""
    if not dist.is_initialized():
        return failed
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    flag = torch.tensor([int(failed)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def serve(args, checks: tuple = ()) -> tuple:
    """Build the model and engine the arguments ask for and serve: returns
    (the lines to print, the exit code, the FAIL lines)."""
    lines = []
    say = lines.append
    device = resolve_device(args.device)
    mesh = meshlib.make_serving_mesh(args.mesh) if args.mesh else None
    cfg, model = registry.load(args.arch, smoke=args.smoke)
    compute = torch.float32 if device.type == "cpu" else torch.bfloat16
    ccfg = CascadeConfig(mode="train" if args.no_fp4 else "serve_fp4", compute_dtype=compute)
    if mesh is None:
        params = model.init_params(0, ccfg, device=device)
    else:
        # each fragment cut to this rank's bands as it is drawn: a rank never
        # holds the whole model
        tied = bool(getattr(cfg, "tie_embeddings", False))
        params = model.init_params(0, ccfg, device=device,
                                   place=sharding.param_placer(mesh, args.tp_policy, tied))
    scfg = ServeConfig(max_batch=args.max_batch,
                       max_len=args.prompt_len + args.max_new + 1, fused=args.fused,
                       draft_len=args.draft_len, ngram_max=args.ngram_max,
                       temperature=args.temperature,
                       top_k=args.top_k, sample_seed=args.sample_seed,
                       prefix_cache=args.prefix_cache, page_size=args.page_size,
                       tp_policy=args.tp_policy)

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
        say(f"mode={router.replicas.engines[0].effective_mode} device={device}")
        say(f"traffic: {m['requests_offered']} arrivals at {args.rate:g} req/s over "
              f"{args.replicas} replicas ({m['replicas_alive']} alive after {len(kills)} "
              f"kill(s), {len(router.replicas.requeued)} stream(s) rebuilt) in {dt:.2f}s")
        say(f"  ttft p50/p99 {m['ttft_p50_s'] * 1e3:.1f}/{m['ttft_p99_s'] * 1e3:.1f} ms, "
              f"inter-token p50/p99 {m['inter_token_p50_s'] * 1e3:.1f}/"
              f"{m['inter_token_p99_s'] * 1e3:.1f} ms")
        say(f"  SLO attainment {m['slo_attainment']:.3f} (finished {m['requests_finished']}, "
              f"shed {m['requests_shed']}, rejected {m['requests_rejected']})")
        for r in recs[:3]:
            say(f"  req {r.uid}: {r.tokens_out}")
        return lines, 0, []

    eng = ServeEngine(model, params, ccfg, scfg, mesh=mesh, device=device)
    del params

    # held before anything is served; on a mesh every rank stops if any failed
    fails = []
    if args.audit:
        out, bad = audit(eng)
        lines += out
        fails += bad
    for check in checks:
        bad = list(check(eng))
        lines += bad
        fails += bad
    if _any_rank(bool(fails)):
        if not fails:
            say("not served: the checks failed on another rank")
        return lines, 1 if fails else 0, fails

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
    say(f"mode={m['effective_mode']} device={m['device']}"
          + (f" (downgraded: {'; '.join(m['downgrades'])})" if m["downgrades"] else ""))
    say(f"served {args.requests} requests, {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s), p99 step {m['step_time_p99_s'] * 1e3:.1f} ms, "
          f"admission wait {m['admission_wait_s_mean'] * 1e3:.1f} ms")
    if m["spec"]:
        say(f"spec draft_len={m['draft_len']} accepted/step={m['accepted_per_step']:.2f}")
    if m["paged"]:
        say(f"prefix cache: hit rate {m['prefix_hit_rate']:.2f} ({m['prefix_hits']}/"
              f"{m['prefix_lookups']} tokens), pages {m['pages_in_use']}/{m['pages_total']} "
              f"(page_size={m['page_size']}), evictions {m['evictions']}")
    for r in reqs[:3]:
        say(f"  req {r.uid}: {r.tokens_out}")
    rc = 0
    if mesh is not None:
        say(f"mesh {m['mesh']} tp_policy={m['tp_policy']} rank {mesh.rank} of "
            f"{meshlib.world_size()}")
    if args.verify_collectives:
        for name in ("decode", "sample", "verify", "spec_sample"):
            c = eng.collectives.get(name)
            if c is None:
                continue
            psum = collectives.partial_sum_allreduces(c)
            say(f"collectives {name}: all_gather {c['all_gather']['calls']} "
                f"({c['all_gather']['bytes']} B), all_reduce_sum {psum} "
                f"({c['all_reduce_sum']['bytes']} B), all_reduce_max "
                f"{c['all_reduce_max']['calls']}")
            if psum:
                fails.append(f"FAIL: the {args.tp_policy} {name} step made {psum} partial-sum "
                             "all-reduce(s): the zero-partial-sum invariant does not hold")
                say(fails[-1])
                rc = 1
    return lines, rc, fails


if __name__ == "__main__":
    raise SystemExit(main())
