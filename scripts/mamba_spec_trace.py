#!/usr/bin/env python3
"""Find where Mamba-2's speculative greedy serve departs from plain greedy.

    python3 scripts/mamba_spec_trace.py

from the root of a checkout, on a machine with an H100. It serves
mamba2-370m at full width (seed-0 FP4 weights, bf16, fused kernels) as
``chip_smoke.py``'s repetitive-prompt runs do (16 requests, prompt 128, 32
new tokens, 8 slots, chunk 32): twice plainly, twice speculatively (draft
4). After every engine step it takes an exact fingerprint (the sum of the
bit patterns) of each live slot's conv window and SSD state in every layer,
and reports the first (step, slot, layer) where two runs differ: plain vs
plain and speculative vs speculative (determinism), then plain vs
speculative. At that step it replays both runs once more, recording each
norm's and linear's input and output, each block's output and the tied
head's, and prints the first recorded tensor whose row for that slot
differs, with its input (the norms: plain, add-norm and gated). Last, it
counts rows that ``layers.norm_apply``
(as eager ops, and through the norm kernel)
rounds otherwise in one call over R rows than in R one-row calls.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROMPT_LEN, MAX_NEW, N_REQ, MAX_BATCH, CHUNK, DRAFT_LEN = 128, 32, 16, 8, 32, 4


def fingerprint(t):
    """(layers, slots) int64: the sum of each (layer, slot) slice's bit patterns."""
    import torch
    bits = t.view(torch.int32) if t.dtype == torch.float32 else t.view(torch.int16)
    return bits.reshape(t.shape[0], t.shape[1], -1).long().sum(-1).cpu()


def serve(model, params, ccfg, prompts, draft, dev, on_step=None):
    """One fused serve run; per engine step, the live slots and the
    fingerprints of every layer's conv window and state."""
    import torch
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    eng = ServeEngine(model, params, ccfg, ServeConfig(
        max_batch=MAX_BATCH, max_len=PROMPT_LEN + MAX_NEW + 1, prefill_chunk=CHUNK,
        fused=True, draft_len=draft), device=dev)
    log = []
    step = eng.step

    def stepped():
        if on_step is not None:
            on_step(len(log), True)
        n = step()
        if on_step is not None:
            on_step(len(log), False)
        c = eng.cache["layers"]
        log.append(([None if r is None else (r.uid, len(r.tokens_out)) for r in eng.slots],
                    fingerprint(c["conv"]), fingerprint(c["state"])))
        return n
    eng.step = stepped
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    with torch.no_grad():
        eng.run_until_drained()
    return log, [r.tokens_out for r in reqs]


def first_difference(la, lb):
    """(step, slot, request, layer) of the first live slot whose caches differ."""
    for k, ((sa, ca, sta), (sb, cb, stb)) in enumerate(zip(la, lb)):
        if sa != sb:
            return (k, None, "the runs' schedules part", None)
        for s in range(MAX_BATCH):
            if sa[s] is None:
                continue
            layers = [l for l in range(ca.shape[0])
                      if ca[l, s] != cb[l, s] or sta[l, s] != stb[l, s]]
            if layers:
                return (k, s, sa[s], layers[0])
    return None


def trace_step(model, params, ccfg, prompts, draft, dev, target):
    """Every norm/linear/head input and output, and block output, of one
    step's decode or verify pass (not its admission)."""
    from repro_torch.core import cascade
    from repro_torch.models import layers as L

    orig = {"norm": L.norm_apply, "add_norm": L.add_norm_apply,
            "gated_norm": L.gated_norm_apply, "head": L.tied_head,
            "linear": cascade.linear_apply}
    rec, on, in_pass = [], [False], [False]

    def passing(fn):
        def call(*a, **kw):
            in_pass[0] = True
            try:
                return fn(*a, **kw)
            finally:
                in_pass[0] = False
        return call

    def recorded(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if on[0] and in_pass[0]:
                rec.append((f"{name} in", a[1].detach().clone()))
                rec.append((f"{name} out", (out[0] if isinstance(out, tuple) else out)
                            .detach().clone()))
            return out
        return call
    for name in ("norm", "add_norm", "gated_norm"):
        setattr(L, f"{name}_apply", recorded(name, orig[name]))
    L.tied_head = recorded("head", L.tied_head)
    cascade.linear_apply = recorded("linear", cascade.linear_apply)
    model._block = recorded("block", type(model)._block.__get__(model))
    for name in ("decode_step", "spec_verify"):
        setattr(model, name, passing(getattr(type(model), name).__get__(model)))
    try:
        serve(model, params, ccfg, prompts, draft, dev,
              on_step=lambda k, before: on.__setitem__(0, before and k == target))
    finally:
        for name in ("_block", "decode_step", "spec_verify"):
            model.__dict__.pop(name, None)
        for name in ("norm", "add_norm", "gated_norm"):
            setattr(L, f"{name}_apply", orig[name])
        L.tied_head, cascade.linear_apply = orig["head"], orig["linear"]
    return rec


def main() -> int:
    import torch
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import layers as L
    from repro_torch.models import registry

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    cfg, model = registry.load("mamba2-370m")
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=torch.bfloat16)
    params = model.init_params(0, ccfg, device=dev)
    rng = np.random.default_rng(1)              # chip_smoke.repetitive_prompts
    prompts = [np.tile(rng.integers(0, cfg.vocab, 4).astype(np.int32), PROMPT_LEN // 4)
               for _ in range(N_REQ)]
    runs = {}
    for name, draft in (("plain", 0), ("plain again", 0), ("spec", DRAFT_LEN),
                        ("spec again", DRAFT_LEN)):
        runs[name] = serve(model, params, ccfg, prompts, draft, dev)
    for a, b in (("plain", "plain again"), ("spec", "spec again"), ("plain", "spec")):
        d = first_difference(runs[a][0], runs[b][0])
        equal = [i for i, (x, y) in enumerate(zip(runs[a][1], runs[b][1])) if x == y]
        print(f"{a} vs {b}: streams equal {len(equal)}/{N_REQ}; first cache difference "
              f"(step, slot, (request, tokens), layer): {d}", flush=True)
    d = first_difference(runs["plain"][0], runs["spec"][0])
    if d is not None and d[1] is not None:
        step, slot = d[0], d[1]
        tp = trace_step(model, params, ccfg, prompts, 0, dev, step)
        ts = trace_step(model, params, ccfg, prompts, DRAFT_LEN, dev, step)
        for i, ((name, a), (_, b)) in enumerate(zip(tp, ts)):
            x, y = a[slot].reshape(-1), b[slot, 0].reshape(-1)   # decode row; verify row 0
            if not torch.equal(x, y):
                xin, yin = tp[i - 1][1][slot].reshape(-1), ts[i - 1][1][slot, 0].reshape(-1)
                print(f"step {step} slot {slot}: first differing tensor #{i} {name!r} "
                      f"(decode {tuple(a.shape)}, verify {tuple(b.shape)}): "
                      f"{int((x != y).sum())} of {x.numel()} values differ, max "
                      f"{float((x.float() - y.float()).abs().max())}; its input "
                      f"{'equal' if torch.equal(xin, yin) else 'differs'}", flush=True)
                break
        else:
            print(f"step {step} slot {slot}: no recorded tensor differs", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = {"scale": 1 + 0.1 * torch.randn((2048,), generator=gen, device=dev)}
    for use_kernel in (False, True):
        route = "the norm kernel" if use_kernel else "eager ops"
        for rows in (1, 2, 4, 8, 16, 40):
            n = 0
            for _ in range(50):
                x = torch.randn((rows, 2048), generator=gen, device=dev).to(torch.bfloat16)
                one = torch.cat([L.norm_apply(scale, x[i:i + 1], use_kernel=use_kernel)
                                 for i in range(rows)])
                n += int((L.norm_apply(scale, x, use_kernel=use_kernel) != one).any(-1).sum())
            print(f"norm_apply ({route}) over {rows} rows of 2048: {n} of {50 * rows} rows "
                  "round otherwise than one-row calls", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
