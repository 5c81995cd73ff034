"""End to end: QAT-train a small LM, convert it to FP4, serve it (the
reference's ``examples/qat_train_then_serve.py``; the paper's Section 4
deployment story: a transformer "effectively trained in FP4 using QAT" is
then served from FP4 weights).

QAT with FP4 fake quantization -> async checkpoints -> ``tree_to_serve_fp4``
-> validation cross entropy, dense against FP4 -> continuous-batching
serving from the FP4 weights. The loss must fall (the reference's
assertion).

CPU (the default size, a few seconds):
    PYTHONPATH=src python -m repro_torch.examples.qat_train_then_serve --device cpu
On the H100 (bf16 compute, the kernels: fake quantization in training, the
FP4 matmul, attention and norm kernels in serving):
    PYTHONPATH=src python -m repro_torch.examples.qat_train_then_serve --full --fused
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as train_loop


def make_arch(full: bool) -> ArchConfig:
    if full:  # ~100M params (qwen-family block structure)
        return ArchConfig(name="repro-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                          d_ff=2048, vocab=8192, qkv_bias=True)
    return ArchConfig(name="repro-8m", family="dense", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab=2048, qkv_bias=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--fused", action="store_true", help="run the CUDA kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cpu = device.type == "cpu"
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="qat_ckpt_")

    cfg = make_arch(args.full)
    steps = args.steps or (300 if args.full else 60)
    batch, seq = (16, 256) if args.full else (8, 64)

    model = registry.build_model(cfg)
    ccfg = CascadeConfig(mode="train", qat=True, use_kernel=args.fused,
                         compute_dtype=torch.float32 if cpu else torch.bfloat16)
    opt = AdamW(lr=1e-3, warmup_steps=steps // 10, decay_steps=steps)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch))

    state = train_loop.init_state(model, ccfg, opt, device=device)
    n_params = sum(p.numel() for p in T.leaves(state.params))
    print(f"arch {cfg.name}: {n_params / 1e6:.1f}M params, QAT for {steps} steps on {device}")
    step_fn = train_loop.make_train_step(model, ccfg, opt, remat=False)
    t0, first, saves = time.time(), None, []
    for i in range(steps):
        state, m = step_fn(state, data.batch_at(i))
        loss = float(m["loss"])
        first = first or loss
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"  step {i:4d} loss {loss:.4f}")
        if (i + 1) % max(10, steps // 3) == 0:
            saves.append(ckpt.save(state, ckpt_dir, i + 1, extra={"data_step": i + 1},
                                   async_=True))
    for t in saves:
        t.join()
    print(f"QAT done: loss {first:.3f} -> {loss:.3f} in {time.time() - t0:.0f}s "
          f"(checkpoints: {sorted(os.listdir(ckpt_dir))})")
    assert loss < first, "QAT training failed to reduce loss"

    # ---- PTQ convert: the QAT weights survive FP4 quantization -------------
    params = T.tree_map(lambda p: p.detach(), state.params)
    del state
    serve_ccfg = dataclasses.replace(ccfg, mode="serve_fp4", qat=False)
    fp4_params = cascade.tree_to_serve_fp4(params, serve_ccfg)

    val = {k: torch.as_tensor(v).to(device) for k, v in data.batch_at(steps + 1).items()}

    @torch.no_grad()
    def ce(p, c):
        return float(train_loop.cross_entropy(model.forward(p, val, c), val["labels"]))
    ce_dense = ce(params, dataclasses.replace(ccfg, qat=False))
    ce_fp4 = ce(fp4_params, serve_ccfg)
    print(f"val CE: dense {ce_dense:.4f} vs FP4-served {ce_fp4:.4f} "
          f"(delta {ce_fp4 - ce_dense:+.4f})")

    # ---- serve with continuous batching ------------------------------------
    eng = ServeEngine(model, fp4_params, serve_ccfg,
                      ServeConfig(max_batch=4, max_len=seq + 24, fused=args.fused),
                      device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 12).astype(np.int32),
                    max_new_tokens=8) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    t0, tokens = time.time(), 0
    while eng.busy():
        tokens += eng.step()
    print(f"served {len(reqs)} requests / {tokens} tokens in {time.time() - t0:.1f}s "
          f"from FP4 weights; sample: {reqs[0].tokens_out}")
    return {"first_loss": first, "last_loss": loss, "ce_dense": ce_dense, "ce_fp4": ce_fp4,
            "requests": reqs}


if __name__ == "__main__":
    main()
