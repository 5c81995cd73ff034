"""Training launcher (the reference's ``repro/launch/train.py``): seeded
random weights, the synthetic corpus, AdamW, optional FP4 QAT, microbatches
and async checkpoints with resume.

On the H100 (the default device; bf16 compute, each layer checkpointed;
``--fused`` runs the kernels: QAT's fake quantization, and the norm and
flash-attention kernels with their plain versions' gradients):
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 8 --batch 2 --seq 256 --qat --fused

CPU smoke (f32 compute, no checkpointing, the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --smoke --device cpu --steps 20 --batch 8 --seq 64 --qat

Without a card and without ``--device cpu`` it exits 2 and names the
missing GPU. ``--mesh host|production`` and ``--tp-policy`` are the
reference's. The step runs unsharded, as the reference's does on its host
mesh: every process a launcher starts (``torchrun``) holds the whole state
and trains the same batches, so ``--mesh host --tp-policy megatron``
trains exactly what a run without the flags does, and the policy places
nothing. The host mesh starts no process group. ``--mesh production``
builds the 16 x 16 mesh over a launcher's world: it needs 256 ranks and
raises on a smaller world, naming them.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.cascade import CascadeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamW
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as train_loop


def main(argv=None, losses: list | None = None) -> int:
    """The CLI; each step's loss, as a Python float, is also appended to
    ``losses`` when a list is given."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--qat", action="store_true", help="FP4 quantization-aware training")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--tp-policy", default="cascade", choices=["cascade", "megatron"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    ap.add_argument("--fused", action="store_true",
                    help="run the CUDA kernels (QAT's fake quantization among them)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.mesh == "production":
        meshlib.init_from_env()
        meshlib.make_production_mesh()          # 16 x 16: raises below 256 ranks
    return _train(args, device, [] if losses is None else losses)


def _train(args, device, losses: list) -> int:
    cpu = device.type == "cpu"
    cfg, model = registry.load(args.arch, smoke=args.smoke)
    ccfg = CascadeConfig(mode="train", qat=args.qat, use_kernel=args.fused,
                         compute_dtype=torch.float32 if cpu else torch.bfloat16)
    opt = AdamW(lr=args.lr, warmup_steps=max(2, args.steps // 10), decay_steps=args.steps)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))

    state = train_loop.init_state(model, ccfg, opt, device=device)
    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt.restore(state, args.ckpt_dir)
        start_step = int(extra.get("data_step", 0))
        print(f"resumed at step {start_step}")

    step_fn = train_loop.make_train_step(model, ccfg, opt, microbatches=args.microbatches,
                                         remat=not cpu)
    pending = None
    n0 = len(losses)
    t0 = time.time()
    for i in range(start_step, args.steps):
        state, metrics = step_fn(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} gnorm {float(metrics['gnorm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_every and args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(state, args.ckpt_dir, i + 1, extra={"data_step": i + 1},
                                async_=True)
    if pending is not None:
        pending.join()
    run = losses[n0:]
    if run:
        print(f"final loss {np.mean(run[-5:]):.4f} (first {np.mean(run[:5]):.4f}) "
              f"in {time.time() - t0:.1f}s device={device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
