"""Fault-tolerance demo: the three ZettaLith reliability layers in software
(the reference's ``examples/fault_tolerance_demo.py``).

1. **CREST** (paper Sections 20-21): inject defective output columns into
   a serving matmul; the cyclic spare-column tester detects them (filtering
   a transient "cosmic ray"), repairs them by spare recomputation, with no
   accuracy loss afterwards.
2. **Fail-in-place** (Section 20): kill one serving replica mid-flight;
   its requests are rebuilt on the survivors and all complete.
3. **Checkpoint/restart** (Section 21.3 contrast): crash training at step
   k, restore, and show the loss trajectory is bit-identical.

Each part is a function of its inputs that returns its results, so a test
can feed it the reference's inputs; the CLI draws its own from seeded
``torch.Generator``s and ``np.random.default_rng(0)``.

CPU (f32, the plain versions):
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo --device cpu
On the H100 (the replicas serve FP4 weights through the kernels, bf16):
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo --fused
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import warnings

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import cascade, crest
from repro_torch.core.cascade import CascadeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.elastic import ReplicaSet
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as train_loop

CREST_CFG = crest.CrestConfig(n_spares=8, threshold=3)
CREST_STEPS, CREST_GLITCH_STEP = 80, 10


@torch.no_grad()
def demo_crest(w: torch.Tensor, faults: torch.Tensor, xs: list, x_final: torch.Tensor,
               cfg: crest.CrestConfig = CREST_CFG) -> dict:
    """``len(xs)`` CREST-protected matmuls of ``w`` (K, N) with ``faults``
    (N,) injected, and a one-step transient on column 0 at step
    ``CREST_GLITCH_STEP``; then the coverage and the error of one more
    product against the clean one."""
    state = crest.crest_init(w.shape[1], cfg, device=w.device)
    for i, x in enumerate(xs):
        f = faults.clone()
        if i == CREST_GLITCH_STEP:
            f[0] = True
        _, state = crest.crest_matmul(x, w, state, cfg, f)
    stats = crest.coverage_stats(state, faults)
    y, _ = crest.crest_matmul(x_final, w, state, cfg, faults)
    with crest.full_f32_matmul():
        clean = x_final @ w
    return {**stats, "faulty_columns": torch.nonzero(faults).flatten().tolist(),
            "post_repair_max_err": float((y - clean).abs().max()),
            "overhead": 2 * cfg.n_spares / w.shape[1]}


def demo_fail_in_place(model, params, ccfg: CascadeConfig, prompts: list, device,
                       fused: bool = False, replicas: int = 3, max_new: int = 6) -> dict:
    """Replicas of one engine config (2 slots, 48 rows) under ``ReplicaSet``;
    one request a prompt; replica 0 killed after one step, then drained.
    Returns each request's final stream (a rebuilt one's from its clone)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        engines = [ServeEngine(model, params, ccfg,
                               ServeConfig(max_batch=2, max_len=48, fused=fused), device=device)
                   for _ in range(replicas)]
    rs = ReplicaSet(engines)
    reqs = [Request(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        rs.submit(r)
    rs.step()
    rs.kill_replica(0)
    rs.drain(max_steps=300)
    final = {r.uid: r for r in reqs}
    final.update({r.uid: r for r in rs.requeued})
    return {"completed": sum(r.done for r in final.values()), "requests": len(reqs),
            "streams": {uid: list(r.tokens_out) for uid, r in sorted(final.items())},
            "rebuilt": len(rs.requeued),
            "healthy": [i for i, h in enumerate(rs.health) if h.alive],
            "effective_mode": engines[-1].effective_mode}


def demo_checkpoint_restart(model, ccfg: CascadeConfig, params, data, opt: AdamW,
                            steps: int = 6, save_at: int = 3) -> dict:
    """``steps`` train steps from ``params`` with a checkpoint before step
    ``save_at``, then a fresh state restored from it and run to the end.
    Returns both loss tails and whether the resumed one is bit-identical."""
    step_fn = train_loop.make_train_step(model, ccfg, opt, remat=False)
    device = T.leaves(params)[0].device

    def fresh():
        p = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        return train_loop.TrainState(p, opt.init(p),
                                     torch.zeros((), dtype=torch.int32, device=device))
    with tempfile.TemporaryDirectory() as d:
        state, losses = fresh(), []
        for i in range(steps):
            if i == save_at:
                ckpt.save(state, d, i, extra={"data_step": i})
            state, m = step_fn(state, data.batch_at(i))
            losses.append(m["loss"].detach())
        resumed, extra = ckpt.restore(fresh(), d)
        tail = []
        for i in range(int(extra["data_step"]), steps):
            resumed, m = step_fn(resumed, data.batch_at(i))
            tail.append(m["loss"].detach())
    return {"losses": [float(x) for x in losses], "resumed_tail": [float(x) for x in tail],
            "tail_bit_equal": all(torch.equal(a, b) for a, b in zip(tail, losses[save_at:])),
            "max_rel_diff": max(abs(float(a) - float(b)) / abs(float(b))
                                for a, b in zip(tail, losses[save_at:]))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--fused", action="store_true",
                    help="serve the replicas from FP4 weights through the kernels (bf16)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    gen = lambda s: torch.Generator().manual_seed(s)

    print("=== 1. CREST: cyclic redundant spare testing =====================")
    k, n = 64, 128
    w = (torch.randn((k, n), generator=gen(0)) * 0.2).to(device)
    faults = crest.inject_column_faults(gen(1), n, 5).to(device)
    xs = [torch.randn((16, k), generator=gen(100 + i)).to(device) for i in range(CREST_STEPS)]
    res_crest = demo_crest(w, faults, xs, torch.randn((16, k), generator=gen(999)).to(device))
    print(f"injected defective PE columns: {res_crest['faulty_columns']}")
    print(f"detected {res_crest['detected']}/{res_crest['injected']}, false positives "
          f"{res_crest['false_positives']} (transient correctly filtered), repaired "
          f"{res_crest['repaired']}")
    print(f"post-repair max error vs clean matmul: {res_crest['post_repair_max_err']:.2e}")
    print(f"overhead: 2*{CREST_CFG.n_spares}/{n} = {res_crest['overhead']:.1%} extra columns "
          f"(paper: 16/8208 = 0.2%)\n")

    print("=== 2. fail-in-place: replica loss under load ====================")
    cfg, model = registry.load("codeqwen1.5-7b", smoke=True)
    ccfg = CascadeConfig(mode="train", compute_dtype=dtype)
    params = model.init_params(0, ccfg, device=device)
    if args.fused:
        ccfg = dataclasses.replace(ccfg, mode="serve_fp4")
        params = cascade.tree_to_serve_fp4(params, ccfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 8) for _ in range(9)]
    print("killing replica 0 with requests in flight...")
    res_fip = demo_fail_in_place(model, params, ccfg, prompts, device, fused=args.fused)
    print(f"completed {res_fip['completed']}/{res_fip['requests']} requests after failover "
          f"(healthy replicas: {res_fip['healthy']}; {res_fip['effective_mode']})\n")

    print("=== 3. checkpoint/restart: bit-identical resume ==================")
    cfg, model = registry.load("phi4-mini-3.8b", smoke=True)
    tccfg = CascadeConfig(mode="train", compute_dtype=torch.float32)
    res_ck = demo_checkpoint_restart(
        model, tccfg, model.init_params(0, tccfg, device=device),
        SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)),
        AdamW(lr=1e-3, warmup_steps=2, decay_steps=10))
    print(f"uninterrupted tail:   {res_ck['losses'][3:]}")
    print(f"crash+restore tail:   {res_ck['resumed_tail']}")
    assert np.allclose(res_ck["losses"][3:], res_ck["resumed_tail"], rtol=1e-6)
    print("bit-identical resume confirmed\n" if res_ck["tail_bit_equal"] else
          f"resume within rtol 1e-6 (max {res_ck['max_rel_diff']:.1e}), not bit-identical\n")
    return {"crest": res_crest, "fail_in_place": res_fip, "checkpoint_restart": res_ck,
            "device": str(device), "fused": args.fused}


if __name__ == "__main__":
    main()
