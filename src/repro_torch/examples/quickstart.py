"""Quickstart: the paper's FP4 CASCADE pipeline (the reference's
``examples/quickstart.py``).

1. Build a small transformer (qwen2.5-32b's smoke config), 2. PTQ its
weights to packed FP4 E2M1, 3. run a batch through the FP4 path against the
dense forward and against the dense forward of the PTQ-round-tripped
weights (the exactness claim), 4. run one CASCADE matmul three ways: the
FP4 matmul (``ops.cascade_matmul``: the kernel on the card, its plain
version on the CPU), the plain reference function, and the bit-accurate
FP8 column-sum oracle (``ops.cascade_matmul_exact``).

Each part is a function of its inputs that returns the printed numbers, so
a test can feed it the reference's inputs; the CLI draws its own from
seeded ``torch.Generator``s on the CPU and moves them to the device, so a
card run and a CPU run see the same inputs.

CPU (f32, the plain versions):
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
On the H100 (bf16 compute; the FP4 path through the kernels):
    PYTHONPATH=src python -m repro_torch.examples.quickstart --fused
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core import cascade, quant
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.cascade_matmul import cascade_matmul_plain
from repro_torch.models import registry

ARCH = "qwen2.5-32b"


def round_trip(tree):
    """A serve_fp4 tree with every packed linear dequantized back to a dense
    f32 ``{"w"[, "b"]}`` (stacked and expert leaves matrix by matrix)."""
    if isinstance(tree, dict) and "codes" in tree:
        def deq(c, s):
            if c.dim() == 2:
                return quant.dequantize_weight(c, s, torch.float32)
            return torch.stack([deq(ci, si) for ci, si in zip(c, s)])
        out = {"w": deq(tree["codes"], tree["scale"])}
        if "b" in tree:
            out["b"] = tree["b"]
        return out
    if isinstance(tree, dict):
        return {k: round_trip(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [round_trip(v) for v in tree]
    return tree


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|, in f32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


@torch.no_grad()
def ptq_and_forward(model, params, tokens: torch.Tensor, train: CascadeConfig,
                    fused: bool) -> dict:
    """Parts 1-3: PTQ ``params`` (a dense tree) to FP4, the byte counts, and
    the FP4 forward against the dense one and against the dense forward of
    the round-tripped weights. ``fused``: the FP4 forward runs the kernels."""
    serve = dataclasses.replace(train, mode="serve_fp4", use_kernel=fused)
    fp4 = cascade.tree_to_serve_fp4(params, serve)
    batch = {"tokens": tokens}
    logits_fp4 = model.forward(fp4, batch, serve)
    logits_ref = model.forward(params, batch, train)
    logits_qdq = model.forward(round_trip(fp4), batch, train)
    return {"dense_bytes": cascade.num_weight_bytes(params),
            "fp4_bytes": cascade.num_weight_bytes(fp4),
            "exactness": _rel(logits_fp4, logits_qdq),
            "fp4_vs_dense": _rel(logits_fp4, logits_ref),
            "finite": bool(torch.isfinite(logits_fp4).all())}


@torch.no_grad()
def matmul_three_ways(w: torch.Tensor, x: torch.Tensor, compute_dtype=torch.float32) -> dict:
    """Part 4: one (K, N) weight quantized with groups of 64, against (M, K)
    x: the FP4 matmul (x in ``compute_dtype``: the kernel takes bf16 on the
    card) against the plain reference on the same codes, and the oracle's
    largest column sum (FP8 sums saturate at +/-448)."""
    packed, scales = quant.quantize_weight(w, group_size=64)
    xc = x.to(compute_dtype)
    y = ops.cascade_matmul(xc, packed, scales)
    y_ref = cascade_matmul_plain(xc, packed, scales)
    w4 = quant.dequantize_weight(packed, scales, torch.float32)
    xs = x.abs().max() / quant.FP4_MAX
    x4 = quant.fp4_decode(quant.fp4_encode(x / xs))
    y_exact = ops.cascade_matmul_exact(x4, w4 / w4.abs().max() * quant.FP4_MAX)
    return {"kernel_vs_ref": float((y - y_ref).abs().max()),
            "oracle_max_abs_sum": float(y_exact.abs().max()),
            "finite": bool(torch.isfinite(y).all() and torch.isfinite(y_exact).all())}


def inputs(vocab: int) -> dict:
    """The CLI's inputs, from seeded CPU generators (as the reference draws
    from PRNGKey(1..3)): a (2, 16) token batch, w (128, 64) and x (8, 128)."""
    gen = lambda s: torch.Generator().manual_seed(s)
    return {"tokens": torch.randint(0, vocab, (2, 16), generator=gen(1)),
            "w": torch.randn((128, 64), generator=gen(2)) * 0.1,
            "x": torch.randn((8, 128), generator=gen(3))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--fused", action="store_true",
                    help="the FP4 forward through the kernels (bf16 compute)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16

    # --- 1. a reduced qwen2.5-family model ---------------------------------
    cfg, model = registry.load(ARCH, smoke=True)
    train = CascadeConfig(mode="train", compute_dtype=dtype)
    params = model.init_params(0, train, device=device)
    ins = {k: v.to(device) for k, v in inputs(cfg.vocab).items()}

    # --- 2./3. PTQ -> packed FP4, then a batch through it -------------------
    res = ptq_and_forward(model, params, ins["tokens"], train, args.fused)
    print(f"weights: {res['dense_bytes'] / 1e6:.2f} MB dense -> {res['fp4_bytes'] / 1e6:.2f} MB "
          f"FP4-packed")
    print(f"FP4 path vs PTQ-roundtripped dense (exactness): {res['exactness']:.2e}")
    print(f"FP4 vs original {str(dtype).replace('torch.', '')} (PTQ noise on a RANDOM-init "
          f"net): {res['fp4_vs_dense']:.3f} — random nets amplify quant noise; QAT closes this "
          f"(see repro_torch.examples.qat_train_then_serve)")

    # --- 4. one CASCADE matmul, three ways ----------------------------------
    mm = matmul_three_ways(ins["w"], ins["x"], dtype)
    route = "CUDA kernel" if device.type == "cuda" else "plain version"
    print(f"FP4 matmul ({route}) vs ref: {mm['kernel_vs_ref']:.2e}")
    print("bit-accurate FP8-column-accumulation oracle (paper Table 6 dataflow):")
    print(f"  column sums saturate at +/-{quant.FP8_E4M3_MAX}, "
          f"max |sum| = {mm['oracle_max_abs_sum']:.1f}")
    return {**res, **mm, "device": str(device), "fused": args.fused}


if __name__ == "__main__":
    main()
