#!/usr/bin/env python3
"""Time the FP4 matmul kernel's load batches on one card, and hold it to an
earlier version of the kernel bit for bit.

    python3 scripts/cascade_matmul_sweep.py [--against OLD.cu]

from the root of a checkout, on a machine with an H100 and nvcc. It builds
``src/repro_torch/kernels/csrc/cascade_matmul.cu`` once per variant of the
k16 steps a warp batches at 1-4 m-tiles a block (``-DCM_KBATCH1`` ..
``-DCM_KBATCH4``) and once with a block capped at 3 m-tiles
(``-DCM_MAX_MT=3``), all builds started together, prints each build's ptxas
register and spill lines, then times every variant at codeqwen1.5-7b's and
mamba2-370m's layer shapes at M = 8, 32, 40 and 64 (``chip_smoke``'s inputs
and CUDA-graph timing, weights cold from device memory). The variants only
group loads or split M otherwise, so every variant's output must equal the
committed build's bit for bit; any difference exits non-zero.

``--against OLD.cu`` also builds an earlier version of the kernel (its C
launcher without the m-tiles argument, as it was before a block held more
than 16 rows), checks that the committed build gives the same bits at every
``chip_smoke`` matmul shape (bf16 and f32 out) and times the two in turns at
each shape (old, new, new, old). One JSON line per result; the last line is
the whole table.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: k16 steps a warp batches at 1, 2, 3 and 4 m-tiles (``-DCM_KBATCH1..4``);
#: the first is the committed default (the source's own values), the others
#: are tried beside it, and "cap3" is the default with a block capped at 3
#: m-tiles (``-DCM_MAX_MT=3``: 48 rows, so M = 64 takes two block rows)
VARIANTS = [None, (2, 4, 2, 2), (3, 8, 3, 3), (6, 10, 6, 5), (8, 8, 8, 6), "cap3"]
#: (name, K, N): codeqwen's q/k/v/o, gate/up and down, mamba's in/out_proj
SHAPES = [("cq_qkvo", 4096, 4096), ("cq_gate_up", 4096, 13440), ("cq_down", 13440, 4096),
          ("mb_in_proj", 1024, 4384), ("mb_out_proj", 2048, 1024)]
ROWS = (8, 32, 40, 64)


def build_all(variants, against):
    """One nvcc per library, all started together: the variants, and the
    older source if given. Returns key -> library path."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    src = build.CSRC / "cascade_matmul.cu"
    jobs = {}
    for v in variants:
        if v is None or v == "cap3":
            name, defs = v or "default", ["-DCM_MAX_MT=3"] if v else []
        else:
            name = "kb" + "_".join(map(str, v))
            defs = [f"-DCM_KBATCH{i + 1}={b}" for i, b in enumerate(v)]
        jobs[v] = ([nvcc, *build.NVCC_FLAGS, *defs, "-o", str(out_dir / f"cm_{name}.so"),
                    str(src)], out_dir / f"cm_{name}.so")
    if against:
        jobs["against"] = ([nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / "cm_against.so"),
                            str(against)], out_dir / "cm_against.so")
    procs = {k: (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True), so) for k, (cmd, so) in jobs.items()}
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        print(json.dumps({"build": str(key), "ptxas": [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln
            or "Compiling entry" in ln]}), flush=True)
        libs[key] = so
    return libs


def bind_against(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.cascade_matmul_launch.restype = ctypes.c_int
    return lib


def call_against(torch, lib, x, packed, scales, bias, out_dtype):
    """The older kernel: its launcher takes no m-tiles (16 rows a block)."""
    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = lib.cascade_matmul_launch(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                   bias.data_ptr() if bias is not None else None,
                                   out.data_ptr(), m, k, n, k // scales.shape[0],
                                   int(out_dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"older kernel launch failed: CUDA error {rc}")
    return out


def inputs(torch, dev, gen, m, k, n, with_bias):
    from repro_torch.core import quant
    w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
    packed, scales = quant.quantize_weight(w, 0)
    bias = torch.randn((n,), generator=gen, device=dev) if with_bias else None
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    return x, packed, scales, bias


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import cascade_matmul as cm

    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier cascade_matmul.cu to hold the kernel to, bit for bit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    print(cs.gpu_name_and_power(), flush=True)
    libs = build_all(VARIANTS, args.against)
    bound = {v: cm.bind(ctypes.CDLL(str(libs[v]))) for v in VARIANTS}

    committed_cap = cm.MAX_M_TILES

    def with_lib(lib):
        """The wrapper sent to one build, its plan capped at that build's
        m-tiles a block."""
        cm._library = lambda: lib
        cap = cm.geometry()["max_m_tiles"]

        def fn(a, p, s, b):
            cm._library, cm.MAX_M_TILES = (lambda: lib), cap
            return cm.cascade_matmul_cuda(a, p, s, b, torch.bfloat16)
        return fn

    results = []
    gen = torch.Generator(device=dev).manual_seed(11)
    for name, k, n in SHAPES:
        for m in ROWS:
            x, packed, scales, bias = inputs(torch, dev, gen, m, k, n, name == "cq_qkvo")
            sets = [(x, packed.clone(), scales.clone(), bias)
                    for _ in range(cs.copies_beyond_l2(packed.numel()))]
            ref = with_lib(bound[None])(x, packed, scales, bias)
            for v in VARIANTS:
                fn = with_lib(bound[v])
                same = bool(torch.equal(fn(x, packed, scales, bias), ref))
                torch.cuda.synchronize()
                if not same:
                    raise SystemExit(f"{name} M={m} batches {v}: output differs from the "
                                     "committed build's")
                row = {"shape": name, "M": m, "K": k, "N": n,
                       "m_tiles": cm.plan(m, k, n)["m_tiles"], "grid": cm.plan(m, k, n)["grid"],
                       "batches": v or "default", "ms": cs.graph_ms(torch, fn, sets, 40)}
                print(json.dumps(row), flush=True)
                results.append(row)
            del sets
            torch.cuda.empty_cache()
    cm._library, cm.MAX_M_TILES = (lambda: bound[None]), committed_cap

    against = []
    if args.against:
        old = bind_against(ctypes.CDLL(str(libs["against"])))
        gen = torch.Generator(device=dev).manual_seed(12)
        old_fn = lambda a, p, s, b: call_against(torch, old, a, p, s, b, torch.bfloat16)
        new_fn = with_lib(bound[None])
        for arch, m, k, n, with_bias, _, _ in cs.matmul_shapes():
            x, packed, scales, bias = inputs(torch, dev, gen, m, k, n, with_bias)
            equal = {}
            for odt in (torch.bfloat16, torch.float32):
                a = call_against(torch, old, x, packed, scales, bias, odt)
                b = cm.cascade_matmul_cuda(x, packed, scales, bias, odt)
                torch.cuda.synchronize()
                equal[str(odt)] = bool(torch.equal(a, b))
            sets = [(x, packed.clone(), scales.clone(), bias)
                    for _ in range(cs.copies_beyond_l2(packed.numel()))]
            turns = [("old", old_fn), ("new", new_fn), ("new", new_fn), ("old", old_fn)]
            ms = {"old": [], "new": []}
            for who, fn in turns:
                ms[who].append(cs.graph_ms(torch, fn, sets, 40))
            row = {"against": str(args.against), "arch": arch, "M": m, "K": k, "N": n,
                   "m_tiles": cm.plan(m, k, n)["m_tiles"], "bit_equal": equal,
                   "old_ms": ms["old"], "new_ms": ms["new"]}
            print(json.dumps(row), flush=True)
            against.append(row)
            del sets
            torch.cuda.empty_cache()
        if not all(all(r["bit_equal"].values()) for r in against):
            print(json.dumps({"sweep": results, "against": against}), flush=True)
            raise SystemExit("the kernel does not give the older kernel's bits at every shape")
    print(json.dumps({"sweep": results, "against": against}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
