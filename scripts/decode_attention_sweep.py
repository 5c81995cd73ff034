#!/usr/bin/env python3
"""Time the decode-attention kernel's tile geometry and T-splits on one card.

    python3 scripts/decode_attention_sweep.py

from the root of a checkout, on a machine with an H100 and nvcc. It builds
``src/repro_torch/kernels/csrc/decode_attention.cu`` once per (keys per
tile, ring stages) pair, with ``-DDA_KT`` and ``-DDA_STAGES``, all builds
started together, prints each build's ptxas register and shared-memory
lines, then times every build at the three shapes of ``chip_smoke.py``'s
attention phase (its inputs, its CUDA-graph timing) with the splits the
wrapper chooses, and the default build at several forced splits. Each
result is held to the plain version within ``chip_smoke.ATTN_ATOL``. One
JSON line per result; the last line is the whole table.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GEOMETRIES = [(32, 2), (32, 3), (32, 4), (64, 2), (64, 3)]
SPLITS = {"qwen2.5-32b_gqa": [1, 2, 3], "long_4096": [1, 2, 3, 4, 6, 8, 12, 16]}


def build_variants():
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    src = build.CSRC / "decode_attention.cu"
    procs = {}
    for kt, ns in GEOMETRIES:
        so = out_dir / f"decode_attention_kt{kt}_s{ns}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, f"-DDA_KT={kt}", f"-DDA_STAGES={ns}", "-o", str(so),
               str(src)]
        procs[(kt, ns)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        print(json.dumps({"geometry": key, "ptxas": [ln.strip() for ln in log.splitlines()
                                                     if "registers" in ln or "spill" in ln]}),
              flush=True)
        libs[key] = so
    return libs


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    print(cs.gpu_name_and_power(), flush=True)
    libs = build_variants()
    d = 128
    results = []
    for name, b, hq, hkv, t, positions in cs.decode_attention_cases():
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = kc[1], vc[1]
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        want = da.decode_attention_plain(q, k, v, q_pos=pos)
        nc = cs.copies_beyond_l2(k.numel() * 4)
        sets = [(q, k if i == 0 else k.clone(), v if i == 0 else v.clone(), pos)
                for i in range(nc)]
        iters = 20 if t > 1024 else 100
        runs = [(geo, None) for geo in GEOMETRIES]
        runs += [(geo, s) for geo in ((32, 2), (32, 3)) for s in SPLITS.get(name, [])]
        for geo, splits in runs:
            lib = da.bind(ctypes.CDLL(str(libs[geo])))
            da._library = lambda lib=lib: lib
            fn = lambda a, kk, vv, p, s=splits: da.decode_attention_cuda(a, kk, vv, None, None,
                                                                          p, splits=s)
            err = float((fn(q, k, v, pos) - want).abs().max())
            torch.cuda.synchronize()
            if not err <= cs.ATTN_ATOL:
                raise SystemExit(f"{name} {geo} splits={splits}: max|err| {err}")
            row = {"case": name, "keys_per_tile": geo[0], "stages": geo[1],
                   "splits": splits or da.choose_splits(b, hkv, hq // hkv, t),
                   "splits_forced": splits is not None, "max_abs_err": err,
                   "ms": cs.graph_ms(torch, fn, sets, iters)}
            print(json.dumps(row), flush=True)
            results.append(row)
        del sets, kc, vc
        torch.cuda.empty_cache()
    print(json.dumps({"sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
