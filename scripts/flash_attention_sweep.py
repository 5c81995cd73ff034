#!/usr/bin/env python3
"""Time the flash-attention kernel's tile geometry and key splits on one card.

    python3 scripts/flash_attention_sweep.py

from the root of a checkout, on a machine with an H100 and nvcc. It builds
``src/repro_torch/kernels/csrc/flash_attention.cu`` once per (keys per
tile, ring stages) pair, with ``-DFA_KT`` and ``-DFA_STAGES``, all builds
started together, prints each build's ptxas register and spill lines, then
times every build at the shapes of ``chip_smoke.py``'s flash phase (its
inputs, its CUDA-graph timing) with the splits the wrapper plans, and the
default build at forced splits on the shapes whose grid is under the card's
SMs: the served admission chunk at each live-key count from 32 to 4,096 (a
chunk's cache prefix, as the engine hands it in) and qwen2.5-32b's verify
pass over a 4,096-row cache. Each result is held to the plain version
within ``chip_smoke``'s flash tolerance. One JSON line per result; the last
line is the whole table.
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

GEOMETRIES = [(32, 2), (32, 3), (64, 2), (64, 3), (128, 2), (128, 3)]
DEFAULT = (32, 2)
SPLITS = {"tpu_causal_128": [1, 2], "tpu_full_128": [1, 2],
          **{f"admit_off{o}": [1, 2, 3] for o in (0, 32, 64, 96)},
          **{f"admit4k_off{o}": [1, 2, 3, 4, 5, 8] for o in (224, 480, 992, 2016, 4064)},
          "gqa_512": [1, 2, 3, 4], "verify": [1, 2], "verify_g5_4k": [1, 2, 3, 4, 8]}
#: beyond the chip smoke's shapes: admission chunks at 512 and 1,024 live
#: keys, and qwen2.5-32b's verify pass (GQA 40/8: 64 blocks) late in a
#: 4,096-row cache
EXTRA_CASES = ([(f"admit4k_off{o}", 1, 32, 32, 32, o + 32, True, [o]) for o in (480, 992)]
               + [("verify_g5_4k", 8, 40, 8, 5, 4096, True,
                   [4091 - 37 * i for i in range(8)])])


def build_variants():
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    src = build.CSRC / "flash_attention.cu"
    procs = {}
    for kt, ns in GEOMETRIES:
        so = out_dir / f"flash_attention_kt{kt}_s{ns}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, f"-DFA_KT={kt}", f"-DFA_STAGES={ns}", "-o", str(so),
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
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    print(cs.gpu_name_and_power(), flush=True)
    libs = build_variants()
    d = 128
    results = []
    for name, b, hq, hkv, s, t, causal, offsets in cs.flash_cases() + EXTRA_CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(s * 7 + t)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((2, b, t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        qv, k, v = q.transpose(1, 2), kc[1].transpose(1, 2), vc[1].transpose(1, 2)
        off = torch.tensor(offsets, dtype=torch.int32, device=dev)
        want = fa.flash_attention_plain(qv, k, v, causal, None, off)
        tol = cs.FLASH_RTOL * want.float().abs() + cs.FLASH_VTOL * float(vc[1].float().abs().max())
        nbytes = 2 * q.numel() * 2 + 2 * kc[1].numel() * 2
        sets = [(qv, k.clone(), v.clone(), off) for _ in range(cs.copies_beyond_l2(nbytes))]
        iters = 20 if s * t > 2 ** 20 else 100
        runs = [(geo, None) for geo in GEOMETRIES]
        runs += [(DEFAULT, n) for n in SPLITS.get(name, [])]
        for geo, splits in runs:
            lib = fa.bind(ctypes.CDLL(str(libs[geo])))
            fa._library = lambda lib=lib: lib
            fn = lambda a, kk, vv, o, n=splits: fa.flash_attention_cuda(a, kk, vv, causal, None,
                                                                         o, splits=n)
            pl = fa.plan(b, hq, hkv, s, t)
            try:
                err = (fn(qv, k, v, off).float() - want.float()).abs()
                torch.cuda.synchronize()
            except RuntimeError as e:       # e.g. more shared memory than a block may have
                print(json.dumps({"case": name, "keys_per_tile": geo[0], "stages": geo[1],
                                  "error": str(e)}),
                      flush=True)
                continue
            if not bool((err <= tol).all()):
                raise SystemExit(f"{name} {geo} splits={splits}: max|err| {float(err.max())}")
            row = {"case": name, "keys_per_tile": geo[0], "stages": geo[1],
                   "splits": splits or pl["splits"], "splits_forced": splits is not None,
                   "max_abs_err": float(err.max()), "ms": cs.graph_ms(torch, fn, sets, iters)}
            print(json.dumps(row), flush=True)
            results.append(row)
        del sets, kc, vc
        torch.cuda.empty_cache()
    print(json.dumps({"sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
