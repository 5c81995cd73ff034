#!/usr/bin/env python3
"""Hold the grouped FP4 expert matmul to an earlier build of it bit for bit,
time the two in turns on one card, and time probes that say what limits it.

    python3 scripts/grouped_matmul_sweep.py [--against-grouped OLD.cu] [--probes]
                                            [--variants] [--out FILE]

from the root of a checkout, on a machine with an H100 and nvcc. It builds
``csrc/cascade_matmul_grouped.cu`` and, where given, an earlier source of the
grouped entry (``git show <commit>:src/repro_torch/kernels/csrc/
cascade_matmul.cu`` saved under the git-ignored ``build/``, whose C entry
``cascade_matmul_grouped_launch`` takes one stack and an m-tiles plan of 1),
all builds started together, and prints each build's ptxas register and
spill lines. Then, at every ``chip_smoke.GROUPED_SHAPES`` row (rows routed
top-k as the smoke routes them; the pair rows' two stacks in one launch)
and at the card tests' cases (``CARD_CASES``), at bf16 and f32 out:

* every output is held bit for bit to the earlier build (the pair's to two
  earlier launches) and its rows past ``rows[e]`` to exact zeros;
* the two are timed cold (weights rotated past L2, CUDA-graph replays) in
  turns, earlier, current, current, earlier, at bf16 out;
* with ``--probes``, timing probes of the current kernel, built here from
  copies of its source with one line changed (``PROBE_EDITS``; their output
  is not the matmul's): no table lookup (the packed bytes go to the mma
  as they are), no mma (the loads and lookups alone), no zero stores; beside
  them one ``torch.clone`` of the live experts' packed bytes (a copy of the
  same weight bytes);
* with ``--variants``, the kernel rebuilt with another ring (``VARIANTS``:
  one line of its geometry changed), each bit-equal to the committed build.

With ``--against-grouped``, the earlier source's plain entry
(``cascade_matmul_launch``, whose C interface is unchanged) is also held bit
for bit to the current ``csrc/cascade_matmul.cu`` at every
``chip_smoke.matmul_shapes()`` row, bf16 and f32 out, and the two are timed
in turns there (bf16 out): the plain kernel lost its grouped branches when
the grouped kernel moved out, and must keep its bits and its times.

Any bit difference exits non-zero. One JSON line per result; the whole table
goes to ``--out`` (default ``results/grouped_matmul_sweep.json``).
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

SOURCE = "cascade_matmul_grouped.cu"
#: (E, C, K, N, group): the card tests' cases (tests/test_torch_gpu.py,
#: GROUPED_CASES)
CARD_CASES = [(64, 8, 2048, 1024, 0), (64, 8, 1024, 2048, 0), (64, 32, 2048, 1024, 0),
              (64, 40, 1024, 2048, 0), (160, 8, 5120, 1536, 0), (160, 8, 1536, 5120, 0),
              (5, 65, 258, 301, 0), (3, 17, 96, 40, 0), (64, 1, 2048, 1024, 0),
              (160, 40, 5120, 1536, 0), (8, 24, 512, 256, 32), (6, 40, 240, 136, 24),
              (5, 9, 96, 300, 32), (4, 33, 144, 72, 24)]
#: the timing probes: name -> the lines of the source replaced (each must
#: occur once)
PROBE_EDITS = {
    "no_lookup": [("      const uint32_t b0 = lut_lane[((w0 >> (8 * j)) & 0xFFu) << 5];\n"
                   "      const uint32_t b1 = lut_lane[((w1 >> (8 * j)) & 0xFFu) << 5];\n",
                   "      const uint32_t b0 = w0 << j;\n"
                   "      const uint32_t b1 = w1 << j;\n")],
    "no_mma": [("      mma_bf16_16816(part[j], av[0] & m01, av[1] & m01, av[2] & m23, "
                "av[3] & m23, b0, b1);\n",
                "      part[j][0] += __uint_as_float((b0 ^ b1 ^ av[0] ^ av[3]) & m01 & m23);\n")],
    "no_zero_stores": [("      if (m < live_rows(a, e)) continue;\n", "      continue;\n")],
}
#: other rings: name -> (edits, stages, k16 steps of each slice a stage);
#: the plan's fields follow
VARIANTS = {
    "steps4_stages4": ([("constexpr int kSteps = 8; ", "constexpr int kSteps = 4; "),
                        ("constexpr int kStages = 3; ", "constexpr int kStages = 4; ")], 4, 4),
    "stages2": ([("constexpr int kStages = 3; ", "constexpr int kStages = 2; ")], 2, 8),
}


def build_sources(sources: dict) -> dict:
    """One nvcc per source, all started together; name -> (library, ptxas
    lines). ``sources``: name -> source path."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f"grouped_{name}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(json.dumps({"build": name, "ptxas": lines}), flush=True)
        out[name] = (ctypes.CDLL(str(so)), lines)
    return out


def edited_sources(edits_by_name: dict) -> dict:
    """The committed source with each name's edits (all checked first),
    written under build/kernels/sweep; name -> path."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / SOURCE).read_text()
    paths = {}
    for name, edits in edits_by_name.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"edit {old!r} of {name} occurs {src.count(old)} times")
            src = src.replace(old, new)
        paths[name] = out_dir / f"grouped_{name}.cu"
        paths[name].write_text(src)
    return paths


def plain_against_earlier(torch, cs, cm, earlier, dev, bad: list) -> list:
    """The plain entry of the earlier build against the current one at every
    smoke matmul shape: bits at bf16 and f32 out, and ms in turns (earlier,
    current, current, earlier) at bf16 out."""
    from repro_torch.core import quant
    old = cm.bind(earlier)
    new = cm._library()
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []

    def call(lib, x, packed, scales, bias, odt):
        m, k = x.shape
        n = packed.shape[1]
        out = torch.empty((m, n), dtype=odt, device=dev)
        group = k // scales.shape[0]
        rc = lib.cascade_matmul_launch(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(), m, k, n, group,
            int(odt == torch.bfloat16), cm.plan(m, k, n, group)["m_tiles"],
            torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, rc
        return out
    for arch, m, k, n, with_bias, _, _ in cs.matmul_shapes():
        packed, scales = quant.quantize_weight(
            torch.randn((k, n), generator=gen, device=dev) / k ** 0.5, 0)
        bias = torch.randn((n,), generator=gen, device=dev) if with_bias else None
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        row = {"arch": arch, "M": m, "K": k, "N": n, "bias": with_bias}
        for odt in (torch.bfloat16, torch.float32):
            same = torch.equal(call(old, x, packed, scales, bias, odt),
                               call(new, x, packed, scales, bias, odt))
            row[f"bit_equal_{str(odt).split('.')[-1]}"] = same
            bad += [] if same else [f"plain entry {arch} {m}x{k}->{n} {odt}"]
        sets = [(x, packed.clone(), scales.clone(), bias)
                for _ in range(cs.copies_beyond_l2(packed.numel()))]
        fns = {w: (lambda a, p, sc, b, lib=lib: call(lib, a, p, sc, b, torch.bfloat16))
               for w, lib in (("earlier", old), ("current", new))}
        o1, n1, n2, o2 = (cs.graph_ms(torch, fns[w], sets, 40)
                          for w in ("earlier", "current", "current", "earlier"))
        row.update(earlier_ms=[o1, o2], ms=[n1, n2])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del sets
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against-grouped", type=Path)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "grouped_matmul_sweep.json")
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import cascade_matmul as cm

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    gpu = cs.gpu_name_and_power()
    print(gpu, flush=True)
    sources = {"committed": build.CSRC / SOURCE}
    if args.against_grouped:
        sources["earlier"] = args.against_grouped
    if args.probes:
        sources.update(edited_sources(PROBE_EDITS))
    if args.variants:
        sources.update(edited_sources({k: v[0] for k, v in VARIANTS.items()}))
    built = build_sources(sources)
    libs = {k: (cm.bind_grouped(lib) if k != "earlier" else lib) for k, (lib, _) in built.items()}
    if "earlier" in libs:
        p, i = ctypes.c_void_p, ctypes.c_int
        libs["earlier"].cascade_matmul_grouped_launch.argtypes = [p] * 5 + [i] * 7 + [p]
        libs["earlier"].cascade_matmul_grouped_launch.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    table = {"gpu": gpu, "ptxas": {k: v[1] for k, v in built.items()}, "rows": []}
    bad = []

    def plan_for(name, e, n):
        """The committed plan, or a variant's (its stages and steps)."""
        pl = cm.plan_grouped(e, n)
        if name in VARIANTS:
            _, stages, steps = VARIANTS[name]
            ring = stages * 2 * steps * (8 * 128 + 16 * 32)
            pl = {**pl, "stages": stages, "steps_a_stage": steps,
                  "smem_bytes": 256 * 32 * 4 + ring + 4 * 4 * 32 * 16
                  + -(-4 * (e + 1) // 16) * 16}
        return pl

    def run(name, x, stacks, rows, out_dtype):
        """The current (or an edited) build, all stacks in one launch."""
        lib = libs[name]
        e, c, k = x.shape
        n = stacks[0][0].shape[2]
        group = k // stacks[0][1].shape[1]
        outs = [torch.empty((e, c, n), dtype=out_dtype, device=dev) for _ in stacks]
        pl = plan_for(name, e, n)
        fit, sms = ctypes.c_int(0), ctypes.c_int(0)
        assert lib.cascade_matmul_grouped_occupancy(
            int(out_dtype == torch.bfloat16), cm.grouped_mode(k, group), pl["smem_bytes"],
            ctypes.byref(fit), ctypes.byref(sms)) == 0
        two = len(stacks) == 2
        rc = lib.cascade_matmul_grouped_launch(
            x.data_ptr(), stacks[0][0].data_ptr(), stacks[0][1].data_ptr(), outs[0].data_ptr(),
            stacks[1][0].data_ptr() if two else None, stacks[1][1].data_ptr() if two else None,
            outs[1].data_ptr() if two else None, rows.data_ptr(), e, c, k, n, group,
            int(out_dtype == torch.bfloat16), pl["col_tile"], pl["stages"], pl["threads"],
            pl["smem_bytes"], fit.value * sms.value, stream())
        assert rc == 0, (name, rc)
        return outs

    def earlier(x, stacks, rows, out_dtype):
        """The earlier build: one launch a stack."""
        e, c, k = x.shape
        outs = []
        for packed, scales in stacks:
            n = packed.shape[2]
            out = torch.empty((e, c, n), dtype=out_dtype, device=dev)
            rc = libs["earlier"].cascade_matmul_grouped_launch(
                x.data_ptr(), packed.data_ptr(), scales.data_ptr(), rows.data_ptr(),
                out.data_ptr(), e, c, k, n, k // scales.shape[1],
                int(out_dtype == torch.bfloat16), 1, stream())
            assert rc == 0, rc
            outs.append(out)
        return outs

    def inputs(e, c, k, n, top, stacks, group, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        st = []
        for _ in range(stacks):
            ws = [quant.quantize_weight(torch.randn((k, n), generator=gen, device=dev), group)
                  for _ in range(e)]
            st.append((torch.stack([w[0] for w in ws]), torch.stack([w[1] for w in ws])))
        picks = torch.argsort(torch.rand((c, e), generator=gen, device=dev), dim=-1)[:, :top]
        rows = torch.bincount(picks.flatten(), minlength=e).clamp(max=c).to(torch.int32)
        x = torch.randn((e, c, k), generator=gen, device=dev) / k ** 0.5
        live = torch.arange(c, device=dev)[None, :] < rows[:, None]
        return torch.where(live[..., None], x, 0.0).to(torch.bfloat16), st, rows, live

    cases = ([("served", arch, e, top, k, n, c, stacks, 0)
              for arch, e, top, k, n, c, stacks, _ in cs.GROUPED_SHAPES]
             + [("card", "", e, min(8, e - 1), k, n, c, 1, group)
                for e, c, k, n, group in CARD_CASES])
    for kind, arch, e, top, k, n, c, nst, group in cases:
        x, stacks, rows, live = inputs(e, c, k, n, top, nst, group, seed=e + k + c + nst)
        row = {"kind": kind, "arch": arch, "E": e, "C": c, "K": k, "N": n, "group": group,
               "stacks": nst, "experts_with_rows": int((rows > 0).sum()),
               "plan": cm.plan_grouped(e, n)}
        for odt in (torch.bfloat16, torch.float32):
            got = run("committed", x, stacks, rows, odt)
            key = str(odt).split(".")[-1]
            row[f"zeros_past_rows_{key}"] = all(not bool(o[~live].any()) for o in got)
            if "earlier" in libs:
                want = earlier(x, stacks, rows, odt)
                torch.cuda.synchronize()
                row[f"bit_equal_earlier_{key}"] = all(torch.equal(a, b)
                                                      for a, b in zip(got, want))
            if args.variants:
                for name in VARIANTS:
                    same = all(torch.equal(a, b) for a, b in
                               zip(got, run(name, x, stacks, rows, odt)))
                    row.setdefault("variants_bit_equal", {})[f"{name} {key}"] = same
                    bad += [] if same else [f"{arch} {e}x{c} {k}->{n} variant {name} {key}"]
        bad += [f"{kind} {arch} {nst} x {e}x{c} {k}->{n} group {group}: {key}"
                for key, v in row.items() if key.startswith(("bit_equal", "zeros")) and v is False]
        if kind == "served":
            flat = [t for st in stacks for t in st]
            nc = cs.copies_beyond_l2(sum(t.numel() * t.element_size() for t in flat))
            sets = [(x, *[t if i == 0 else t.clone() for t in flat], rows) for i in range(nc)]
            pairs = lambda ts: [(ts[2 * j], ts[2 * j + 1]) for j in range(nst)]
            new_fn = lambda a, *ts: run("committed", a, pairs(ts[:-1]), ts[-1], torch.bfloat16)
            if "earlier" in libs:
                old_fn = lambda a, *ts: earlier(a, pairs(ts[:-1]), ts[-1], torch.bfloat16)
                o1, n1, n2, o2 = (cs.graph_ms(torch, f, sets, 40)
                                  for f in (old_fn, new_fn, new_fn, old_fn))
                row.update(earlier_ms=[o1, o2], ms=[n1, n2])
            else:
                row["ms"] = [cs.graph_ms(torch, new_fn, sets, 40)]
            if args.probes:
                liveb = torch.cat([p[rows > 0].reshape(-1) for p, _ in stacks])
                clone_sets = [(liveb if i == 0 else liveb.clone(),)
                              for i in range(cs.copies_beyond_l2(liveb.numel()))]
                row["probes"] = {"clone_live_packed_ms": cs.graph_ms(
                    torch, lambda t: t.clone(), clone_sets, 40)}
                for name in PROBE_EDITS:
                    fn = lambda a, *ts, name=name: run(name, a, pairs(ts[:-1]), ts[-1],
                                                       torch.bfloat16)
                    row["probes"][f"{name}_ms"] = cs.graph_ms(torch, fn, sets, 40)
            if args.variants:
                row["variants_ms"] = {}
                for name in VARIANTS:
                    fn = lambda a, *ts, name=name: run(name, a, pairs(ts[:-1]), ts[-1],
                                                       torch.bfloat16)
                    row["variants_ms"][name] = cs.graph_ms(torch, fn, sets, 40)
            wbytes = sum(p.numel() // e + s.numel() // e * 4 for p, s in stacks) \
                * row["experts_with_rows"]
            nbytes = wbytes + int(rows.sum()) * k * 2 + nst * e * c * n * 2
            row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
            del sets
        print(json.dumps(row), flush=True)
        table["rows"].append(row)
        del x, stacks
        torch.cuda.empty_cache()
    if "earlier" in libs:
        table["plain_entry"] = plain_against_earlier(torch, cs, cm, built["earlier"][0], dev,
                                                     bad)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(table, indent=1))
    if bad:
        print(json.dumps({"bit_differences": bad}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
