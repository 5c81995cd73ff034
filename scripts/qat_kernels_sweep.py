#!/usr/bin/env python3
"""Hold the fake-quant and exact CASCADE kernels to earlier builds of
themselves bit for bit, and time both in turns on one card.

    python3 scripts/qat_kernels_sweep.py [--against-fq OLD.cu] [--against-ce OLD.cu]
                                         [--out FILE]

from the root of a checkout, on a machine with an H100 and nvcc. It builds
``csrc/fake_quant.cu`` and ``csrc/cascade_exact.cu`` (and, where given, the
earlier sources, e.g. ``git show <commit>:src/repro_torch/kernels/csrc/
fake_quant.cu`` saved under the git-ignored ``build/``: their C launchers as
they were before the launch plans, a strip width for the fake quant and no
plan for the exact matmul), all builds started together, and prints each
build's ptxas register and spill lines. Then:

* the fake quant at every ``chip_smoke.FQ_SHAPES`` weight, bf16 and f32:
  bit-equal to its plain version and to the earlier build (any NaN equal to
  any NaN), timed cold (weights rotated past L2, CUDA-graph replays) in
  turns, earlier, current, current, earlier, beside its byte bound; with
  ``--fq-widths`` also at each strip width the plan can take (128-, 64- and
  32-byte strip rows, ``fake_quant.best_cluster``), and with
  ``--fq-clusters`` at each cluster size the planned width can take
  (``fake_quant.geometry``), each bit-equal to the planned launch; with
  ``--fq-probes`` also timing probes of the planned launch, whose output is
  not the fake quant's, built here from copies of the kernel's source with
  one line changed (``PROBES``): no arithmetic (each segment written back
  as read: the copies, reductions and barriers alone), no cluster reduction
  (a block's own maxima), and both; beside them one ``torch.clone`` of the
  weight (a copy that reads and writes the same bytes, whole rows at a
  time);
* the exact matmul at ``chip_smoke.CE_SHAPES`` (M = 8; bit-equal to the
  plain version) and ``CE_SIM_SHAPES`` (precision_sim's M = 128 shapes),
  bit-equal to the earlier build, timed the same way;
  with ``--ce-tiles`` also rebuilt at other tile depths and ring lengths
  (``-DCE_KT_FEW``, ``-DCE_KT_MANY``, ``-DCE_STAGES``), each bit-equal to
  the committed build;
* one step's dependent latency and one f32 add's
  (``cascade_exact.chain_cycles``), and the exact kernel's SASS opcodes by
  function (``cuobjdump -sass``).

Any bit difference exits non-zero. One JSON line per result; the whole
table goes to ``--out`` (default ``chiprun_out/qat_kernels_sweep.json``).
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


def build_against(sources: dict) -> dict:
    """One nvcc per earlier source, all started together; name -> library."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f"{name}_against.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the earlier {name}:\n{log}")
        print(json.dumps({"build": f"{name} (earlier)", "ptxas": [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]}),
            flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


#: (k steps a tile at <= 16 rows a block, above, tiles in the ring) tried
#: beside the committed build (64, 32, 4) by --ce-tiles
CE_TILES = [(128, 32, 4), (32, 32, 4), (64, 64, 4), (64, 32, 3), (64, 32, 6)]


def build_tiles(tiles) -> dict:
    """The exact kernel rebuilt at each tile geometry, all builds started
    together; geometry -> library (its C launcher as committed)."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for few, many, stages in tiles:
        so = out_dir / f"ce_{few}_{many}_{stages}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, f"-DCE_KT_FEW={few}",
               f"-DCE_KT_MANY={many}", f"-DCE_STAGES={stages}", "-o", str(so),
               str(build.CSRC / "cascade_exact.cu")]
        procs[(few, many, stages)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for tiles {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cascade_exact_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        libs[key] = lib
    return libs


#: the timing probes: name -> the lines of csrc/fake_quant.cu replaced (each
#: must occur once), so that its output is no longer the fake quant's
PROBE_EDITS = {
    "no_arithmetic": [("fake_quant_segment<T, V>(buf[p * kThreads + tid], scale)",
                       "buf[p * kThreads + tid]")],
    "no_cluster_reduction": [("const bool remote = ranks > 1;", "const bool remote = false;")],
}
PROBES = {**PROBE_EDITS, "neither": PROBE_EDITS["no_arithmetic"]
          + PROBE_EDITS["no_cluster_reduction"]}


def build_probes() -> dict:
    """The fake quant built with each probe's edits (all checked before any
    build starts), all builds started together; probe name -> library."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "fake_quant.cu").read_text()
    for old, _ in PROBE_EDITS["no_arithmetic"] + PROBE_EDITS["no_cluster_reduction"]:
        if text.count(old) != 1:
            raise SystemExit(f"probe edit {old!r} occurs {text.count(old)} times in fake_quant.cu")
    procs = {}
    for name, edits in PROBES.items():
        src = text
        for old, new in edits:
            src = src.replace(old, new)
        cu, so = out_dir / f"fq_{name}.cu", out_dir / f"fq_{name}.so"
        cu.write_text(src)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for probe {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fake_quant_fp4_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, i,
                                              ctypes.POINTER(ctypes.c_int), p]
        libs[name] = lib
    return libs


def old_strip_width(b, k, n, g, sms=132):
    """The earlier fake quant's strip width: 32, 16 or 8 columns."""
    for cols in (32, 16):
        if -(-n // cols) * (k // g) * b >= 2 * sms:
            return cols
    return 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against-fq", type=Path)
    ap.add_argument("--against-ce", type=Path)
    ap.add_argument("--fq-widths", action="store_true")
    ap.add_argument("--fq-clusters", action="store_true")
    ap.add_argument("--fq-probes", action="store_true")
    ap.add_argument("--ce-tiles", action="store_true")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "qat_kernels_sweep.json")
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import cascade_exact as ce
    from repro_torch.kernels import fake_quant as fq

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    gpu = cs.gpu_name_and_power()
    print(gpu, flush=True)
    libs = build.build(["fake_quant", "cascade_exact"])
    for n, p in libs.items():
        print(json.dumps({"build": n, "ptxas": [
            ln.strip() for ln in p.with_suffix(".log").read_text().splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    old = build_against({k: v for k, v in (("fake_quant", args.against_fq),
                                           ("cascade_exact", args.against_ce)) if v})
    p, i = ctypes.c_void_p, ctypes.c_int
    if "fake_quant" in old:
        old["fake_quant"].fake_quant_fp4_launch.argtypes = [p, p, i, i, i, i, i, i, p]
    if "cascade_exact" in old:
        old["cascade_exact"].cascade_exact_launch.argtypes = [p, p, p, p, i, i, i, p]
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    table = {"gpu": gpu, "fake_quant_fp4": [], "cascade_exact": []}
    bad = []

    def fq_old(w, group, experts):
        n = w.shape[-1]
        b = w.shape[0] if experts else 1
        k = w.numel() // (n * b)
        g = quant.fake_quant_groups(k, group)
        out = torch.empty_like(w)
        rc = old["fake_quant"].fake_quant_fp4_launch(
            w.data_ptr(), out.data_ptr(), b, k, n, g, old_strip_width(b, k, n, g),
            int(w.dtype == torch.bfloat16), stream())
        assert rc == 0, rc
        return out

    probes = build_probes() if args.fq_probes else {}
    for case, shape, group, experts, _ in cs.FQ_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(len(case) + len(shape))
            w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
            b, k, n = shape[0] if experts else 1, shape[-2], shape[-1]
            g = quant.fake_quant_groups(k, group)
            planned = fq.plan(b, k, n, g, w.element_size())
            got = torch.empty_like(w)
            clusters = fq.launch_plan(w, got, b, k, n, g, planned)
            torch.cuda.synchronize()
            row = {"case": case, "shape": list(shape), "group": group,
                   "dtype": str(dtype).split(".")[-1], "plan": dict(planned),
                   "clusters": clusters,
                   "bit_equal_plain": cs.same_bits(torch, got,
                                                   quant.fake_quant_fp4_plain(w, group, experts))}
            nbytes = 2 * w.numel() * w.element_size()
            sets = [(w.clone(),) for _ in range(cs.copies_beyond_l2(nbytes))]
            new_fn = lambda t: fq.fake_quant_fp4_cuda(t, group, experts)
            if "fake_quant" in old:
                row["bit_equal_earlier"] = cs.same_bits(torch, got, fq_old(w, group, experts))
                old_fn = lambda t: fq_old(t, group, experts)
                o1, n1, n2, o2 = (cs.graph_ms(torch, f, sets, 20)
                                  for f in (old_fn, new_fn, new_fn, old_fn))
                row.update(earlier_ms=[o1, o2], ms=[n1, n2])
            else:
                row["ms"] = [cs.graph_ms(torch, new_fn, sets, 20)]
            if args.fq_widths:
                row["by_width"] = {}
                vector = row["plan"]["vec"] > 1
                for tpr in ((8, 4, 2) if vector else (32, 16, 8)):
                    pl = next((geo for cap in ((fq.LOADS_PREFERRED, fq.LOADS_MAX) if vector
                                               else (fq.SCALAR_LOADS_MAX,))
                               if (geo := fq.best_cluster(b, k, n, g, w.element_size(), True,
                                                          tpr, cap))), None)
                    if pl is None:          # a group too tall for one chunk at this width
                        continue

                    def width_fn(t, pl=pl):
                        o = torch.empty_like(t)
                        fq.launch_plan(t, o, b, k, n, g, pl)
                        return o
                    same = cs.same_bits(torch, got, width_fn(w))
                    bad += [] if same else [f"fake_quant {case} {row['dtype']} tpr={tpr}"]
                    row["by_width"][tpr] = {"plan": pl, "bit_equal": same,
                                            "ms": cs.graph_ms(torch, width_fn, sets, 20)}
            if probes:
                pl = row["plan"]
                row["probes"] = {"clone_ms": cs.graph_ms(torch, lambda t: t.clone(), sets, 20)}
                for name, lib in probes.items():
                    def probe_fn(t, lib=lib):
                        o = torch.empty_like(t)
                        fit = ctypes.c_int(0)
                        assert lib.fake_quant_fp4_launch(
                            t.data_ptr(), o.data_ptr(), b, k, n, g, pl["vec"], pl["tpr"],
                            pl["cluster"], pl["rows"], pl["loads"], pl["chunks"],
                            int(t.dtype == torch.bfloat16), ctypes.byref(fit), stream()) == 0
                        return o
                    row["probes"][f"{name}_ms"] = cs.graph_ms(torch, probe_fn, sets, 20)
            if args.fq_clusters:
                row["by_cluster"] = {}
                cap = fq.LOADS_MAX if row["plan"]["vec"] > 1 else fq.SCALAR_LOADS_MAX
                for size in range(1, fq.MAX_CLUSTER + 1):
                    pl = fq.geometry(b, k, n, g, w.element_size(), True, row["plan"]["tpr"],
                                     size, cap)
                    if pl is None or pl["chunks"] > 1:  # a block empty, or the group in chunks
                        continue

                    def cluster_fn(t, pl=pl):
                        o = torch.empty_like(t)
                        fq.launch_plan(t, o, b, k, n, g, pl)
                        return o
                    same = cs.same_bits(torch, got, cluster_fn(w))
                    bad += [] if same else [f"fake_quant {case} {row['dtype']} cluster={size}"]
                    o = torch.empty_like(w)
                    row["by_cluster"][size] = {"plan": pl, "bit_equal": same,
                                               "clusters": fq.launch_plan(w, o, b, k, n, g, pl),
                                               "ms": cs.graph_ms(torch, cluster_fn, sets, 20)}
            row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
            bad += [f"fake_quant {case} {row['dtype']}: {k}" for k in
                    ("bit_equal_plain", "bit_equal_earlier") if row.get(k) is False]
            print(json.dumps(row), flush=True)
            table["fake_quant_fp4"].append(row)
            del sets, got, w
            torch.cuda.empty_cache()

    def ce_old(x4, w4, bias):
        m, k = x4.shape
        n = w4.shape[1]
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        rc = old["cascade_exact"].cascade_exact_launch(
            x4.data_ptr(), w4.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, k, n, stream())
        assert rc == 0, rc
        return out

    tiles = build_tiles(CE_TILES) if args.ce_tiles else {}
    for m, k, n in cs.CE_SHAPES + [s[:3] for s in cs.CE_SIM_SHAPES]:
        gen = torch.Generator(device=dev).manual_seed(k + n + m)
        x4 = quant.fp4_round(torch.randn((m, k), generator=gen, device=dev) * 2.0)
        w4 = quant.fp4_round(torch.randn((k, n), generator=gen, device=dev) * 2.0)
        bias = torch.randn((n,), generator=gen, device=dev) * 4
        got = ce.cascade_matmul_exact_cuda(x4, w4, bias)
        torch.cuda.synchronize()
        row = {"M": m, "K": k, "N": n, "plan": ce.plan(m, n)}
        if m <= 8:
            row["bit_equal_plain"] = cs.same_bits(
                torch, got, quant.cascade_matmul_exact(x4, w4, bias))
        iters = 10 if m <= 8 else 2
        sets = [(x4, w4.clone(), bias) for _ in range(cs.copies_beyond_l2(w4.numel() * 4))]
        if "cascade_exact" in old:
            row["bit_equal_earlier"] = cs.same_bits(torch, got, ce_old(x4, w4, bias))
            o1, n1, n2, o2 = (cs.graph_ms(torch, f, sets, iters) for f in
                              (ce_old, ce.cascade_matmul_exact_cuda,
                               ce.cascade_matmul_exact_cuda, ce_old))
            row.update(earlier_ms=[o1, o2], ms=[n1, n2])
        else:
            row["ms"] = [cs.graph_ms(torch, ce.cascade_matmul_exact_cuda, sets, iters)]
        if tiles:
            row["by_tiles"] = {}
            pl = ce.plan(m, n)
            for key, lib in tiles.items():
                def tile_fn(a, b, c, lib=lib):
                    o = torch.empty((m, n), dtype=torch.float32, device=dev)
                    rc = lib.cascade_exact_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                  o.data_ptr(), m, k, n, pl["rows"],
                                                  pl["warps"], stream())
                    assert rc == 0, rc
                    return o
                same = cs.same_bits(torch, got, tile_fn(x4, w4, bias))
                bad += [] if same else [f"cascade_exact {m}x{k}->{n} tiles {key}"]
                row["by_tiles"]["%d/%d/%d" % key] = {
                    "bit_equal": same, "ms": cs.graph_ms(torch, tile_fn, sets, iters)}
        bad += [f"cascade_exact {m}x{k}->{n}: {key}" for key in
                ("bit_equal_plain", "bit_equal_earlier") if row.get(key) is False]
        print(json.dumps(row), flush=True)
        table["cascade_exact"].append(row)
        del sets
        torch.cuda.empty_cache()

    chain = ce.chain_cycles(cs.CE_CHAIN_STEPS, dev)
    chain.update(cycles_per_step=chain["cycles"] / chain["steps"],
                 ns_per_step=chain["ms"] * 1e6 / chain["steps"])
    add = ce.chain_cycles(cs.CE_ADD_STEPS, dev, add=True)
    add.update(cycles_per_add=add["cycles"] / add["steps"],
               ns_per_add=add["ms"] * 1e6 / add["steps"])
    sass = {f: dict(c) for f, c in cs.sass_opcodes(libs["cascade_exact"]).items()}
    table.update(chain=chain, add_chain=add, sass=sass)
    print(json.dumps({"chain": chain, "add_chain": add}), flush=True)
    print(json.dumps({"sass": sass}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(table, indent=1))
    if bad:
        print(json.dumps({"bit_differences": bad}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
