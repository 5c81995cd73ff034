"""Serving-contract audit CLI: the repo lint plus the audit matrix over the
port's serving families (the counterpart of the reference's
``benchmarks/audit.py``).

* **lint** -- the AST rules over ``src/repro_torch`` (``analysis/lint.py``).
* **cells** -- for each family (its smoke config, ``FAMILY_SMOKE``) x mode,
  an engine built as the reference builds it (``temperature > 0`` and
  ``draft_len > 0``, so every closure exists): it serves a tiny trace twice
  (``analysis/retrace.py``: the second run builds and plans nothing new),
  then every step closure is called and held to the serving contract
  (``analysis/contract.py``). A combination the engine downgrades is not
  skipped: the cell records the downgrade (``status: "downgraded"``), an
  info finding where ``EXPECTED_DOWNGRADES`` names it and an error
  elsewhere.

Modes: ``dense`` (bf16 or f32 weights, the dense cache), ``fused`` (FP4
weights through the kernels), ``paged`` (dense weights, the paged cache
with the prefix cache), ``fused-paged`` (both). The kernels run on the card
(bf16); on the CPU (``--device cpu``, f32) their plain versions do. It
measures no speed. Exit status 1 on any unallowlisted error finding.

Known limitations (facts the engine never promised, kept VISIBLE as
allowlisted findings rather than relaxed) are the short table
``KNOWN_LIMITATIONS``.

Usage:
    PYTHONPATH=src python -m repro_torch.analysis.audit [--device cpu] \\
        [--families transformer moe] [--modes dense fused paged] \\
        [--out results/audit_torch.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import contract, lint, retrace
from repro_torch.analysis.findings import Finding, format_findings, gating
from repro_torch.core import cascade
from repro_torch.core.cascade import CascadeConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

REPO = Path(__file__).resolve().parents[3]
MODES = ("dense", "fused", "paged", "fused-paged")

#: (check, family, route, packed leaf) patterns whose findings are
#: allowlisted, each with its reason; keep this table SHORT: every entry is a
#: debt. ``leaf`` is matched against the end of the leaf's path, so a weight
#: densified anywhere else still gates.
KNOWN_LIMITATIONS = (
    {"check": "densified-weight", "family": "moe", "route": "kernel", "leaf": "attn/wkv_b",
     "reason": "MLA's absorbed attention dequantizes wkv_b (kv_lora x H*(nope+v)) in every "
               "layer of every step, as the reference does (models/moe.py mla_apply; ROADMAP "
               "Queue 2 item 5d)"},
)


#: (family, mode) cells the engine serves with the dense cache, with its
#: reason; any other downgrade gates
EXPECTED_DOWNGRADES = {
    (family, mode): "its cache state (ring-buffer KV, recurrent state) has no page-granular "
                    "layout: the engine serves the dense cache"
    for family in ("griffin", "ssm") for mode in ("paged", "fused-paged")}


def _mark_known(family: str, route: str, findings) -> None:
    for f in findings:
        leaf = f.where.split(":", 1)[-1]
        for k in KNOWN_LIMITATIONS:
            if (f.check == k["check"] and family == k["family"] and route == k["route"]
                    and (leaf == k["leaf"] or leaf.endswith("/" + k["leaf"]))
                    and f.level == "error" and not f.allowlisted):
                f.allowlisted = True
                f.detail += f" [known limitation: {k['reason']}]"


def build_engine(arch: str, mode: str, device, smoke: bool = True, seed: int = 0,
                 params=None, **scfg):
    """An engine as the audit builds it: ``scfg`` overrides the tiny
    defaults (4 slots, 48 rows, chunks of 8, temperature 0.7, 2 drafts).
    Smoke configs draw dense params and quantize them (as the reference);
    a full-width config draws its FP4 params directly, or takes ``params``
    (an FP4 tree of that config) so that two cells share one."""
    cfg, model = registry.load(arch, smoke=smoke)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    fused = mode.startswith("fused")
    train = CascadeConfig(mode="train", compute_dtype=dtype)
    serve = CascadeConfig(mode="serve_fp4", compute_dtype=dtype)
    if fused and not smoke:
        ccfg = serve
        params = params if params is not None else model.init_params(seed, serve, device=device)
    else:
        params = model.init_params(seed, train, device=device)
        ccfg = train
        if fused:
            ccfg, params = serve, cascade.tree_to_serve_fp4(params, serve)
    opts = dict(max_batch=4, max_len=48, temperature=0.7, draft_len=2, prefill_chunk=8,
                fused=fused, prefix_cache=mode.endswith("paged"))
    opts.update(scfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(model, params, ccfg, ServeConfig(**opts), device=device)
    return cfg, eng


def trace_requests(vocab: int, n: int = 6, prompt_len: int = 10, max_new: int = 6) -> list:
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, vocab, prompt_len).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def serve(eng: ServeEngine, reqs: list) -> list:
    for r in reqs:
        eng.submit(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        while eng.busy():
            eng.step()
    return reqs


def run_cell(family: str, arch: str, mode: str, device=None, smoke: bool = True,
             n_requests: int = 6, prompt_len: int = 10, max_new: int = 6, **scfg) -> dict:
    """One matrix cell: construct, check the mode engaged (or record the
    downgrade), serve the trace twice (rebuild guard), then call and audit
    every closure."""
    device = resolve_device(device)
    cell = {"family": family, "arch": arch, "mode": mode, "smoke": smoke,
            "device": str(device), "status": "audited", "downgrades": [], "closures": {},
            "findings": []}
    cfg, eng = build_engine(arch, mode, device, smoke=smoke, **scfg)
    cell["downgrades"] = list(eng.downgrades)
    cell["effective_mode"] = eng.effective_mode
    engaged = (not mode.startswith("fused") or eng.fused) and \
        (not mode.endswith("paged") or eng.paged)
    if not engaged:
        why = EXPECTED_DOWNGRADES.get((family, mode))
        cell["status"] = "downgraded"
        cell["findings"] = [Finding(
            "downgrade", f"{family}/{mode}",
            f"served as {eng.effective_mode}: " + (why or "; ".join(eng.downgrades)),
            level="info" if why else "error").to_dict()]
        return cell
    route = "kernel" if eng.fused and device.type == "cuda" else "plain"
    served = []
    findings = retrace.retrace_findings(
        lambda: served.append(serve(eng, trace_requests(cfg.vocab, n_requests, prompt_len,
                                                        max_new))),
        kernel_route=(route == "kernel"))
    cell["trace"] = {"requests": n_requests, "prompt_len": prompt_len, "max_new": max_new,
                     "completed": sum(r.done and len(r.tokens_out) == max_new
                                      for reqs in served for r in reqs)}
    res = contract.audit_engine(eng)
    findings.extend(res["findings"])
    _mark_known(family, route, findings)
    cell.update(route=route, closures=res["closures"], contract=res["contract"],
                findings=[f.to_dict() for f in findings])
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="repo lint + serving-contract audit matrix")
    ap.add_argument("--families", nargs="*", default=None,
                    help="serving families to audit (default: all four)")
    ap.add_argument("--modes", nargs="*", default=["dense", "fused", "paged"], choices=MODES)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--out", default="results/audit_torch.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    lint_findings = lint.lint_paths(["src/repro_torch"], base=REPO)
    out = {"lint": [f.to_dict() for f in lint_findings], "cells": [], "summary": {}}
    all_findings = list(lint_findings)
    print(f"lint: {len(lint_findings)} finding(s), {len(gating(lint_findings))} gating")

    for family in args.families or list(registry.FAMILY_SMOKE):
        arch = registry.FAMILY_SMOKE[family]
        for mode in args.modes:
            cell = run_cell(family, arch, mode, device)
            out["cells"].append(cell)
            fs = [Finding.from_dict(d) for d in cell["findings"]]
            all_findings.extend(fs)
            print(f"{family}/{mode}: {cell['status']}, {len(cell['closures'])} closure(s), "
                  f"{len(fs)} finding(s), {len(gating(fs))} gating")
            if gating(fs):
                print(format_findings(gating(fs)))

    bad = gating(all_findings)
    out["summary"] = {
        "cells": len(out["cells"]),
        "audited": sum(c["status"] == "audited" for c in out["cells"]),
        "downgraded": sum(c["status"] == "downgraded" for c in out["cells"]),
        "findings": len(all_findings), "gating": len(bad),
        "allowlisted": [dataclasses.asdict(f) for f in all_findings if f.allowlisted]}
    outp = Path(args.out)
    if not outp.is_absolute():
        outp = REPO / outp
    outp.parent.mkdir(parents=True, exist_ok=True)
    outp.write_text(json.dumps(out, indent=2, default=str))
    print(f"wrote {outp}: {len(out['cells'])} cells, {out['summary']['gating']} gating")
    if bad:
        print(f"\nAUDIT FAILED: {len(bad)} unallowlisted finding(s)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
