"""Repo lint: the port's serving invariants as named AST rules.

The step audit (``analysis/contract.py``) checks what a step does when it
runs; this half checks the SOURCE, each rule the counterpart of one of the
reference's (``repro/analysis/lint.py``):

* ``time-read``          -- no direct ``time.*`` reads (or ``time`` imports)
                            in ``serve/`` outside ``traffic.py``: every
                            serving-path latency number reads the injected
                            ``Clock``, so traffic tests replay
                            deterministically under ``VirtualClock``.
* ``host-sync-in-step``  -- no ``.item()``, ``.tolist()``, ``.cpu()``,
                            ``.numpy()`` or ``torch.cuda.synchronize()`` in
                            the step code: the model step methods in
                            ``models/`` and the kernel wrappers in
                            ``kernels/ops.py``. A read to the host inside a
                            step stalls the card's queue (the counterpart of
                            ``host-sync-in-jit``).
* ``torch-global-state`` -- no process-global torch setting
                            (``torch.set_float32_matmul_precision``,
                            ``set_default_dtype``, ``set_default_device``,
                            ``use_deterministic_algorithms``,
                            ``torch.cuda.set_sync_debug_mode``, assignments
                            under ``torch.backends``) outside allowlisted
                            sites: a stray switch changes the numerics of
                            every other engine in the process (the
                            counterpart of ``jax-config-global``).
* ``kernel-plain-pair``  -- every function of ``kernels/ops.py`` that
                            launches a built kernel (calls a ``*_cuda``
                            function) also names its plain version (a
                            ``*_plain`` function, or the function of the
                            same name elsewhere), so each kernel stays
                            reachable on the CPU parity path (the
                            counterpart of ``pallas-interpret``).

Findings carry ``file:line``. Allowlist a site by putting
``# lint: allow[rule-name] — reason`` on the flagged line or the line
directly above it; allowlisted findings stay visible in reports but do not
gate. Run as ``python -m repro_torch.analysis.lint [root ...]`` (default:
``src/repro_torch``); exits 1 on unallowlisted findings.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.findings import Finding, format_findings, gating

RULES = {
    "time-read": "serve/ reads the injected Clock, never time.* directly "
                 "(traffic.py owns the one wall-clock shim)",
    "host-sync-in-step": "no .item()/.tolist()/.cpu()/.numpy()/torch.cuda.synchronize() "
                         "in the model step methods or the kernel wrappers",
    "torch-global-state": "no process-global torch setting outside designated sites",
    "kernel-plain-pair": "every kernel launch in kernels/ops.py names its plain version",
}

#: the model methods a serving step calls (``ServeEngine.step_closures``,
#: and ``prefill`` in the slot-wise loop)
STEP_METHODS = ("decode_step", "prefill_extend", "spec_verify", "spec_rewind", "write_cache",
                "paged_copy_page", "prefill")
_HOST_READS = ("item", "tolist", "cpu", "numpy")
_GLOBAL_SETTERS = ("set_float32_matmul_precision", "set_default_dtype", "set_default_device",
                   "use_deterministic_algorithms", "set_sync_debug_mode")


def _allowed(rule: str, lines: List[str], lineno: int) -> bool:
    """``# lint: allow[rule]`` on the flagged line or the line above."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and f"lint: allow[{rule}]" in lines[ln - 1]:
            return True
    return False


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for a chain of attributes on a name, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    return ".".join([node.id] + parts[::-1])


def _step_bodies(tree: ast.AST, rel: str):
    """The function nodes whose bodies are step code in this file."""
    if rel.endswith("kernels/ops.py"):
        yield from (n for n in tree.body if isinstance(n, ast.FunctionDef))
    elif "models/" in rel:
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name in STEP_METHODS:
                yield node


def _host_sync_hits(fn: ast.FunctionDef):
    """(lineno, what) for host reads inside one step body."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if _dotted(f) == "torch.cuda.synchronize":
            yield node.lineno, "torch.cuda.synchronize()"
        elif isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
            yield node.lineno, f".{f.attr}() read to the host"


def _names(fn: ast.AST):
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr


def lint_source(src: str, rel: str) -> List[Finding]:
    """Lint one file's source. ``rel`` is the repo-relative posix path used
    both for findings and for path-scoped rules."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Finding("parse", f"{rel}:{e.lineno or 0}", f"unparseable: {e.msg}")]
    lines = src.splitlines()
    findings: List[Finding] = []

    def add(rule: str, lineno: int, detail: str):
        findings.append(Finding(rule, f"{rel}:{lineno}", detail,
                                allowlisted=_allowed(rule, lines, lineno)))

    if "serve/" in rel and not rel.endswith("traffic.py"):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                if any(a.name == "time" for a in node.names):
                    add("time-read", node.lineno,
                        "serve/ imports time — read the injected Clock")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    add("time-read", node.lineno,
                        "serve/ imports from time — read the injected Clock")
            elif (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                  and node.value.id == "time"):
                add("time-read", node.lineno,
                    f"direct time.{node.attr} read in serve/ — latency numbers must come "
                    f"from the injected Clock")

    seen = set()
    for fn in _step_bodies(tree, rel):
        for lineno, what in _host_sync_hits(fn):
            if (lineno, what) not in seen:      # a nested step body is walked twice
                seen.add((lineno, what))
                add("host-sync-in-step", lineno, f"{what} in step code ({fn.name})")

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.startswith("torch.") and name.rsplit(".", 1)[-1] in _GLOBAL_SETTERS:
                add("torch-global-state", node.lineno,
                    f"process-global {name}() outside a designated (allowlisted) site")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if _dotted(t).startswith("torch.backends."):
                    add("torch-global-state", node.lineno,
                        f"process-global {_dotted(t)} assignment outside a designated "
                        f"(allowlisted) site")

    if rel.endswith("kernels/ops.py"):
        for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
            names = set(_names(fn))
            if not any(n.endswith("_cuda") for n in names):
                continue
            if not any(n.endswith("_plain") or n == fn.name for n in names):
                add("kernel-plain-pair", fn.lineno,
                    f"{fn.name} launches a kernel but names no plain version — the kernel "
                    f"is unreachable on the CPU parity path")
    return findings


def lint_paths(roots=("src/repro_torch",), base: Optional[Path] = None) -> List[Finding]:
    """Lint every ``*.py`` under the given roots (repo-relative unless
    absolute). Findings are sorted by location."""
    base = Path(base) if base is not None else Path.cwd()
    findings: List[Finding] = []
    for root in roots:
        rootp = Path(root)
        if not rootp.is_absolute():
            rootp = base / rootp
        files = [rootp] if rootp.is_file() else sorted(rootp.rglob("*.py"))
        for f in files:
            try:
                rel = f.relative_to(base).as_posix()
            except ValueError:
                rel = f.as_posix()
            findings.extend(lint_source(f.read_text(), rel))
    findings.sort(key=lambda f: f.where)
    return findings


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    findings = lint_paths(args or ["src/repro_torch"])
    print(format_findings(findings))
    bad = gating(findings)
    if bad:
        print(f"\n{len(bad)} unallowlisted finding(s)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
