"""Rebuild guard: serving the same trace again builds and plans nothing new.

The reference counts each jitted closure's compiles over a trace (a
retrace is a silent multi-second stall). The port compiles nothing per
shape, but it builds each CUDA kernel library at first use
(``kernels/build.py``) and memoizes launch plans and libraries with
``functools.lru_cache`` in ``kernels/*.py``. After a warm-up trace, a
second run of the same trace must:

* start no ``nvcc`` and load no library (``build.COUNTS``);
* add no entry to any ``lru_cache``d function of the kernel modules (a
  plan keyed by a value that drifts per step, a cache that grows without
  bound).

On the CPU route no kernel is built or launched: the guard verified
nothing, and says so with an info finding, as the reference does where its
cache-size API is missing.
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import build


def kernel_modules() -> list:
    import repro_torch.kernels as pkg
    return [importlib.import_module(f"{pkg.__name__}.{m.name}")
            for m in pkgutil.iter_modules(pkg.__path__)]


def cache_sizes(modules: Optional[Iterable] = None) -> Dict[str, int]:
    """Entries in every ``lru_cache``d function defined in the modules."""
    out = {}
    for mod in (kernel_modules() if modules is None else modules):
        for name, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "cache_info") \
                    and getattr(fn, "__module__", None) == mod.__name__:
                out[f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"] = fn.cache_info().currsize
    return out


def snapshot(modules: Optional[Iterable] = None) -> dict:
    return {"caches": cache_sizes(modules), **build.COUNTS}


def compare(before: dict, after: dict) -> List[Finding]:
    """Error findings for every build, load or cache entry added between
    two snapshots."""
    findings = []
    for what in ("compiles", "loads"):
        if after[what] > before[what]:
            findings.append(Finding(
                "retrace", f"build.{what}",
                f"{after[what] - before[what]} kernel librar(y/ies) "
                f"{'built' if what == 'compiles' else 'loaded'} again on the second run of "
                f"the trace — each is a stall of seconds in the middle of serving"))
    for name, n in after["caches"].items():
        if n > before["caches"].get(name, 0):
            findings.append(Finding(
                "retrace", name,
                f"{n - before['caches'].get(name, 0)} new entr(y/ies) on the second run of "
                f"the same trace ({n} in all) — a plan keyed by a value that drifts per step"))
    return findings


def retrace_findings(trace: Callable[[], object], kernel_route: bool,
                     modules: Optional[Iterable] = None) -> List[Finding]:
    """Run ``trace()`` twice (a warm-up, then the check) and compare what
    the second run built and memoized. ``kernel_route``: the trace runs the
    CUDA kernels; without it, an info finding records that nothing was
    verified."""
    trace()
    before = snapshot(modules)
    trace()
    findings = compare(before, snapshot(modules))
    if not kernel_route:
        findings.append(Finding(
            "retrace", "build",
            "the plain route builds and launches no kernel — the rebuild guard verified "
            "nothing for the kernels", level="info"))
    return findings
