"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over whole
engine steps in the middle of the window, kept in memory, reduced here to
what the per-layer metrics read.

* device intervals: every operation that ran on the card (kernels, copies,
  sets), their union (busy time) and its complement inside the slice (idle
  gaps);
* device time by operation name, and the port's kernels matched by name as
  ``<kernel>_(kernel|merge)``;
* device time of the MoE routing's ATen ops (router product, softmax,
  top-k sort, the dispatch's cumsum and scatter-add, the combine's gather),
  selected as ``chip_smoke.py``'s profiler summary selects them;
* each idle gap named by the harness span the host was inside when it
  began (``servebench.<name>``; ``harness`` outside every span).
"""
from __future__ import annotations

import bisect
import contextlib
import re

import torch

#: the port's kernels, as their device names begin
KERNELS = ("cascade_matmul", "cascade_matmul_grouped", "decode_attention", "flash_attention",
           "norm", "ssd_scan", "fake_quant_fp4", "cascade_matmul_exact")
#: ATen ops of ``models/moe.py``'s route, dispatch and combine
ROUTING_OPS = {"aten::mm": "router_mm", "aten::_softmax": "softmax", "aten::sort": "topk_sort",
               "aten::cumsum": "dispatch_cumsum", "aten::index_add_": "dispatch_scatter",
               "aten::index": "combine_gather"}
SPAN = "servebench."
SLICE = SPAN + "slice"


def span(name: str, on: bool):
    """A profiler range ``servebench.<name>`` while tracing, else nothing."""
    return torch.profiler.record_function(SPAN + name) if on else contextlib.nullcontext()


def _profile(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


class Slice:
    """One profiled slice: :meth:`start` and :meth:`stop` between engine
    steps, :meth:`summary` after the window. On a CPU device (the tests)
    only the host is traced."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._prof = None
        self._range = None
        # start the profiler once on a trivial op, so the slice's own start
        # pays no first-use cost inside the window
        with _profile(self._cuda):
            torch.ones(1, device=device).add_(1)
            self._sync()

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._prof = _profile(self._cuda)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self) -> None:
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def summary(self) -> dict:
        from torch.autograd import DeviceType
        events = self._prof.events()
        t0 = t1 = None
        dev, spans = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                # a profiler range also shows on the device, spanning the
                # kernels launched inside it: it is no operation
                if not e.name.startswith(SPAN):
                    dev.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name == SLICE:
                t0, t1 = e.time_range.start, e.time_range.end
            elif e.name.startswith(SPAN):
                spans.append((e.time_range.start, e.time_range.end, e.name[len(SPAN):]))
        if t0 is None:
            raise RuntimeError("the profiler recorded no slice range")
        busy, gaps = _union_and_gaps(dev, t0, t1)
        by_name: dict = {}
        for a, b, name in dev:
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + (b - a))
        ours: dict = {}
        for name, (n, us) in by_name.items():
            for k in KERNELS:
                if re.search(rf"(?<![A-Za-z0-9_]){k}_(kernel|merge)\b", name):
                    c, t = ours.get(k, (0, 0.0))
                    ours[k] = (c + n, t + us)
        routing = {}
        for ev in self._prof.key_averages():
            key = ROUTING_OPS.get(ev.key)
            if key:
                us = getattr(ev, "device_time_total", None)
                routing[key] = (us if us is not None else ev.cuda_time_total) / 1e6
        spans.sort()
        starts = [a for a, _, _ in spans]
        idle: dict = {}
        for a, b in gaps:
            name = _host_activity(spans, starts, a)
            n, s, longest = idle.get(name, (0, 0.0, 0.0))
            idle[name] = (n + 1, s + (b - a) / 1e6, max(longest, (b - a) / 1e6))
        return {
            "window_s": (t1 - t0) / 1e6,
            "busy_s": busy / 1e6,
            "ops": {k: (n, us / 1e6) for k, (n, us) in by_name.items()},
            "kernels": {k: (n, us / 1e6) for k, (n, us) in ours.items()},
            "routing_s": routing,
            "idle": idle,
        }


def _union_and_gaps(intervals, t0: float, t1: float):
    """Length of the union of ``intervals`` clipped to [t0, t1], and the
    uncovered gaps (start, end) inside it."""
    busy, gaps, at = 0.0, [], t0
    for a, b, _ in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > at:
            gaps.append((at, a))
        if b > at:
            busy += b - max(a, at)
            at = b
    if t1 > at:
        gaps.append((at, t1))
    return busy, gaps


def _host_activity(spans, starts, t: float) -> str:
    """The innermost harness span open on the host at time t: spans nest
    and follow one another, so it is the latest-starting one that still
    holds t, among the few that started last before t."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[max(0, i - 8):i]):
        if a <= t < b:
            return name
    return "harness"


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and idle time by what the host was doing, most first."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "device_ops": [[name[:120], s] for name, (_, s) in ops],
        "idle_gaps": [[f"{name} ({n} gaps, longest {longest:.6f} s)", s]
                      for name, (n, s, longest) in idle],
    }
