"""The program's spans in a traced slice: where the card's time and its idle
time go inside ``repro_torch``'s engine and MoE layer.

    python3 -m servebench.spans --workload <cell> --seed <n> --seconds <s>

runs one ``--trace 1`` run of the cell as ``servebench/run.py`` does, keeps
the slice's profile, and prints as its last line one JSON object: the run's
``result`` line, then ``spans`` (:func:`metrics` and the checks of
:func:`coverage`), ``idle`` (idle time by innermost span, most first) and the
slice's median engine step (``slice_step_ms_p50``) and decode part
(``slice_decode_ms_p50``), which time the traced slice itself.

The reading (:func:`read`) works on the profile's events:

* device operations are every event on the card that is no user annotation
  (a ``record_function`` range's copy on the device timeline);
* each operation goes to the program spans (``repro_torch.<name>``,
  ``repro_torch/trace.py``) open around the host operator that launched it:
  the profiler's launch correlation names that operator, and the spans of
  its thread open when it began are its ``cpu_parent`` chain's; an operation
  is counted in every span of that chain;
* each idle gap on the card is split over the innermost span, program or
  harness (``servebench.<name>``), open on the host during each part of it,
  in proportion to time (``harness`` outside every span).

``servebench/devtrace.py``'s summary, which the per-layer metrics of
``BENCHMARK.json`` read, does not hand its readers the events: these numbers
are printed here, beside the run's own line.
"""
from __future__ import annotations

import bisect
import re
import sys

import numpy as np

from servebench import devtrace, flops

PROGRAM = "repro_torch."
#: a decode step's spans and its admission's
FORWARD = "engine.decode.forward"
ENQUEUE = ("engine.decode.prepare", FORWARD)
ADMIT, CHUNK = "engine.admit", "engine.admit.chunk"
ROUTING = ("moe.route", "moe.dispatch", "moe.combine")


def _short(name: str) -> str:
    """A span's name without its prefix: ``engine.decode``, ``step.admit``."""
    return name[len(PROGRAM):] if name.startswith(PROGRAM) else name[len(devtrace.SPAN):]


def _is_span(name: str) -> bool:
    return name.startswith((PROGRAM, devtrace.SPAN)) and name != devtrace.SLICE


def _kernel_of(name: str):
    """The port's kernel a device operation belongs to, matched by name as
    ``devtrace.Slice.summary`` matches it, else None."""
    for k in devtrace.KERNELS:
        if re.search(rf"(?<![A-Za-z0-9_]){k}_(kernel|merge)\b", name):
            return k
    return None


def _segments(spans: list, t0: int, t1: int) -> list:
    """[t0, t1] cut where a span opens or closes: (start, end, names of the
    spans open, outermost first). Spans of one thread nest or follow one
    another."""
    out, stack, at = [], [], t0

    def cut(upto: int) -> None:
        nonlocal at
        upto = min(max(upto, t0), t1)
        if upto > at:
            out.append((at, upto, tuple(n for _, n in stack)))
            at = upto

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            cut(stack[-1][0])
            stack.pop()
        cut(a)
        stack.append((b, name))
    while stack:
        cut(stack[-1][0])
        stack.pop()
    cut(t1)
    return out


def split_idle(gaps: list, segments: list) -> tuple:
    """Each gap's parts by the segment they fall in: idle (pieces, seconds,
    longest) by innermost span (``harness`` outside every span), and idle
    seconds under each span, at any depth."""
    idle: dict = {}
    under: dict = {}
    j = 0
    for a, b in gaps:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, names = segments[k]
            d = (min(b, s1) - max(a, s0)) / 1e9
            if d > 0:
                inner = _short(names[-1]) if names else "harness"
                n, s, longest = idle.get(inner, (0, 0.0, 0.0))
                idle[inner] = (n + 1, s + d, max(longest, d))
                for name in names:
                    under[_short(name)] = under.get(_short(name), 0.0) + d
            k += 1
    return idle, under


def read(events) -> dict:
    """The program's view of a profiled slice. ``events`` are the profile's
    own records (``profile.profiler.kineto_results.events()``), which carry
    each device operation's launch correlation on every torch this runs on.
    Returns ``host`` (span -> its durations, s), ``device`` (span ->
    operations launched under it and their seconds), ``kernels`` (span -> the
    port's kernels under it, as ``devtrace.KERNELS`` names them -> count,
    s), ``idle`` (innermost span -> pieces, s, longest), ``idle_under`` (span
    -> idle s under it), and the slice's ``window_s``, ``busy_s`` and
    ``idle_s``."""
    from torch.autograd import DeviceType
    sl = [e for e in events if e.name() == devtrace.SLICE]
    if not sl:
        raise RuntimeError("the profile holds no slice range")
    t0, t1, thread = sl[0].start_ns(), sl[0].end_ns(), sl[0].start_thread_id()
    dev, spans, host, launched_at = [], [], {}, {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
            continue
        if e.start_thread_id() != thread:
            continue
        if e.linked_correlation_id() == 0:       # an operator or a range, not a runtime call
            launched_at[e.correlation_id()] = e.start_ns()
        if _is_span(e.name()):
            spans.append((e.start_ns(), e.end_ns(), e.name()))
            if e.name().startswith(PROGRAM):
                host.setdefault(_short(e.name()), []).append((e.end_ns() - e.start_ns()) / 1e9)
    segments = _segments(spans, t0, t1)
    starts = [a for a, _, _ in segments]
    device: dict = {}
    kernels: dict = {}
    for e in dev:
        # the spans open around the operator that launched it
        at = launched_at.get(e.linked_correlation_id())
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        names = segments[i][2] if i >= 0 and at < segments[i][1] else ()
        s = (e.end_ns() - e.start_ns()) / 1e9
        kernel = _kernel_of(e.name())
        for name in names:
            if not name.startswith(PROGRAM):
                continue
            name = _short(name)
            n, t = device.get(name, (0, 0.0))
            device[name] = (n + 1, t + s)
            if kernel is not None:
                per = kernels.setdefault(name, {})
                n, t = per.get(kernel, (0, 0.0))
                per[kernel] = (n + 1, t + s)
    busy, gaps = devtrace._union_and_gaps([(e.start_ns(), e.end_ns(), e.name()) for e in dev],
                                          t0, t1)
    idle, under = split_idle(gaps, segments)
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
            "idle_s": sum(b - a for a, b in gaps) / 1e9, "host": host, "device": device,
            "kernels": kernels, "idle": idle, "idle_under": under}


# ----------------------------------------------------------------- metrics
def _ms_per(seconds: float, count: int):
    return seconds / count * 1e3 if count else None


def metrics(view: dict, ctx) -> dict:
    """The program-span numbers of a slice (None where the slice has no such
    span, as a program without spans has none): ``ctx`` is the run's
    ``harness.Context`` (its configuration, peaks and the slice's work)."""
    host, device, under = view["host"], view["device"], view["idle_under"]
    decodes, steps = len(host.get(FORWARD, ())), len(host.get(ADMIT, ()))
    out = {
        "decode_enqueue_ms_p50":
            float(np.median(host[FORWARD])) * 1e3 if decodes else None,
        "decode_launches_per_step":
            device.get(FORWARD, (0, 0.0))[0] / decodes if decodes else None,
        "idle_ms_per_step.enqueue": _ms_per(sum(under.get(n, 0.0) for n in ENQUEUE), decodes),
        "idle_ms_per_step.admit": _ms_per(under.get(ADMIT, 0.0), steps),
        "moe_routing_ms_per_step.spans":
            _ms_per(sum(device[n][1] for n in ROUTING if n in device), steps)
            if any(n in device for n in ROUTING) else None,
    }
    for part, span, bound in (("decode", FORWARD, decode_bound_s),
                              ("prefill", CHUNK, prefill_bound_s)):
        k = view["kernels"].get(span, {}).get("cascade_matmul")
        out[f"cascade_matmul_roofline.{part}"] = (
            100.0 * bound(ctx) / k[1] if k and ctx.peaks is not None else None)
    return out


def decode_bound_s(ctx) -> float:
    """The least time of the slice's decode-step FP4 launches, as
    ``metrics/cascade_matmul_roofline.py`` counts them."""
    return flops.bound_s([c for _, ctxs in ctx.slice_decodes
                          for c in flops.cascade_matmul_costs(ctx.cfg, len(ctxs), len(ctxs))],
                         ctx.peaks)


def prefill_bound_s(ctx) -> float:
    """And of its admission chunks' launches."""
    return flops.bound_s([c for _, _, n, _ in ctx.slice_chunks
                          for c in flops.cascade_matmul_costs(ctx.cfg, n, 1)], ctx.peaks)


def coverage(view: dict, ctx) -> dict:
    """How far the spans account for the slice: the share of its
    ``cascade_matmul`` device time launched under the decode's forward or an
    admission chunk, the two parts' roofline combined (both bounds over both
    times: ``cascade_matmul_roofline`` where the share is whole), and the idle
    pieces' sum beside the slice's idle time (``devtrace``'s window less its
    busy time)."""
    whole = ctx.trace["kernels"].get("cascade_matmul", (0, 0.0))[1]
    spans = sum(view["kernels"].get(n, {}).get("cascade_matmul", (0, 0.0))[1]
                for n in (FORWARD, CHUNK))
    both = (decode_bound_s(ctx) + prefill_bound_s(ctx)) if ctx.peaks is not None else None
    return {"cascade_matmul_share_in_spans": spans / whole if whole else None,
            "cascade_matmul_roofline.combined":
                100.0 * both / spans if spans and both is not None else None,
            "idle_pieces_s": sum(s for _, s, _ in view["idle"].values()),
            "idle_s": ctx.trace["window_s"] - ctx.trace["busy_s"]}


def traced_run(cell, seed: int, seconds: float, device, t_start: float, clock=None) -> tuple:
    """One ``--trace 1`` run of ``cell`` (``harness.run_cell``), keeping its
    slice's events and its metrics' context: the run, the context and
    :func:`read` of the slice."""
    from servebench import harness

    kept = {}

    class Kept(devtrace.Slice):
        def summary(self):
            kept["events"] = self._prof.profiler.kineto_results.events()
            return super().summary()

    def context(*a, **k):
        kept["ctx"] = made(*a, **k)
        return kept["ctx"]

    made, sliced = harness.context, devtrace.Slice
    harness.context, devtrace.Slice = context, Kept
    try:
        run = harness.run_cell(cell, seed, seconds, True, device, t_start, clock=clock)
    finally:
        harness.context, devtrace.Slice = made, sliced
    return run, kept["ctx"], read(kept["events"])


def report(ctx, view) -> dict:
    """The printed line's numbers after the run's own ``result``."""
    steps = [t1 - t0 for t0, t1, _, _ in ctx.slice_steps]
    parts = [part for _, _, part, _ in ctx.slice_steps if part > 0]
    return {
        "spans": dict(metrics(view, ctx), **coverage(view, ctx)),
        "idle": sorted(([k, *v] for k, v in view["idle"].items()), key=lambda x: -x[2])[:16],
        "device": view["device"], "kernels": view["kernels"],
        "slice_steps": len(steps),
        "slice_step_ms_p50": float(np.median(steps)) * 1e3 if steps else None,
        "slice_decode_ms_p50": float(np.median(parts)) * 1e3 if parts else None,
    }


def main(argv=None) -> int:
    import argparse
    import json

    from servebench import run as entry        # its checkout paths, caches and start time

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    from servebench import harness

    if not torch.cuda.is_available():
        print("servebench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    run, ctx, view = traced_run(harness.load_cell(args.workload, entry.ROOT), args.seed,
                                args.seconds, "cuda", entry.T_START)
    for line in run.log:
        print(line, file=sys.stderr)
    print(json.dumps(dict({"workload": args.workload, "seed": args.seed,
                           "device": torch.cuda.get_device_name(0), "result": run.result},
                          **report(ctx, view))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
