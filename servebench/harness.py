"""One run of a benchmark cell: set-up, the measured window, the metrics
and the check that decides ``correct``.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``servebench/configs/<config>.json``: the model's sizes, the
port's registry entry it runs as, the engine settings every cell of it
shares) and a traffic mix (``servebench/traffic/<traffic>.json``: the
generator's parameters and the engine settings of that mix); its
correctness limit is ``servebench/limits/<cell>.json``, its reference
``servebench/reference/<family>.py``, its family's rules (kernels, weight
leaves, work) ``servebench/families/<family>.py`` and each per-layer metric
``servebench/metrics/<metric>.py``. Nothing here names a cell, a model, a
family or a metric.

The run drives one ``repro_torch.serve.engine.ServeEngine`` (one replica,
greedy, on its own ``MonotonicClock``) through ``submit()`` and ``step()``.
The loop here owns the timing: before each step it submits every request
that is due (open loop: stamped with its due time; closed loop: a client's
next request as soon as its last one retired), and it sleeps only when the
engine is idle.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from servebench import devtrace, families, flops
from servebench import traffic as tr
from servebench import weights as W

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the numbers ``check`` reads that a cell's limits file may hold a limit for
CHECKED = ("max_logit_gap", "mean_logit_gap")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json's end-to-end entries this cell reports
    per_layer: list       # and its per-layer entries


def reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    (w,) = [w for w in bench["workloads"] if w["name"] == name]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    said = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if reports(m, name) and m["moves"] in said]
    return Cell(name=name, config=load_json(root / c["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"servebench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------------ set-up
def ref_config(config: dict) -> dict:
    """The sizes the reference and the work counts read."""
    return dict(config["model"], family=config["family"])


def build(config: dict, traffic: dict, seed: int, device: torch.device, clock=None):
    """The port's model, the benchmark's weights for it and the engine (on
    ``clock``, by default the engine's own ``MonotonicClock``)."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    base = registry.get_config(config["registry"])
    fields = {f.name for f in dataclasses.fields(base)}
    arch = dataclasses.replace(base, **{k: v for k, v in config["model"].items() if k in fields})
    model = registry.build_model(arch)
    eng = config["engine"]
    ccfg = CascadeConfig(mode="serve_fp4", compute_dtype=getattr(torch, eng["compute_dtype"]))
    params = W.draw(model.init_params(0, ccfg, device="meta"), seed, device, config["family"])
    scfg = ServeConfig(prefill_chunk=eng["prefill_chunk"], token_budget=eng["token_budget"],
                       fused=eng["fused"], **traffic["engine"])
    engine = ServeEngine(model, params, ccfg, scfg, device=device, clock=clock)
    if engine.downgrades:
        raise RuntimeError(f"the engine downgraded: {engine.downgrades}")
    return params, engine


class Recorder:
    """Spans and counts from the harness's side of the engine's calls: each
    admission chunk (its time, first row, valid rows, live keys) and each
    decode step (its time, each live slot's context), and, while tracing,
    profiler ranges around admission and decode. The calls it wraps are the
    engine's own attributes: :meth:`verify` holds what it recorded against
    the engine's public counts, so a change of the engine that takes work
    past them stops the run instead of leaving it out of the work counts."""

    def __init__(self, eng, trace: bool):
        self.chunks: list = []
        self.decodes: list = []
        self._since = (len(eng.step_times), eng.metrics()["decode_tokens"])
        clock = eng.clock
        extend, decode = eng._extend_fn, eng._decode_fn

        def ext(params, toks, cache, bt, n_valid, kv_len):
            self.chunks.append((clock.now(), eng._staging.consumed, int(n_valid), int(kv_len)))
            return extend(params, toks, cache, bt, n_valid, kv_len)

        def dec(params, toks, cache, bt=None):
            ctx = tuple(eng._used(r) for r in eng.slots if r is not None)
            self.decodes.append((clock.now(), ctx))
            return decode(params, toks, cache, bt)

        eng._extend_fn, eng._decode_fn = ext, dec
        if trace:
            admit, batched = eng._admit, eng._decode_batched

            def traced_admit():
                with devtrace.span("step.admit", True):
                    return admit()

            def traced_decode(active):
                with devtrace.span("step.decode", True):
                    return batched(active)

            eng._admit, eng._decode_batched = traced_admit, traced_decode

    def verify(self, eng, requests: list) -> None:
        """Raise where the engine decoded or admitted past the wrapped calls:
        one decode record a step that decoded (``step_times``), one live
        context a decode token (``metrics()["decode_tokens"]``), and chunks
        wherever a request (of ``requests``) got its first token."""
        steps = len(eng.step_times) - self._since[0]
        tokens = eng.metrics()["decode_tokens"] - self._since[1]
        seen = sum(len(c) for _, c in self.decodes)
        admitted = sum(1 for r in requests if r.first_token_at > 0)
        if steps != len(self.decodes) or tokens != seen or (admitted and not self.chunks):
            raise RuntimeError(
                f"the engine's work bypassed the recorded calls: {steps} decode steps and "
                f"{tokens} decode tokens against {len(self.decodes)} and {seen} recorded; "
                f"{admitted} requests admitted, {len(self.chunks)} chunks recorded")


def new_request(uid: int, spec: tr.Spec, created_at: float = 0.0):
    from repro_torch.serve.engine import Request
    return Request(uid=uid, prompt=spec.prompt, max_new_tokens=spec.max_new,
                   created_at=created_at, prefix_id=spec.prefix_id)


def drain(eng) -> None:
    while eng.busy():
        eng.step()


def fill_grid(eng, stream, clients: int, seed: int) -> list:
    """Set-up of a closed loop that opens on a full grid, as in steady
    state: ``clients`` requests admitted, then each one's output budget set
    to what it has already emitted plus a share of its drawn length (the
    shares evenly spaced over (0, 1], in the seed's order, within the
    cache), so retirements spread out from the window's first step."""
    max_len = eng.scfg.max_len
    specs = [next(stream) for _ in range(clients)]
    reqs = [new_request(i, dataclasses.replace(s, max_new=max_len)) for i, s in enumerate(specs)]
    for r in reqs:
        eng.submit(r)
    while any(r.first_token_at <= 0 for r in reqs):
        eng.step()
    share = (np.random.default_rng([seed, 4]).permutation(clients) + 1) / clients
    for r, s, f in zip(reqs, specs, share):
        left = max(1, int(round(f * s.max_new)))
        r.max_new_tokens = min(len(r.tokens_out) + left, max_len - len(r.prompt))
    return reqs


def warm_open_loop(eng, traffic: dict, vocab: int, seed: int) -> None:
    """Set-up of an open loop: every shared prefix admitted once (a
    service's system prompts are hot), then one prompt of the mix's longest
    length, so admission has run every chunk shape the mix reaches. Each is
    served alone to its end: the grid is empty when the window opens."""
    rng = np.random.default_rng([seed, 2])
    tail = min(lo for lo, _ in traffic["prompt_lens"])
    prompts = [np.concatenate([p, rng.integers(0, vocab, tail).astype(np.int32)])
               for p in tr.shared_prefixes(traffic, vocab, seed)]
    longest = max(hi for _, hi in traffic["prompt_lens"]) + traffic.get("shared_prefix_len", 0)
    prompts.append(rng.integers(0, vocab, longest).astype(np.int32))
    for i, p in enumerate(prompts):
        eng.submit(new_request(-1 - i, tr.Spec(prompt=p, max_new=2)))
        drain(eng)


# ------------------------------------------------------------------ window
@dataclasses.dataclass
class Window:
    t_open: float
    t_end: float
    requests: list        # every request the run made (fill, then in arrival order)
    due: list             # the requests that came due inside the window
    steps: list           # (t0, t1, decode part s, chunks) of each engine step
    lateness: list        # submit time minus due time, open loop
    counters: tuple       # (prefix hits, lookups) at the opening and the close
    slice_steps: tuple    # (first, last + 1) step indices inside the traced slice
    slice_chunks: tuple   # and chunk records
    slice_decodes: tuple  # and decode records


def run_window(eng, rec: Recorder, stream, traffic: dict, seconds: float, first: list,
               trace: Optional[devtrace.Slice]) -> Window:
    clock = eng.clock
    closed = traffic["loop"] == "closed"
    on = trace is not None
    reqs, due, steps, late = list(first), [], [], []
    clients = list(first) if closed else []
    uid = len(reqs)
    nxt = None if closed else next(stream)
    hits0 = prefix_counters(eng)
    t_open = clock.now()
    t_close = t_open + seconds
    s_from = t_open + seconds / 2 - float(traffic["trace_slice_s"]) / 2
    s_open = s_shut = None
    while True:
        now = clock.now()
        if now >= t_close:
            break
        if on and s_open is None and now >= s_from:
            s_open = (len(steps), len(rec.chunks), len(rec.decodes), now)
            trace.start()
        elif (s_open is not None and s_shut is None and now >= s_open[3] + traffic["trace_slice_s"]
              and len(rec.chunks) > s_open[1] and len(rec.decodes) > s_open[2]):
            trace.stop()
            s_shut = (len(steps), len(rec.chunks), len(rec.decodes))
        with devtrace.span("submit", on):
            if closed:
                for c, r in enumerate(clients):
                    if r.done:
                        clients[c] = new_request(uid, next(stream), created_at=now)
                        uid += 1
                        eng.submit(clients[c])
                        reqs.append(clients[c])
                        due.append(clients[c])
            else:
                while t_open + nxt.at_s <= now:
                    r = new_request(uid, nxt, created_at=t_open + nxt.at_s)
                    uid += 1
                    eng.submit(r)
                    late.append(now - r.created_at)
                    reqs.append(r)
                    due.append(r)
                    nxt = next(stream)
        if eng.busy():
            n_times, n_chunks = len(eng.step_times), len(rec.chunks)
            t0 = clock.now()
            with devtrace.span("step", on):
                eng.step()
            t1 = clock.now()
            part = eng.step_times[-1] if len(eng.step_times) > n_times else 0.0
            steps.append((t0, t1, part, len(rec.chunks) - n_chunks))
            continue
        # idle: only an open loop waits, for its next arrival; a closed
        # loop's clients each hold a request in the engine
        assert not closed, "a closed loop's engine went idle"
        with devtrace.span("sleep", on):
            clock.sleep_until(min(t_open + nxt.at_s, t_close))
    t_end = clock.now()
    if s_open is not None and s_shut is None:
        trace.stop()
        s_shut = (len(steps), len(rec.chunks), len(rec.decodes))
    if s_open is None:
        s_open = s_shut = (0, 0, 0)
    return Window(t_open=t_open, t_end=t_end, requests=reqs, due=due, steps=steps,
                  lateness=late, counters=(hits0, prefix_counters(eng)),
                  slice_steps=(s_open[0], s_shut[0]), slice_chunks=(s_open[1], s_shut[1]),
                  slice_decodes=(s_open[2], s_shut[2]))


def prefix_counters(eng) -> tuple:
    m = eng.metrics()
    return m["prefix_hits"], m["prefix_lookups"]


# ----------------------------------------------------------------- metrics
def pct(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


def in_window_gaps(win: Window) -> list:
    """Every gap between consecutive tokens of a stream, both committed
    inside the window."""
    return [b - a for r in win.requests for a, b in zip(r.token_times, r.token_times[1:])
            if a >= win.t_open and b <= win.t_end]


def end_to_end(win: Window, setup_s: float, peak_bytes: int) -> dict:
    """Every end-to-end metric the harness knows, over the whole window."""
    w = win.t_end - win.t_open
    tokens = sum(1 for r in win.requests for t in r.token_times if win.t_open <= t <= win.t_end)
    ttft = [(r.first_token_at if 0 < r.first_token_at <= win.t_end else win.t_end) - r.created_at
            for r in win.due]
    gaps = in_window_gaps(win)
    return {
        "output_tokens_per_s": tokens / w,
        "itl_p95_ms": None if not gaps else pct(gaps, 95) * 1e3,
        "ttft_p90_s": pct(ttft, 90),
        "peak_mem_gb": peak_bytes / 1e9,
        "setup_s": setup_s,
    }


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads (``servebench/metrics``)."""
    cfg: dict             # ref_config of the cell's configuration
    window: Window
    chunks: list          # admission chunks of the window (t, p0, n, kv_len)
    decodes: list         # decode steps of the window (t, contexts)
    slice_steps: list     # the traced slice's engine steps, chunks and decodes
    slice_chunks: list
    slice_decodes: list
    trace: dict           # devtrace.Slice.summary()
    peaks: Optional[dict]  # flops.PEAKS of the card, None if it has none


def context(cfg: dict, win: Window, rec: Recorder, summary: dict, kind: str) -> Context:
    inside = lambda recs: [x for x in recs if x[0] >= win.t_open]
    cut = lambda recs, ab: recs[ab[0]:ab[1]]
    return Context(cfg=cfg, window=win, chunks=inside(rec.chunks), decodes=inside(rec.decodes),
                   slice_steps=cut(win.steps, win.slice_steps),
                   slice_chunks=cut(rec.chunks, win.slice_chunks),
                   slice_decodes=cut(rec.decodes, win.slice_decodes),
                   trace=summary, peaks=flops.PEAKS.get(kind))


# ------------------------------------------------------------- correctness
def sample(win: Window, seed: int, tokens: int) -> list:
    """Requests finished inside the window, drawn from the seed: the longest
    (prompt and output), then others in a seeded order until the served
    tokens reach ``tokens``."""
    done = [r for r in win.requests
            if r.done and r.tokens_out and win.t_open <= r.finished_at <= win.t_end]
    if not done:
        return []
    done.sort(key=lambda r: r.uid)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens_out), -r.uid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    out, n = [longest], len(longest.tokens_out)
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens_out)
    return out


def logit_gaps(logits: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """How far each picked token's logit lies below the row's best."""
    return logits.max(dim=-1).values - logits.gather(1, picked[:, None].long())[:, 0]


def reference_rows(reqs: list, device) -> tuple:
    """Each request's prompt and served tokens (the last one needs no
    continuation), the rows whose logits predict the served tokens, and
    those tokens."""
    seqs, rows, served = [], [], []
    for r in reqs:
        p = np.asarray(r.prompt, np.int64)
        out = np.asarray(r.tokens_out, np.int64)
        seqs.append(torch.from_numpy(np.concatenate([p, out[:-1]])).to(device))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(out), device=device))
        served.append(torch.from_numpy(out).to(device))
    return seqs, rows, served


def reference(family: str):
    return load_module(HERE / "reference" / f"{family}.py")


@torch.no_grad()
def check(params: dict, cfg: dict, reqs: list, device, control: bool = False) -> dict:
    """How far each served token's logit lies below the f32 reference's
    best at its row, over the sampled requests: the widest gap and the mean
    gap. With ``control``, the same two numbers of the token that the fp8
    control puts first at each of those rows, read in the f32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference(cfg["family"])
    seqs, rows, served = reference_rows(reqs, device)
    logits = ref.forward(params, cfg, seqs, rows)
    gaps = torch.cat([logit_gaps(lg, s) for lg, s in zip(logits, served)])
    out = {"max_logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean()),
           "tokens": int(gaps.numel()), "requests": len(reqs)}
    if control:
        low = ref.forward(params, cfg, seqs, rows, precision="fp8")
        cg = torch.cat([logit_gaps(lg, l8.argmax(dim=-1)) for lg, l8 in zip(logits, low)])
        out.update(control_max_logit_gap=float(cg.max()), control_mean_logit_gap=float(cg.mean()))
    return out


# --------------------------------------------------------------------- run
@dataclasses.dataclass
class Run:
    result: dict          # the result line, but its device block
    window: Window
    peak_bytes: int       # the card's peak allocation over set-up and window
    check: dict           # what ``check`` read (with ``control``, the control too)
    log: list             # lines for standard error, before the comparisons


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, hook: Optional[Callable] = None, control: bool = False,
             clock=None) -> Run:
    """One run: set-up from ``t_start`` (the process's start), the window,
    the metrics, then the check. ``hook(engine)`` may wrap the engine
    before set-up (the tests plant faults through it); ``clock`` replaces
    the engine's wall clock (the tests' clock ticks at each reading, so a
    window holds the same work on any host)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = ref_config(cell.config)
    marks = [("start", t_start), ("imports", time.monotonic())]
    if cuda:
        from repro_torch.kernels import build as kbuild
        kbuild.build(families.load(cfg["family"]).KERNELS)
        marks.append(("kernels built", time.monotonic()))
    params, eng = build(cell.config, cell.traffic, seed, device, clock)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights and engine", time.monotonic()))
    if hook is not None:
        hook(eng)
    rec = Recorder(eng, trace)
    stream = tr.request_stream(cell.traffic, cfg["vocab"], seed)
    if cell.traffic["loop"] == "closed":
        first = fill_grid(eng, stream, int(cell.traffic["clients"]), seed)
    else:
        first = []
        warm_open_loop(eng, cell.traffic, cfg["vocab"], seed)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("grid filled" if first else "warmed up", time.monotonic()))
    sl = devtrace.Slice(device) if trace else None
    gc.collect()
    gc.freeze()         # set-up's objects leave the collector's young generations
    setup_s = time.monotonic() - t_start
    win = run_window(eng, rec, stream, cell.traffic, seconds, first, sl)
    rec.verify(eng, win.requests)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = end_to_end(win, setup_s, peak)
    metrics, breakdown, dev = {}, None, {}
    if trace:
        summary = sl.summary()
        kind = torch.cuda.get_device_name(device) if cuda else "cpu"
        ctx = context(cfg, win, rec, summary, kind)
        for m in cell.per_layer:
            v = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = devtrace.breakdown(summary)
        dev = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
    else:
        for m in cell.end_to_end:
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    attempted = len(win.due)
    failed = sum(1 for r in win.due if r.done and not r.tokens_out)
    log = ["set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
           f"window {win.t_end - win.t_open:.3f} s, {len(win.steps)} steps, "
           f"{len(rec.chunks)} admission chunks in the run, {attempted} requests due, "
           f"{failed} refused"]
    m = eng.metrics()
    if m["prefix_cache"]:
        log.append(f"prefix cache: {m['prefix_hits']} of {m['prefix_lookups']} prompt tokens hit, "
                   f"{m['evictions']} pages evicted")
    if m["paged"]:
        log.append(f"pages in use at the close: {m['pages_in_use']} of {m['pages_total']}")
    if win.lateness:
        log.append(f"generator lateness p50 {pct(win.lateness, 50):.6f} s, "
                   f"max {max(win.lateness):.6f} s")
    # the program's state goes before the reference runs
    del eng, rec
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = sample(win, seed, int(cell.traffic["check_tokens"]))
    limits = {k: float(v) for k, v in cell.limits.items() if k in CHECKED}
    if picked:
        got = check(params, cfg, picked, device, control)
        log.append(f"checked {got['tokens']} served tokens of {got['requests']} requests")
    else:
        got = {k: float("inf") for k in limits}
        log.append("no request finished inside the window: nothing to check")
    correct = bool(picked) and failed == 0 and all(got[k] <= v for k, v in limits.items())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    return Run(result=result, window=win, peak_bytes=peak, check=got, log=log)
