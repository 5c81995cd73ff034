"""The program-span reading of a traced slice (``servebench/spans.py``) on
event lists built by hand, as the card's profiler gives them, and on a
traced smoke run on the CPU."""
import dataclasses
import time
from typing import Optional

import pytest
from torch.autograd import DeviceType

from servebench import devtrace, harness, spans
from servebench.tests.cells import TickClock, smoke_cell

H100 = harness.flops.PEAKS["NVIDIA H100 80GB HBM3"]
CASCADE = "void (anonymous namespace)::cascade_matmul_kernel<__nv_bfloat16>(...)"


@dataclasses.dataclass(eq=False)
class Rec:
    """A profiler record as ``kineto_results.events()`` gives it (times in
    ns), the fields the span reading calls."""
    name_: str
    start: int
    end: int
    device: DeviceType = DeviceType.CPU
    corr: int = 0
    linked: int = 0
    annotation: bool = False
    thread: int = 1

    def name(self): return self.name_
    def device_type(self): return self.device
    def start_ns(self): return self.start
    def end_ns(self): return self.end
    def correlation_id(self): return self.corr
    def linked_correlation_id(self): return self.linked
    def is_user_annotation(self): return self.annotation
    def start_thread_id(self): return self.thread


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Ev:
    """The fields of a ``FunctionEvent`` ``devtrace.Slice.summary`` reads
    (times in us)."""
    name: str
    time_range: Range
    device_type: DeviceType


class Profile:
    """What ``devtrace.Slice.summary`` reads of a finished profile."""

    def __init__(self, records, averages=()):
        self._events = [Ev(r.name(), Range(r.start / 1e3, r.end / 1e3), r.device)
                        for r in records]
        self._averages = list(averages)

    def events(self):
        return self._events

    def key_averages(self):
        return self._averages


@dataclasses.dataclass
class Avg:
    key: str
    device_time_total: float


class Timeline:
    """Host ranges and device operations of a synthetic slice, in us."""

    def __init__(self):
        self.events = []

    def host(self, name, a, b, thread=1):
        e = Rec(name, a * 1000, b * 1000, corr=len(self.events) + 1, thread=thread)
        self.events.append(e)
        return e

    def device(self, name, a, b, launcher=None, annotation=False):
        e = Rec(name, a * 1000, b * 1000, DeviceType.CUDA, corr=10_000 + len(self.events),
                linked=launcher.corr if launcher else 0, annotation=annotation)
        self.events.append(e)
        return e


def _slice(program: bool = True) -> Timeline:
    """Two engine steps in a 100 us slice: a decode (its forward runs one
    routed layer) and an admission chunk, the harness's spans around them;
    the device busy over [9, 20] and [46, 50]. ``program``: with the
    program's spans (without, the parent commit's profile: the same device
    operations, launched from the harness's spans)."""
    t = Timeline()
    P, S = spans.PROGRAM, devtrace.SPAN
    t.host(devtrace.SLICE, 0, 100)
    t.host(S + "step", 0, 31)
    inner = t.host(S + "step.decode", 4, 30)
    if program:
        t.host(P + "engine.admit", 0, 4)
        t.host(P + "engine.decode", 4, 30)
        t.host(P + "engine.decode.prepare", 4, 6)
        inner = t.host(P + "engine.decode.forward", 6, 18)
        t.host(P + "moe.route", 8, 10)
        t.host(P + "engine.decode.sync", 18, 25)
        t.host(P + "engine.decode.commit", 25, 30)
    mm = t.host("aten::mm", 8, 9)
    t.device("void at::native::mm_kernel(...)", 9, 12, mm)
    # a kernel launched through ctypes, inside no operator: the range
    # around it launched it
    t.device(CASCADE, 12, 20, inner)
    t.device(S + "step.decode", 9, 20, annotation=True)
    t.host(S + "submit", 32, 35)
    t.host(S + "step", 36, 80)
    if program:
        t.host(P + "engine.admit", 36, 75)
        t.host(P + "engine.admit.chunk", 37, 45)
        t.host(P + "engine.admit.pick", 45, 52)
        t.host(P + "engine.admit.write", 52, 55)
    t.host(S + "step.admit", 36, 75)
    # launched inside the chunk, run while the host picks: charged to the chunk
    t.device(CASCADE, 46, 50, t.host("aten::copy_", 44, 45))
    # another thread's operator at the same time: no span of the slice's
    t.device("void at::native::fill_kernel(...)", 50, 50, t.host("aten::fill_", 40, 41, thread=2))
    # a user range's copy on the device (the training backward's): no operation
    t.device("ops.plain_gradient", 60, 99, annotation=True)
    return t


def test_idle_time_is_split_over_the_spans_open_during_it():
    view = spans.read(_slice().events)
    assert view["window_s"] == pytest.approx(100e-6)
    assert view["busy_s"] == pytest.approx(15e-6)
    assert view["idle_s"] == pytest.approx(85e-6)
    idle = {k: v[1] * 1e6 for k, v in view["idle"].items()}
    # the gap [20, 46] crosses sync, commit, the step's end, submit and
    # admission; [0, 9] and [50, 100] the steps' other parts
    want = {"engine.admit": 4, "engine.decode.prepare": 2, "engine.decode.forward": 2,
            "moe.route": 1, "engine.decode.sync": 5, "engine.decode.commit": 5, "step": 1 + 5,
            "harness": 1 + 1 + 20, "submit": 3, "step.admit": 1 + 20,
            "engine.admit.chunk": 8, "engine.admit.pick": 1 + 2, "engine.admit.write": 3}
    assert idle == pytest.approx(want)
    assert sum(idle.values()) == pytest.approx(85)
    assert view["idle"]["engine.admit.pick"][0] == 2      # one piece in each gap
    under = {k: v * 1e6 for k, v in view["idle_under"].items()}
    assert under["engine.admit"] == pytest.approx(4 + 1 + 8 + 3 + 3 + 20)
    assert under["engine.decode"] == pytest.approx(2 + 2 + 1 + 5 + 5)
    assert under["engine.decode.forward"] == pytest.approx(3)


def test_each_operation_goes_to_the_spans_around_its_launcher():
    view = spans.read(_slice().events)
    us = {k: (n, s * 1e6) for k, (n, s) in view["device"].items()}
    assert us["moe.route"] == (1, pytest.approx(3))
    assert us["engine.decode.forward"] == (2, pytest.approx(11))
    assert us["engine.decode"] == (2, pytest.approx(11))
    # run while the host sat in the pick, launched by the chunk
    assert us["engine.admit.chunk"] == (1, pytest.approx(4))
    assert "engine.admit.pick" not in us
    assert view["kernels"]["engine.decode.forward"] == {"cascade_matmul": (1, pytest.approx(8e-6))}
    assert view["kernels"]["engine.admit.chunk"] == {"cascade_matmul": (1, pytest.approx(4e-6))}
    assert view["host"]["engine.decode.forward"] == [pytest.approx(12e-6)]
    assert len(view["host"]["engine.admit"]) == 2


def test_annotations_are_no_device_operations():
    t = _slice()
    base = spans.read(t.events)
    t.device(spans.PROGRAM + "engine.decode", 9, 99, annotation=True)
    again = spans.read(t.events)
    assert again["busy_s"] == base["busy_s"] and again["idle"] == base["idle"]
    assert again["device"] == base["device"]


def _context(summary: dict, cell: str = "codeqwen-decode-c128") -> harness.Context:
    cfg = harness.ref_config(harness.load_cell(cell).config)
    decodes = [(0.0, tuple(range(300, 428)))]
    chunks = [(0.0, 0, 400, 512)]
    win = harness.Window(t_open=0.0, t_end=1.0, requests=[], due=[],
                         steps=[(0.0, 0.05, 0.04, 0), (0.05, 0.1, 0.0, 1)], lateness=[],
                         counters=((0, 0), (0, 0)), slice_steps=(0, 2), slice_chunks=(0, 1),
                         slice_decodes=(0, 1))
    return harness.Context(cfg=cfg, window=win, chunks=chunks, decodes=decodes,
                           slice_steps=win.steps, slice_chunks=chunks, slice_decodes=decodes,
                           trace=summary, peaks=H100)


def _summary(records) -> dict:
    sl = devtrace.Slice.__new__(devtrace.Slice)
    sl._prof = Profile(records, [Avg("aten::mm", 3.0), Avg("aten::sort", 2.0)])
    return sl.summary()


@pytest.mark.parametrize("cell", ["codeqwen-decode-c128", "olmoe-decode-c128"])
def test_the_accepted_readers_read_alike_with_and_without_program_spans(cell):
    """The program's spans are host ranges: the summary the per-layer
    metrics read, and each of the cell's readers, come out the same."""
    with_spans, without = _summary(_slice().events), _summary(_slice(program=False).events)
    assert with_spans == without
    for m in harness.load_cell(cell).per_layer:
        read = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read
        assert read(_context(with_spans, cell)) == read(_context(without, cell)), m["name"]


def test_the_span_metrics_of_a_slice():
    t = _slice()
    view, ctx = spans.read(t.events), _context(_summary(t.events))
    got = spans.metrics(view, ctx)
    assert got["decode_enqueue_ms_p50"] == pytest.approx(0.012)
    assert got["decode_launches_per_step"] == 2
    assert got["idle_ms_per_step.enqueue"] == pytest.approx(0.005)
    assert got["idle_ms_per_step.admit"] == pytest.approx(0.039 / 2)
    assert got["moe_routing_ms_per_step.spans"] == pytest.approx(0.003 / 2)
    dec, pre = spans.decode_bound_s(ctx), spans.prefill_bound_s(ctx)
    assert got["cascade_matmul_roofline.decode"] == pytest.approx(100 * dec / 8e-6)
    assert got["cascade_matmul_roofline.prefill"] == pytest.approx(100 * pre / 4e-6)
    cov = spans.coverage(view, ctx)
    assert cov["cascade_matmul_share_in_spans"] == pytest.approx(1.0)
    assert cov["idle_pieces_s"] == pytest.approx(cov["idle_s"] + 39e-6)   # devtrace counts the annotation
    # both parts combine back to the whole kernel's roofline
    whole = harness.load_module(harness.HERE / "metrics" / "cascade_matmul_roofline.py")
    assert cov["cascade_matmul_roofline.combined"] == pytest.approx(whole.read(ctx))
    # the parent's profile has no program span: nothing to read, nothing raised
    bare = spans.metrics(spans.read(_slice(program=False).events), ctx)
    assert all(v is None for v in bare.values()), bare


def test_a_traced_smoke_run_is_covered_by_its_spans():
    run, ctx, view = spans.traced_run(smoke_cell("codeqwen-decode-c128"), 2**31 + 7, 2.0, "cpu",
                                      time.monotonic(), clock=TickClock())
    assert run.result["correct"]
    host = view["host"]
    # one admission span an engine step, one forward a decode, one chunk
    # span a recorded chunk
    assert len(host["engine.admit"]) == len(ctx.slice_steps) > 0
    assert len(host["engine.decode.forward"]) == len(ctx.slice_decodes) > 0
    assert len(host["engine.admit.chunk"]) == len(ctx.slice_chunks) > 0
    # no device on the CPU: the whole slice is idle, split without loss
    assert view["busy_s"] == 0 and view["idle_s"] == pytest.approx(ctx.trace["window_s"])
    assert sum(s for _, s, _ in view["idle"].values()) == pytest.approx(view["idle_s"], rel=1e-9)
    assert spans.report(ctx, view)["slice_steps"] == len(ctx.slice_steps)
