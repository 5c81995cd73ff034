"""The window's arithmetic: a rate over the whole window, tails over every
request due (an unfinished one with its wait so far), gaps only between
tokens both inside the window."""
import dataclasses

import numpy as np
import pytest

from servebench import harness


@dataclasses.dataclass
class Req:
    created_at: float
    token_times: list
    first_token_at: float = 0.0

    def __post_init__(self):
        if self.token_times:
            self.first_token_at = self.token_times[0]


def _window(reqs, due, t_open=10.0, t_end=20.0):
    return harness.Window(t_open=t_open, t_end=t_end, requests=reqs, due=due, steps=[],
                          lateness=[], counters=((0, 0), (0, 0)), slice_steps=(0, 0),
                          slice_chunks=(0, 0), slice_decodes=(0, 0))


def test_rate_counts_every_token_inside_the_window_over_its_whole_length():
    a = Req(5.0, [9.0, 10.0, 12.0, 21.0])          # 2 tokens inside [10, 20]
    b = Req(11.0, [11.5, 13.0, 14.5, 16.0, 19.9])   # 5 inside
    got = harness.end_to_end(_window([a, b], [b]), 3.0, 2 * 10**9)
    assert got["output_tokens_per_s"] == pytest.approx(7 / 10.0)
    assert got["peak_mem_gb"] == 2.0 and got["setup_s"] == 3.0


def test_gaps_only_between_tokens_both_inside():
    a = Req(5.0, [9.0, 10.0, 12.0, 21.0])
    b = Req(11.0, [11.5, 13.0, 14.5])
    gaps = harness.in_window_gaps(_window([a, b], [b]))
    assert sorted(gaps) == pytest.approx([1.5, 1.5, 2.0])
    got = harness.end_to_end(_window([a, b], [b]), 0.0, 0)
    assert got["itl_p95_ms"] == pytest.approx(np.percentile([1.5, 1.5, 2.0], 95) * 1e3)


def test_ttft_tail_counts_requests_with_no_token_yet():
    done = [Req(10.0 + i, [10.0 + i + 0.1]) for i in range(9)]     # TTFT 0.1 each
    waiting = Req(12.0, [])                                         # no token by 20: waits 8
    late = Req(19.0, [20.5])                                        # token after the close: 1
    got = harness.end_to_end(_window(done + [waiting, late], done + [waiting, late]), 0.0, 0)
    want = np.percentile([0.1] * 9 + [8.0, 1.0], 90)
    assert got["ttft_p90_s"] == pytest.approx(want)
    assert got["ttft_p90_s"] > 0.1


@pytest.mark.parametrize("name", ["codeqwen-decode-c128", "olmoe-decode-c128"])
def test_every_metric_reader_of_a_cell_reads_a_slice_on_the_card(name):
    """Each per-layer reader the cell names, on a slice as the card's
    profiler would give it (the CPU's has no device operations and no
    peaks): a number, and a share of a roofline or a peak below 100%."""
    cell = harness.load_cell(name)
    cfg = harness.ref_config(cell.config)
    contexts = tuple(range(300, 300 + 128))
    decodes = [(10.0 + 0.1 * i, contexts) for i in range(10)]
    chunks = [(10.05, 0, 400, 512)]
    win = _window([Req(9.0, [10.1, 10.2, 10.35])], [], 10.0, 11.0)
    win.steps = [(10.0 + 0.1 * i, 10.1 + 0.1 * i, 0.08, int(i == 0)) for i in range(10)]
    kernels = {k: (100, 0.5) for k in ("cascade_matmul", "cascade_matmul_grouped",
                                       "decode_attention")}
    trace = {"window_s": 1.0, "busy_s": 0.6, "kernels": kernels,
             "routing_s": {"dispatch_cumsum": 0.05, "router_mm": 0.01}}
    ctx = harness.Context(cfg=cfg, window=win, chunks=chunks, decodes=decodes,
                          slice_steps=win.steps, slice_chunks=chunks, slice_decodes=decodes,
                          trace=trace, peaks=harness.flops.PEAKS["NVIDIA H100 80GB HBM3"])
    for m in cell.per_layer:
        v = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read(ctx)
        assert isinstance(v, float) and v > 0, (m["name"], v)
        if m["unit"] == "%":
            assert v < 100, (m["name"], v)
