"""The benchmark's cells cut to a size a CPU test run holds: the smoke widths
of each configuration's family and a few slots, with the traffic's shape
kept (loop, mixtures, shared prefixes, paging)."""
import dataclasses

from servebench import harness

SMOKE = {
    # two query heads a key head, as codeqwen's GQA has eight
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab=256),
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
                vocab=256, n_experts=8, moe_top_k=2, moe_d_ff=32),
}
#: deeper and wider, for the control: rounding grows with depth and width
#: toward the full models' readings, so the cells' limits apply
DEEP = {
    "dense": dict(SMOKE["dense"], n_layers=8, d_model=256, head_dim=64, d_ff=512, vocab=1024),
    "moe": dict(SMOKE["moe"], n_layers=8, d_model=256, head_dim=64, d_ff=128, moe_d_ff=128,
                vocab=1024),
}
#: an open-loop mix on the paged engine and its prefix cache: no cell of
#: BENCHMARK.json sends one yet, and the generator and the window serve it
#: beside the closed loop (90% of the requests open with one of 8 shared
#: prefixes); its pool is large enough for the arrival rate to hold
OPEN = {"loop": "open", "rate_rps": 20.0, "prompt_lens": [[8, 32]], "prompt_mix": [1.0],
        "output_lens": [[4, 24]], "output_mix": [1.0], "shared_prefix_len": 32,
        "n_shared_prefixes": 8, "shared_fraction": 0.9, "pool": 4096, "block": 8,
        "size_seed": 48002,
        "engine": {"max_batch": 4, "max_len": 96, "paged": True, "prefix_cache": True,
                   "page_size": 8, "num_pages": 2000},
        "check_tokens": 200, "trace_slice_s": 0.5}


class TickClock:
    """A clock that moves ``tick`` seconds at each reading (and jumps on a
    sleep): a run's window then holds the same steps on any host."""

    def __init__(self, tick: float = 1e-3):
        self.t, self.tick = 1000.0, tick

    def now(self) -> float:
        self.t += self.tick
        return self.t

    def sleep_until(self, t: float) -> float:
        self.t = max(self.t, t)
        return self.t


def smoke_cell(name: str, deep: bool = False, traffic: dict = None) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json at smoke size (``deep``: at the
    control's size), under ``traffic`` in place of its own mix if given."""
    cell = harness.load_cell(name)
    cfg = cell.config
    sizes = (DEEP if deep else SMOKE)[cfg["family"]]
    cfg = dict(cfg, model=dict(cfg["model"], **sizes),
               engine=dict(cfg["engine"], prefill_chunk=32, token_budget=32))
    t = dict(traffic or cell.traffic, pool=64, block=8, check_tokens=200, trace_slice_s=0.5,
             output_lens=[[4, 24]], output_mix=[1.0])
    if t["loop"] == "closed":
        t.update(clients=4, prompt_lens=[[8, 32]], prompt_mix=[1.0],
                 engine=dict(t["engine"], max_batch=4, max_len=64))
    return dataclasses.replace(cell, config=cfg, traffic=t)
