"""The benchmark's traffic generator: seeded, inside its ranges, and the
same sizes and arrivals for every seed, in another order within each
block."""
import itertools

import numpy as np
import pytest

from servebench import harness
from servebench import traffic as tr
from servebench.tests.cells import OPEN

MIXES = ["decode-c128", "open"]
SEEDS = (0, 7, 2**31 + 5)


def _load(name):
    """A traffic file of the benchmark, or the tests' open-loop mix."""
    return OPEN if name == "open" else harness.load_json(harness.HERE / "traffic" / f"{name}.json")


def _first(t, seed, n, vocab=500):
    return list(itertools.islice(tr.request_stream(t, vocab, seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    t = _load(name)
    sig = lambda reqs: [(s.prompt.tolist(), s.max_new, s.at_s, s.prefix_id) for s in reqs]
    assert sig(_first(t, 2**31 + 11, 200, 1000)) == sig(_first(t, 2**31 + 11, 200, 1000))
    assert sig(_first(t, 2**31 + 11, 200, 1000)) != sig(_first(t, 2**31 + 12, 200, 1000))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_their_ranges(name):
    t = _load(name)
    pre = t.get("shared_prefix_len", 0)
    lo_p, hi_p = min(r[0] for r in t["prompt_lens"]), max(r[1] for r in t["prompt_lens"])
    lo_o, hi_o = min(r[0] for r in t["output_lens"]), max(r[1] for r in t["output_lens"])
    for s in _first(t, 3, 300):
        tail = len(s.prompt) - (pre if s.prefix_id >= 0 else 0)
        assert lo_p <= tail <= hi_p and lo_o <= s.max_new <= hi_o
        assert s.prompt.dtype == np.int32 and s.prompt.max() < 500


@pytest.mark.parametrize("name", MIXES)
def test_each_block_holds_the_same_work_for_every_seed(name):
    t = _load(name)
    n, blocks = t["block"], 3
    runs = [_first(t, seed, n * blocks) for seed in SEEDS]
    for k in range(blocks):
        sets = [sorted((len(s.prompt), s.max_new, s.prefix_id) for s in r[k * n:(k + 1) * n])
                for r in runs]
        assert all(x == sets[0] for x in sets)
        if t["loop"] == "open":        # the same gaps: each block ends at one time
            ends = {round(r[(k + 1) * n - 1].at_s, 9) for r in runs}
            assert len(ends) == 1
    orders = {tuple(len(s.prompt) for s in r) for r in runs}
    assert len(orders) == (len(SEEDS) if n > 1 else 1)


def test_open_loop_arrivals_follow_the_rate():
    t = _load("open")
    at = np.array([s.at_s for s in _first(t, 3, 2000)])
    assert (np.diff(at) > 0).all()
    assert 0.9 < len(at) / at[-1] / t["rate_rps"] < 1.1


def test_shared_prefixes_open_their_share_of_requests():
    t = _load("open")
    reqs = _first(t, 9, 2000)
    pre = tr.shared_prefixes(t, 500, 9)
    tagged = [s for s in reqs if s.prefix_id >= 0]
    assert abs(len(tagged) / len(reqs) - t["shared_fraction"]) < 0.03
    assert {s.prefix_id for s in tagged} == set(range(t["n_shared_prefixes"]))
    for s in tagged:
        assert (s.prompt[:t["shared_prefix_len"]] == pre[s.prefix_id]).all()
