"""The benchmark's traffic: one general generator driven by a traffic file.

A traffic file (``servebench/traffic/<name>.json``) gives the parameters:

* ``loop``: ``"closed"`` (``clients`` callers, each sending its next request
  as soon as the previous one retires) or ``"open"``
  (Poisson arrivals at ``rate_rps``, sent on schedule whatever the system
  does);
* ``prompt_lens``/``prompt_mix`` and ``output_lens``/``output_mix``:
  weighted mixtures of inclusive ``[lo, hi]`` ranges, lengths uniform inside
  the chosen range (``_mixture_lengths``, copied from the port's
  ``serve/traffic.py``);
* ``shared_prefix_len``, ``n_shared_prefixes``, ``shared_fraction``: a share
  of the requests opens with one of a few shared prefixes, followed by its
  own tail drawn from ``prompt_lens``;
* ``size_seed``, ``pool`` and ``block``: the sizes (prompt and output
  lengths, prefix tags, arrival gaps) are drawn ONCE, from ``size_seed``, as
  a sequence of ``pool`` requests that the run walks through (and starts
  again). The run's ``--seed`` permutes each ``block`` consecutive entries
  among themselves and draws every token id and every shared prefix, so
  each seed gets the same sizes and arrivals in another order, and any
  stretch of the run holds the same work whatever the seed, to a block.

Everything here is numpy: the same seed gives the same requests.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as the traffic makes it: its prompt, its output budget,
    its arrival in seconds from the window's opening (open loop; 0 for a
    closed loop, whose clients send when they are free) and its shared
    prefix (-1: none)."""
    prompt: np.ndarray
    max_new: int
    at_s: float = 0.0
    prefix_id: int = -1


def _mixture_lengths(rng: np.random.Generator, n: int, ranges: tuple,
                     mix: tuple) -> np.ndarray:
    """n integer lengths from a weighted mixture of inclusive ranges (a
    copy of ``repro_torch.serve.traffic._mixture_lengths``)."""
    assert len(ranges) == len(mix) and len(ranges) >= 1, (ranges, mix)
    for lo, hi in ranges:
        assert 1 <= lo <= hi, f"bad length range ({lo}, {hi})"
    w = np.asarray(mix, np.float64)
    assert (w >= 0).all() and w.sum() > 0, f"bad mixture weights {mix}"
    comp = rng.choice(len(ranges), size=n, p=w / w.sum())
    lens = np.empty(n, np.int64)
    for j, (lo, hi) in enumerate(ranges):
        idx = comp == j
        lens[idx] = rng.integers(lo, hi + 1, size=int(idx.sum()))
    return lens


def pool_sizes(traffic: dict) -> dict:
    """The sizes every seed shares: prompt (tail) lengths, output budgets,
    shared-prefix tags and, for an open loop, arrival gaps, each an array
    of ``traffic["pool"]`` entries drawn from ``size_seed``."""
    n = int(traffic["pool"])
    rng = np.random.default_rng(int(traffic["size_seed"]))
    out = {
        "prompt": _mixture_lengths(rng, n, traffic["prompt_lens"], traffic["prompt_mix"]),
        "output": _mixture_lengths(rng, n, traffic["output_lens"], traffic["output_mix"]),
        "prefix": np.full(n, -1, np.int64),
        "gap": np.zeros(n, np.float64),
    }
    if traffic["loop"] == "open":
        out["gap"] = rng.exponential(1.0 / float(traffic["rate_rps"]), n)
    if traffic.get("shared_prefix_len", 0) > 0:
        shared = rng.random(n) < float(traffic["shared_fraction"])
        tags = rng.integers(0, int(traffic["n_shared_prefixes"]), n)
        out["prefix"] = np.where(shared, tags, -1)
    return out


def shared_prefixes(traffic: dict, vocab: int, seed: int) -> List[np.ndarray]:
    """The shared prefixes of a run (none without the mixture): drawn first
    from the run's seed, so the requests' tokens follow them."""
    rng = np.random.default_rng(seed)
    if traffic.get("shared_prefix_len", 0) <= 0:
        return []
    return [rng.integers(0, vocab, int(traffic["shared_prefix_len"])).astype(np.int32)
            for _ in range(int(traffic["n_shared_prefixes"]))]


def request_stream(traffic: dict, vocab: int, seed: int) -> Iterator[Spec]:
    """The run's requests, in order, without end: the shared sizes, each
    block of ``block`` entries permuted by the seed (sizes and prefix tags
    together, arrival gaps apart), with token ids drawn from the seed.
    ``at_s`` (open loop) is the running sum of the permuted gaps."""
    sizes = pool_sizes(traffic)
    pool, block = int(traffic["pool"]), int(traffic["block"])
    prefixes = shared_prefixes(traffic, vocab, seed)
    rng = np.random.default_rng([seed, 1])
    t = 0.0
    for start in itertools.cycle(range(0, pool, block)):
        idx = np.arange(start, min(start + block, pool))
        order = idx[rng.permutation(len(idx))]
        gaps = sizes["gap"][idx[rng.permutation(len(idx))]]
        for i, gap in zip(order, gaps):
            t += float(gap)
            tail = rng.integers(0, vocab, int(sizes["prompt"][i])).astype(np.int32)
            tag = int(sizes["prefix"][i])
            prompt = tail if tag < 0 else np.concatenate([prefixes[tag], tail])
            yield Spec(prompt=prompt, max_new=int(sizes["output"][i]), at_s=t, prefix_id=tag)
