"""Model-free draft proposals for speculative decode (prompt lookup).

A decode step streams the full weight set from device memory whether it
scores 1 token or K+1, so any token the verify pass accepts beyond the
first is nearly free. The cheapest drafter that exploits this is prompt
lookup: find the current suffix n-gram earlier in the stream and propose
whatever followed it.

Correctness never depends on draft quality: under greedy decode the verify
pass commits only drafts that match the model's own argmax; under sampled
decode the engine runs speculative sampling against this drafter's
distribution, a point mass at each proposed token. Because that
distribution must cover REAL proposals only, the drafter reports ``k_eff``,
the number of real tokens among the k it returns: token id 0 is a
legitimate token, so zero padding alone cannot say where the proposal ends.

A copy of the JAX package's ``serve/spec.py`` (numpy only), so the port
imports nothing of that package; the tests hold the two equal.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def ngram_propose(context: np.ndarray, k: int, ngram_max: int) -> Tuple[np.ndarray, int]:
    """Propose up to ``k`` draft tokens by prompt lookup over ``context``.

    Finds the longest suffix n-gram (n = ngram_max .. 1) of ``context`` that
    also occurs earlier, and returns ``(draft, k_eff)``: the tokens that
    followed an earlier occurrence, zero-padded at the tail, and the number
    ``k_eff`` of real proposals among them. A miss returns ``(zeros, 0)``.

    Among the earlier occurrences, the most recent one with a FULL k-token
    continuation wins; if none has k tokens before the context end, the
    most recent occurrence wins with a short (``k_eff < k``) continuation.
    A self-repetitive tail puts the most recent match flush against the
    context end, where only one continuation token exists; preferring a
    full continuation keeps the proposal at k tokens.
    """
    ctx = np.asarray(context, np.int32).ravel()
    out = np.zeros(k, np.int32)
    n_ctx = len(ctx)
    if n_ctx < 2 or k <= 0:
        return out, 0
    for n in range(min(ngram_max, n_ctx - 1), 0, -1):
        suffix = ctx[n_ctx - n:]
        # windows of length n starting at 0 .. n_ctx-n-1 (not the suffix itself)
        wins = np.lib.stride_tricks.sliding_window_view(ctx, n)[:-1]
        hits = np.nonzero((wins == suffix).all(axis=1))[0]
        if hits.size:
            full = hits[hits + n + k <= n_ctx]
            start = int(full[-1] if full.size else hits[-1]) + n
            cont = ctx[start:start + k]
            out[:len(cont)] = cont
            return out, len(cont)
    return out, 0
