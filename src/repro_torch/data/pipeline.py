"""Deterministic synthetic data, the port's own copy of the reference's
``repro/data/pipeline.py`` (numpy only): a Zipfian unigram over the vocab
and a sparse Markov successor table, so the LM loss has signal to learn,
packed into fixed-length rows and sharded by host. ``batch_at(step)`` is a
pure function of (config, step), array for array the reference's, so a
restarted job resumes mid-stream exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2
    markov_order: int = 1


class SyntheticCorpus:
    """Zipf-Markov token stream; any host can regenerate any shard of any
    step."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must be a multiple of n_hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # sparse Markov kernel: each token prefers a small successor set
        self.succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, 4))

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (local_batch, seq_len) int32 each, labels the
        tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 4_096 + cfg.host_id)
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(cfg.vocab, size=b, p=self.unigram)
        mix = rng.random((b, s))
        jumps = rng.choice(cfg.vocab, size=(b, s), p=self.unigram)
        picks = rng.integers(0, 4, size=(b, s))
        for t in range(s):
            markov = self.succ[toks[:, t], picks[:, t]]
            toks[:, t + 1] = np.where(mix[:, t] < 0.75, markov, jumps[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
