"""Synthetic LM data pipeline: deterministic, shardable, restart-exact.

Produces (tokens, mask) batches from a seeded token stream with document
structure (BOS-delimited docs of lognormal length), so the loss actually has
learnable structure (n-gram statistics) for the overfit tests. The iterator
state is just (seed, step) — checkpointing the step index makes restarts
bit-exact, which the fault-tolerance tests assert.

A copy of :mod:`repro.training.data` (numpy only), so that both packages
train on identical batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bos_id: int = 1
    ngram_order: int = 2            # synthetic structure strength


class SyntheticTokens:
    """Deterministic batch generator; batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed bigram transition table => learnable structure
        v = cfg.vocab_size
        k = min(v, 32)
        self._next_tok = rng.integers(0, v, size=(v, k)).astype(np.int32)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s), np.int32)
        cur = rng.integers(0, cfg.vocab_size, size=b).astype(np.int32)
        choice = rng.integers(0, self._next_tok.shape[1], size=(b, s))
        for t in range(s):
            toks[:, t] = cur
            cur = self._next_tok[cur, choice[:, t]]
        # sprinkle document boundaries
        n_docs = rng.integers(1, 4, size=b)
        for i in range(b):
            pos = rng.integers(0, s, size=n_docs[i])
            toks[i, pos] = cfg.bos_id
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
