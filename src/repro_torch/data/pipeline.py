"""Deterministic, restartable, sharded data pipeline.

Synthetic-token stream (a stand-in for a tokenized corpus reader) whose
content is a pure function of (seed, global cursor). Restartability is the
property LogAct needs: a ``train_chunk`` intention names its data range
``[cursor, cursor + steps * global_batch)`` explicitly, so recovery can
verify (via the log) exactly which samples were consumed, and the
rule-voter's data-cursor-monotonicity check can reject replays.

Every batch also carries its cursor so checkpoints are log-anchored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain synthetic text (so loss actually decreases in examples)
    order: int = 1


class TokenPipeline:
    """``batch_at(cursor)`` is pure: same (seed, cursor) -> same batch."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed synthetic markov transition table
        rng = np.random.default_rng(cfg.seed)
        logits = rng.normal(size=(cfg.vocab, cfg.vocab)).astype(np.float32)
        # sparsify: each token has ~16 likely successors
        top = np.argsort(logits, axis=1)[:, -16:]
        probs = np.zeros_like(logits)
        np.put_along_axis(probs, top, 1.0, axis=1)
        self._probs = probs / probs.sum(axis=1, keepdims=True)

    def _sample_row(self, sample_idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, sample_idx))
        out = np.empty(cfg.seq_len + 1, np.int32)
        out[0] = rng.integers(cfg.vocab)
        # vectorized-ish markov walk
        u = rng.random(cfg.seq_len)
        for t in range(cfg.seq_len):
            c = np.cumsum(self._probs[out[t]])
            out[t + 1] = np.searchsorted(c, u[t])
        return out

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        """Global sample indices [cursor*GB, (cursor+1)*GB), local shard."""
        cfg = self.cfg
        base = cursor * cfg.global_batch + self.shard_index * self.local_batch
        rows = np.stack([self._sample_row(base + i)
                         for i in range(self.local_batch)])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:],
                "cursor": np.int64(cursor)}

    def iterate(self, start_cursor: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        c = start_cursor
        while True:
            yield self.batch_at(c)
            c += 1
