"""Deterministic, resumable, shardable synthetic-LM data pipeline (a copy of
``repro/data/pipeline.py``, numpy only: batches equal the JAX package's).

Real deployments swap `SyntheticLMDataset` for a tokenized corpus reader;
every other property the trainer relies on is provided here:

* **Determinism** — batch t is a pure function of (seed, step), so restarts
  reproduce the exact token stream (bitwise), which makes checkpoint-resume
  testable and straggler-failover deterministic.
* **Skip-ahead resume** — `state = dict(step=...)`: O(1) seek, no replay.
* **Sharding** — `global_batch` is laid out host-major; `local_slice` maps a
  (process_index, process_count) pair to its contiguous batch rows, matching
  the (pod, data) mesh axes the trainer shards batches over.
* **Structured stream** — the synthetic stream is a mixture of repeated
  n-grams + noise with per-document Zipf unigrams, so a real LM *can learn
  it* (loss drops well below uniform), which the examples rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    ngram_order: int = 3
    noise_prob: float = 0.1


class SyntheticLMDataset:
    """Markov-chain synthetic corpus with deterministic random access."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed sparse transition structure: each state has 4 likely successors
        self._succ = root.integers(0, v, size=(v, 4))
        self._zipf = 1.0 / np.arange(1, v + 1)
        self._zipf /= self._zipf.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a given step (pure function of (seed, step))."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, B)
        noise = rng.random((B, S)) < cfg.noise_prob
        branch = rng.integers(0, 4, (B, S))
        rand_tok = rng.integers(0, v, (B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def local_slice(self, batch: Dict[str, np.ndarray], process_index: int,
                    process_count: int) -> Dict[str, np.ndarray]:
        B = self.cfg.global_batch
        assert B % process_count == 0
        per = B // process_count
        lo = process_index * per
        return {k: v[lo: lo + per] for k, v in batch.items()}


class DataIterator:
    """Stateful iterator with O(1) checkpointable state."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0):
        self.dataset = dataset
        self.step = start_step

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.dataset.batch_at(self.step)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
