"""Data pipeline: deterministic, shardable, restart-safe token batches.

Port of ``repro/data/pipeline.py`` (pure numpy; the port keeps its own
copy).  Two sources behind one interface:

  * :class:`SyntheticLM` — seeded on-the-fly token streams, a zipf unigram
    mix under a seeded permutation of the vocabulary, so that the embedding
    rows see realistic skew;
  * :class:`MemmapDataset` — a flat int32 (or uint16) token file through
    ``np.memmap``: no copy, O(1) open, one byte range a sequence.

A batch is a pure function of ``(step, dp_rank, dp_size)``, so a run
restored from a checkpoint resumes with no pipeline state.  The batches are
numpy int32 arrays ``{"tokens", "labels"}`` of shape (B, seq_len), the
labels the tokens shifted by one; bitwise the reference's for every
argument.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab: int = 32000
    seed: int = 1234
    path: str | None = None      # memmap file -> MemmapDataset
    zipf_s: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_s)
        self.cdf = np.cumsum(w) / np.sum(w)
        self.perm = rng.permutation(cfg.vocab)

    def batch(self, step: int, dp_rank: int, dp_size: int):
        cfg = self.cfg
        assert cfg.global_batch % dp_size == 0
        local = cfg.global_batch // dp_size
        rng = np.random.default_rng((cfg.seed, step, dp_rank))
        u = rng.random((local, cfg.seq_len + 1))
        toks = self.perm[np.searchsorted(self.cdf, u)].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapDataset:
    def __init__(self, cfg: DataConfig, dtype=np.int32):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_tokens = len(self.data)

    def batch(self, step: int, dp_rank: int, dp_size: int):
        cfg = self.cfg
        local = cfg.global_batch // dp_size
        span = cfg.seq_len + 1
        n_seqs = self.n_tokens // span
        rng = np.random.default_rng((cfg.seed, step))
        order = rng.permutation(n_seqs)              # a shuffle per step
        base = (step * cfg.global_batch + dp_rank * local) % n_seqs
        idx = order[(base + np.arange(local)) % n_seqs]
        rows = np.stack([
            np.asarray(self.data[i * span:(i + 1) * span]) for i in idx
        ]).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_dataset(cfg: DataConfig):
    return MemmapDataset(cfg) if cfg.path else SyntheticLM(cfg)
