"""Synthetic LM data pipeline (offline container: no external corpora).

Generates deterministic, *learnable* token streams: a mixture of k-gram
Markov chains with per-document seeds — enough structure that a ~100M model
demonstrably reduces loss over a few hundred steps (quickstart/train_tiny),
while remaining dependency-free and reproducible. The iterator yields
fixed-shape (tokens, labels, mask) batches with proper next-token shifting
and supports multi-host sharding by slicing the batch dimension.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0          # audio: parallel token streams
    markov_order: int = 2
    n_modes: int = 8              # distinct chain parameterizations


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # per-mode transition structure: next = (a*prev0 + b*prev1 + c) % V
        self.modes = [(int(rng.integers(1, cfg.vocab_size)),
                       int(rng.integers(1, cfg.vocab_size)),
                       int(rng.integers(cfg.vocab_size)),
                       float(rng.uniform(0.05, 0.25)))
                      for _ in range(cfg.n_modes)]

    def _doc(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """A repeated random phrase with light noise: in-context copying is
        quickly learnable (induction-head structure), so short training runs
        show a real loss drop even at large vocabularies."""
        a, b, c, noise = self.modes[int(rng.integers(self.cfg.n_modes))]
        V = self.cfg.vocab_size
        # per-document alphabet: a small mode-anchored token subset, so both
        # in-context copying AND within-doc unigram statistics are learnable
        alpha = (c + a * np.arange(64)) % V
        p = int(rng.integers(8, 33))
        phrase = alpha[rng.integers(len(alpha), size=p)]
        out = np.tile(phrase, n // p + 1)[:n]
        flips = rng.random(n) < noise * 0.3
        out[flips] = alpha[rng.integers(len(alpha), size=int(flips.sum()))]
        return out

    def batches(self, start_step: int = 0) -> Iterator[Tuple[np.ndarray,
                                                             np.ndarray,
                                                             np.ndarray]]:
        cfg = self.cfg
        step = start_step
        while True:
            rng = np.random.default_rng((cfg.seed, step))
            T = cfg.seq_len + 1
            if cfg.n_codebooks:
                raw = np.stack([
                    np.stack([self._doc(rng, T)
                              for _ in range(cfg.n_codebooks)], -1)
                    for _ in range(cfg.global_batch)])
            else:
                raw = np.stack([self._doc(rng, T)
                                for _ in range(cfg.global_batch)])
            tokens = raw[:, :-1]
            labels = raw[:, 1:]
            mask = np.ones(labels.shape[:2], np.float32)
            yield tokens, labels, mask
            step += 1
