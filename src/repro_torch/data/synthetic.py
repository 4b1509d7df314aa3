"""Synthetic classification data standing in for EMNIST/CIFAR-10/IMAGE-100
(a numpy copy of ``repro.data.synthetic``, bit-exact on the same seed).

The classification task is a Gaussian-mixture blob problem: class c is a
Gaussian at a random center; a small MLP separates them. Crucially the
per-class structure makes the paper's p-skew partition produce genuinely
non-IID worker shards, reproducing the statistical-heterogeneity axis.
The registry LMs train on ``make_token_data``'s class-structured token
corpus; ``worker_batch_iterator`` walks one worker's shard in shuffled
mini-batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray          # [N, dim] features (or [N, S] int tokens)
    y: np.ndarray          # [N] labels (the document class for tokens)
    num_classes: int


def make_classification_data(num_samples: int = 6000, dim: int = 32,
                             num_classes: int = 10, *, spread: float = 1.0,
                             seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 2.0, (num_classes, dim))
    y = rng.integers(0, num_classes, num_samples)
    x = centers[y] + rng.normal(0.0, spread, (num_samples, dim))
    return Dataset(x.astype(np.float32), y.astype(np.int32), num_classes)


def make_token_data(num_sequences: int = 512, seq_len: int = 128,
                    vocab_size: int = 256, *, num_classes: int = 8,
                    seed: int = 0) -> Dataset:
    """Synthetic LM corpus with class structure: each "document class" is a
    distinct first-order Markov chain, so p-skew partitions are non-IID.
    It draws one dense [V, V] float64 transition matrix per class (8 V^2
    bytes each: 302 MB at V = 6,144)."""
    rng = np.random.default_rng(seed)
    # one random band-diagonal transition matrix per class
    trans = []
    for c in range(num_classes):
        t = rng.random((vocab_size, vocab_size)) ** 4
        roll = rng.integers(1, vocab_size)
        t += 4.0 * np.eye(vocab_size)[:, np.roll(np.arange(vocab_size), roll)]
        trans.append(t / t.sum(1, keepdims=True))
    y = rng.integers(0, num_classes, num_sequences)
    x = np.zeros((num_sequences, seq_len), np.int32)
    x[:, 0] = rng.integers(0, vocab_size, num_sequences)
    u = rng.random((num_sequences, seq_len))
    for s in range(1, seq_len):
        for c in range(num_classes):
            m = y == c
            if not m.any():
                continue
            cum = np.cumsum(trans[c][x[m, s - 1]], axis=1)
            x[m, s] = (u[m, s][:, None] < cum).argmax(axis=1)
    return Dataset(x, y.astype(np.int32), num_classes)


def worker_batch_iterator(data: Dataset, shard: np.ndarray, batch_size: int,
                          seed: int = 0) -> Iterator[dict]:
    """Infinite shuffled mini-batch iterator over one worker's shard:
    {"x", "y"} numpy batches, each pass over a fresh permutation, the
    reference's stream on the same seed."""
    rng = np.random.default_rng(seed)
    if len(shard) == 0:
        raise ValueError("empty shard")
    while True:
        order = rng.permutation(len(shard))
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            ix = shard[order[lo:lo + batch_size]]
            yield {"x": data.x[ix], "y": data.y[ix]}
        if len(order) < batch_size:        # shard smaller than a batch
            ix = shard[rng.integers(0, len(shard), batch_size)]
            yield {"x": data.x[ix], "y": data.y[ix]}
