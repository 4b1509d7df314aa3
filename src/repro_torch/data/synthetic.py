"""Synthetic classification data standing in for EMNIST/CIFAR-10/IMAGE-100
(a numpy copy of ``repro.data.synthetic``, bit-exact on the same seed).

The classification task is a Gaussian-mixture blob problem: class c is a
Gaussian at a random center; a small MLP separates them. Crucially the
per-class structure makes the paper's p-skew partition produce genuinely
non-IID worker shards, reproducing the statistical-heterogeneity axis.
The LM token corpus (``make_token_data``) arrives with the registry slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray          # [N, dim] features
    y: np.ndarray          # [N] labels
    num_classes: int


def make_classification_data(num_samples: int = 6000, dim: int = 32,
                             num_classes: int = 10, *, spread: float = 1.0,
                             seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 2.0, (num_classes, dim))
    y = rng.integers(0, num_classes, num_samples)
    x = centers[y] + rng.normal(0.0, spread, (num_samples, dim))
    return Dataset(x.astype(np.float32), y.astype(np.int32), num_classes)
