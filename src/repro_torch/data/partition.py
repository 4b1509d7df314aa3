"""The paper's synthesized non-IID partitioner (Sec. V-A). A numpy copy of
``repro.data.partition``, bit-exact against it.

"p of a unique class is divided equally for every three workers and the
remaining samples of each class are partitioned to other workers
uniformly." p=0.1..0.8 are the paper's non-IID levels; p = 1/(N/3) is the
IID special case (paper: p=0.1 with N=30).
"""
from __future__ import annotations

import numpy as np

GROUP = 3      # the paper pins each class to a group of three workers


def pskew_partition(labels: np.ndarray, num_workers: int, p: float,
                    rng: np.random.Generator,
                    shift: int = 0) -> list[np.ndarray]:
    """Return per-worker index arrays implementing the paper's p-skew.

    Class c is pinned to worker group g(c) = (c*GROUP+shift ...
    c*GROUP+shift+2) mod N; a p-fraction of its samples goes equally to
    that group, the rest is spread uniformly over the remaining workers.
    ``shift`` rotates the class -> group pinning across the fleet — the
    time-varying non-IID drift axis (``DriftingPartition`` steps it on a
    schedule; shift=0 is the paper's static assignment).
    """
    labels = np.asarray(labels)
    n = num_workers
    shards: list[list[np.ndarray]] = [[] for _ in range(n)]
    classes = np.unique(labels)
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        group = [(int(c) * GROUP + shift + k) % n for k in range(GROUP)]
        others = [w for w in range(n) if w not in group]
        cut = int(round(p * len(idx)))
        pinned, rest = idx[:cut], idx[cut:]
        for k, part in enumerate(np.array_split(pinned, GROUP)):
            shards[group[k]].append(part)
        if others:
            for k, part in enumerate(np.array_split(rest, len(others))):
                shards[others[k]].append(part)
        else:                       # tiny N: spread rest over the group too
            for k, part in enumerate(np.array_split(rest, GROUP)):
                shards[group[k]].append(part)
    out = []
    for w in range(n):
        ix = (np.concatenate(shards[w]) if shards[w]
              else np.empty((0,), np.int64))
        rng.shuffle(ix)
        out.append(ix)
    return out


class DriftingPartition:
    """Time-varying non-IID drift: the label distribution rotates across
    the group assignment on a schedule.

    ``shards_at(h)`` returns the fleet's shards for round ``h``, computed
    as ``pskew_partition(..., shift = h // period)`` — every ``period``
    rounds the class -> worker-group pinning rotates one worker over the
    fleet, so each worker's local distribution slowly cycles through the
    classes while the global distribution stays fixed. Each distinct
    shift's draw comes from its own seeded RNG (``seed + shift``), so a
    shift's shards are a pure function of (labels, num_workers, p, seed,
    shift) — both engines replaying the same rounds see the same shards.
    Results are cached per effective shift (``shift % num_workers``:
    the rotation is periodic in the fleet size).

    Engines accept either a plain shard list or this object wherever
    ``shards`` flows; the eval batches always come from ``shards_at(0)``
    so metrics stay comparable across the run.
    """

    def __init__(self, labels: np.ndarray, num_workers: int, p: float,
                 seed: int, period: int):
        if period <= 0:
            raise ValueError(f"drift period must be positive, got {period}")
        self.labels = np.asarray(labels)
        self.num_workers = num_workers
        self.p = p
        self.seed = seed
        self.period = period
        self._cache: dict[int, list[np.ndarray]] = {}

    def shift_at(self, h: int) -> int:
        """Effective rotation of round ``h`` (drift steps every period)."""
        return (h // self.period) % self.num_workers

    def shards_at(self, h: int) -> list[np.ndarray]:
        """Per-worker index arrays in force at round ``h``."""
        s = self.shift_at(h)
        if s not in self._cache:
            rng = np.random.default_rng(self.seed + s)
            self._cache[s] = pskew_partition(self.labels, self.num_workers,
                                             self.p, rng, shift=s)
        return self._cache[s]

    def __len__(self) -> int:
        return self.num_workers

    def __getitem__(self, w: int) -> np.ndarray:
        # round-0 view: lets drift-unaware consumers (eval batches,
        # AD-PSGD) treat the object as a static shard list
        return self.shards_at(0)[w]

    def __iter__(self):
        return iter(self.shards_at(0))


def label_histogram(labels: np.ndarray, shards: list[np.ndarray],
                    num_classes: int) -> np.ndarray:
    """(N, C) per-worker class histogram — used by tests and by the PENS
    baseline's similarity oracle."""
    h = np.zeros((len(shards), num_classes), np.int64)
    for w, ix in enumerate(shards):
        cls, cnt = np.unique(labels[ix], return_counts=True)
        h[w, cls.astype(int)] = cnt
    return h
