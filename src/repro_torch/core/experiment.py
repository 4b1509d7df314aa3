"""Experiment harness wiring data + cluster + strategy (the port of
``repro.core.experiment``): the entry point a user calls,
``run_algorithm(algo, cfg)``."""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.base import FedHPConfig
from repro_torch.core import engine
from repro_torch.core import modelspec
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.fused import run_adpsgd_fused, run_dfl_fused
from repro_torch.core.topology import make_base_topology
from repro_torch.data.partition import DriftingPartition, pskew_partition
from repro_torch.data.synthetic import Dataset
from repro_torch.simulation.cluster import ChurnSchedule, SimCluster


def churn_from_config(cfg: FedHPConfig,
                      rounds: int | None = None) -> ChurnSchedule | None:
    """Generate the seeded churn schedule cfg describes (None if disabled)."""
    if cfg.churn_rate <= 0.0:
        return None
    return ChurnSchedule.generate(
        cfg.num_workers, rounds or cfg.rounds, rate=cfg.churn_rate,
        seed=cfg.churn_seed, min_alive=cfg.churn_min_alive,
        straggle_factor=cfg.straggle_factor,
        straggle_duration=cfg.straggle_duration)


def setup_experiment(cfg: FedHPConfig, *, non_iid_p: float = 0.1,
                     num_samples: int = 6000, dim: int = 32,
                     num_classes: int = 10, spread: float = 1.0,
                     fail_at: dict | None = None,
                     churn: ChurnSchedule | None = None,
                     rounds: int | None = None, device=None):
    """Build (train data, test x, test y, shards, cluster) for one
    experiment — the reference's streams, so the same seed gives the same
    data, partition and cluster in both packages. The test split comes
    back as tensors on ``device`` (``None`` means the GPU and raises
    without one); the training rows stay on the host, where the engines
    draw their batches."""
    device = engine.resolve_device(device)
    engine.check_ported(cfg)
    adapter = modelspec.get_adapter(cfg.model, dim=dim,
                                    num_classes=num_classes)
    data = adapter.make_data(num_samples, seed=cfg.seed, spread=spread)
    n_test = max(num_samples // 6, 256)
    train = Dataset(data.x[n_test:], data.y[n_test:], data.num_classes)
    test_x = torch.as_tensor(data.x[:n_test], device=device)
    test_y = torch.as_tensor(data.y[:n_test], device=device)
    if cfg.drift_every > 0:
        # time-varying non-IID: the class -> group pinning rotates every
        # drift_every rounds; shift 0 reproduces the static partition
        shards = DriftingPartition(train.y, cfg.num_workers, non_iid_p,
                                   cfg.seed + 1, cfg.drift_every)
    else:
        rng = np.random.default_rng(cfg.seed + 1)
        shards = pskew_partition(train.y, cfg.num_workers, non_iid_p, rng)
    if churn is None:
        churn = churn_from_config(cfg, rounds)
    cluster = SimCluster(cfg.num_workers, model_bits=adapter.model_bits,
                         seed=cfg.seed, fail_at=fail_at or {}, churn=churn)
    return train, test_x, test_y, shards, cluster


def run_algorithm(algorithm: str, cfg: FedHPConfig, *,
                  non_iid_p: float = 0.1, rounds: int | None = None,
                  mixing: str = "uniform", fail_at: dict | None = None,
                  spread: float = 1.0, churn: ChurnSchedule | None = None,
                  time_budget: float | None = None, fused: bool = False,
                  seeds=None, num_samples: int = 6000, mesh=None,
                  device=None):
    """Run one (algorithm, non-IID level) cell and return its History.

    ``fused=True`` routes the run through the fused engines
    (``run_dfl_fused`` for the synchronous strategies,
    ``run_adpsgd_fused`` for the event-driven AD-PSGD; the device
    work goes through the CUDA kernels on the GPU); otherwise the
    reference ``engine.run_dfl`` / ``engine.run_adpsgd``. ``device``:
    ``None`` means the GPU and raises without one; ``"cpu"`` runs on the
    CPU."""
    cfg = replace(cfg, algorithm=algorithm)
    engine.check_ported(cfg, mesh=mesh, seeds=seeds)
    train, tx, ty, shards, cluster = setup_experiment(
        cfg, non_iid_p=non_iid_p, fail_at=fail_at, spread=spread,
        churn=churn, rounds=rounds, num_samples=num_samples, device=device)
    if algorithm == "adpsgd":
        run = run_adpsgd_fused if fused else engine.run_adpsgd
        return run(train, tx, ty, shards, cluster, cfg, rounds=rounds,
                   time_budget=time_budget, device=device)
    base = make_base_topology(cfg.num_workers, cfg.base_topology, cfg.seed)
    strategy = make_strategy(cfg, base)
    run = run_dfl_fused if fused else engine.run_dfl
    return run(train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
               mixing=mixing, time_budget=time_budget, device=device)
