"""Shared helpers of the PyTorch port's differential tests: the same seeds,
configs and JAX-initialised weights through the reference JAX package
(``repro``) and the port (``repro_torch``), everything on the CPU.

Inputs cross between the two packages as numpy arrays only.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import numpy as np
import torch

from repro.configs.base import FedHPConfig as JaxConfig
from repro.core import engine as jax_engine
from repro.core import experiment as jax_experiment
from repro.core import modelspec as jax_modelspec
from repro.core.algorithms import make_strategy as jax_make_strategy
from repro.core.topology import make_base_topology as jax_base_topology
from repro.simulation.cluster import ChurnEvent as JaxChurnEvent
from repro.simulation.cluster import ChurnSchedule as JaxChurnSchedule
from repro_torch.configs.base import FedHPConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import engine, experiment, fused
from repro_torch.core.algorithms import RoundPlan, make_strategy
from repro_torch.core.topology import make_base_topology
from repro_torch.simulation.cluster import ChurnEvent, ChurnSchedule

# the driver runs one test file per xdist worker: keep each on one core
torch.set_num_threads(1)

# W = 8 workers; spread 3.0 keeps the MLP from saturating at accuracy 1.0
# within a few rounds (at the default spread the comparison would be
# between two constant trajectories)
CFG_KW = dict(num_workers=8, rounds=8, tau_init=5, tau_max=20, lr=0.1,
              batch_size=32, seed=3)
DATA_KW = dict(non_iid_p=0.4, spread=3.0)
ROUNDS = 8

# joins, a graceful leave, a crash and a straggler spike inside the run
# (the reference's tests/test_fused_equivalence.py schedule)
CHURN_EVENTS = ((2, "leave", 1, {}), (3, "crash", 6, {}),
                (4, "straggle", 2, dict(factor=5.0, duration=3)),
                (6, "join", 1, {}))


def jax_churn(churn: bool):
    return JaxChurnSchedule(tuple(JaxChurnEvent(r, k, w, **kw)
                                  for r, k, w, kw in CHURN_EVENTS)) \
        if churn else None


def torch_churn(churn: bool):
    return ChurnSchedule(tuple(ChurnEvent(r, k, w, **kw)
                               for r, k, w, kw in CHURN_EVENTS)) \
        if churn else None


def jax_init(seed: int, num_workers: int, dim: int = 32, hidden: int = 64,
             num_classes: int = 10, model: str = "mlp") -> dict:
    """The reference's ``adapter.init(PRNGKey(seed))`` for the model
    ``model`` names, broadcast to a worker-stacked numpy pytree (nested
    dicts for a registry model) — the weights both packages start
    from."""
    adapter = jax_modelspec.get_adapter(model, dim=dim, hidden=hidden,
                                        num_classes=num_classes)
    p0 = adapter.init(jax.random.PRNGKey(seed))
    return jax.tree.map(
        lambda v: np.broadcast_to(np.asarray(v), (num_workers,) + v.shape),
        p0)


class RecordingStrategy:
    """Wraps a reference strategy and keeps a copy of every plan it
    makes, for replay into the port (``ReplayStrategy``)."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.adaptive = inner.adaptive
        self.plans: dict[int, tuple] = {}

    def plan(self, h, alive=None):
        p = self.inner.plan(h, alive=alive)
        self.plans[h] = (p.adj.copy(), p.taus.copy(),
                         None if p.extra_time is None
                         else np.array(p.extra_time))
        return p

    def observe(self, h, **kw):
        self.inner.observe(h, **kw)


class ReplayStrategy:
    """Feeds the reference run's recorded plans to a port engine, round by
    round; ignores the port's observations."""

    def __init__(self, recorded: RecordingStrategy):
        self.name = recorded.name
        self.adaptive = recorded.adaptive
        self.plans = recorded.plans

    def plan(self, h, alive=None):
        adj, taus, extra = self.plans[h]
        return RoundPlan(adj.copy(), taus.copy(), extra_time=extra)

    def observe(self, h, **kw):
        pass


def run_reference(algo: str, churn: bool, rounds: int = ROUNDS, *,
                  mixing: str = "uniform", **cfg_kw):
    """The reference ``engine.run_dfl`` from the JAX init; returns
    (History, RecordingStrategy). ``cfg_kw`` adds config fields (e.g. a
    codec) to ``CFG_KW`` or overrides them."""
    cfg = JaxConfig(**{**CFG_KW, **cfg_kw}, algorithm=algo)
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, churn=jax_churn(churn), rounds=rounds, **DATA_KW)
    strategy = RecordingStrategy(jax_make_strategy(
        cfg, jax_base_topology(cfg.num_workers, cfg.base_topology,
                               cfg.seed)))
    hist = jax_engine.run_dfl(
        train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
        mixing=mixing, init_params=jax_init(cfg.seed, cfg.num_workers,
                                            model=cfg.model))
    return hist, strategy


def run_port(algo: str, churn: bool, engine_name: str, *,
             rounds: int = ROUNDS, replay: RecordingStrategy | None = None,
             mixing: str = "uniform", **cfg_kw):
    """The port's ``run_dfl`` or ``run_dfl_fused`` on the CPU from the same
    JAX init — with its own strategy, or replaying ``replay``'s plans."""
    cfg = FedHPConfig(**{**CFG_KW, **cfg_kw}, algorithm=algo)
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        cfg, churn=torch_churn(churn), rounds=rounds, device="cpu",
        **DATA_KW)
    strategy = (ReplayStrategy(replay) if replay is not None else
                make_strategy(cfg, make_base_topology(
                    cfg.num_workers, cfg.base_topology, cfg.seed)))
    run = {"reference": engine.run_dfl,
           "fused": fused.run_dfl_fused}[engine_name]
    return run(train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
               mixing=mixing,
               init_params=params_from_jax(jax_init(cfg.seed,
                                                    cfg.num_workers,
                                                    model=cfg.model)),
               device="cpu")


def run_reference_adpsgd(churn: bool, rounds: int = ROUNDS, **cfg_kw):
    """The reference ``engine.run_adpsgd`` (which starts from the JAX
    init ``jax_init`` gives)."""
    cfg = JaxConfig(**{**CFG_KW, **cfg_kw}, algorithm="adpsgd")
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, churn=jax_churn(churn), rounds=rounds, **DATA_KW)
    return jax_engine.run_adpsgd(train, tx, ty, shards, cluster, cfg,
                                 rounds=rounds)


def run_port_adpsgd(churn: bool, engine_name: str, *, rounds: int = ROUNDS,
                    **cfg_kw):
    """The port's ``run_adpsgd`` or ``run_adpsgd_fused`` on the CPU from
    the JAX init."""
    cfg = FedHPConfig(**{**CFG_KW, **cfg_kw}, algorithm="adpsgd")
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        cfg, churn=torch_churn(churn), rounds=rounds, device="cpu",
        **DATA_KW)
    run = {"reference": engine.run_adpsgd,
           "fused": fused.run_adpsgd_fused}[engine_name]
    return run(train, tx, ty, shards, cluster, cfg, rounds=rounds,
               init_params=params_from_jax(jax_init(cfg.seed,
                                                    cfg.num_workers,
                                                    model=cfg.model)),
               device="cpu")


# the registry slice's tiny dense LM (tests/test_torch_registry_engine.py
# says why this size)
TINY_LM = "dense:d=32,layers=2,heads=2,kv=1,ff=32,vocab=32,seq=12"
# the parity contract (tests/test_torch_engine.py)
EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time", "staleness")
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6


def assert_parity(h_ref, h_port, rounds: int) -> None:
    """The parity contract between a reference and a port History: host
    fields exactly equal, accuracy within 1/512, loss and consensus
    within 1e-4 relative (consensus also 1e-6 absolute), finite final
    parameters of the adapter's leaves."""
    assert len(h_ref.records) == len(h_port.records) == rounds
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=REL_TOL)
    np.testing.assert_allclose(a["consensus"], b["consensus"],
                               rtol=REL_TOL, atol=CONSENSUS_ATOL)
    for name, leaf in h_port.final_params.items():
        assert bool(torch.isfinite(leaf).all()), name


def worst_diffs(a: dict, b: dict) -> dict[str, float]:
    """The largest device-metric differences of two ``as_arrays()``:
    accuracy absolute, loss and consensus relative to ``a``."""
    return {"accuracy": float(np.abs(a["accuracy"] - b["accuracy"]).max()),
            **{k: float((np.abs(a[k] - b[k])
                         / np.maximum(np.abs(a[k]), 1e-12)).max())
               for k in ("loss", "consensus")}}


def port_config(**kw) -> FedHPConfig:
    return replace(FedHPConfig(**CFG_KW), **kw)
