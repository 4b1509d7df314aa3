"""Configuration options of the synchronous engines that no other port
test reaches, each through the reference JAX engines and both port
engines on the ``_torch_parity`` fleet (the MLP, W = 8, 8 rounds, the
same seeds and the reference's initialisation), under the parity
contract (``_torch_parity.assert_parity``; int8's wider bounds where a
codec quantizes to int8):

- non-IID drift, ``drift_every=2`` (FedHP, D-PSGD);
- ``replan_every=3`` (FedHP with and without churn, and under int8): the
  port's fused engine against the reference's ``run_dfl_fused``, which
  freezes each plan for a segment, and its reference engine against the
  reference's ``run_dfl``;
- the wire-blind planner, ``planner_wire_aware=False``, under top-k;
- a ring base under churn (FedHP, LD-SGD, and PENS, whose fused engine
  replays the reference's plans: ``tests/_torch_parity.py`` says why);
- LD-SGD's ``ldsgd_i1=2, ldsgd_i2=3``;
- ``error_feedback=False`` under top-k and rand-k, and
  ``sparse_gamma=0.1`` under top-k.

``time_budget`` on all four engines is in
``tests/test_torch_options_budget.py``.
"""
from __future__ import annotations

import pytest

from _torch_parity import (CFG_KW, DATA_KW, ROUNDS, JaxConfig,
                           RecordingStrategy, assert_parity,
                           jax_base_topology, jax_churn, jax_engine,
                           jax_experiment, jax_init, jax_make_strategy,
                           port_config, run_port, xla_cache)
from repro.core import fused as jax_fused
from repro_torch.convert import params_from_jax
from repro_torch.core import engine, experiment, fused
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.topology import make_base_topology

CASES = {
    "drift-fedhp": ("fedhp", dict(drift_every=2), False, False),
    "drift-dpsgd": ("dpsgd", dict(drift_every=2), False, False),
    "replan3-fedhp": ("fedhp", dict(replan_every=3), False, False),
    "replan3-fedhp-churn": ("fedhp", dict(replan_every=3), True, False),
    "replan3-fedhp-int8": ("fedhp", dict(replan_every=3, compress="int8"),
                           False, False),
    "wire-blind-topk": ("fedhp", dict(planner_wire_aware=False,
                                      compress="topk:0.1"), False, False),
    "ring-churn-fedhp": ("fedhp", dict(base_topology="ring"), True, False),
    "ring-churn-ldsgd": ("ldsgd", dict(base_topology="ring"), True, False),
    "ring-churn-pens": ("pens", dict(base_topology="ring"), True, True),
    "ldsgd-i1-2-i2-3": ("ldsgd", dict(ldsgd_i1=2, ldsgd_i2=3), False,
                        False),
    "no-ef-topk": ("dpsgd", dict(error_feedback=False, compress="topk:0.1"),
                   False, False),
    "no-ef-randk": ("dpsgd", dict(error_feedback=False,
                                  compress="randk:0.1"), False, False),
    "gamma-0.1-topk": ("fedhp", dict(sparse_gamma=0.1, compress="topk:0.1"),
                       False, False),
}


def run_jax(algo: str, churn: bool, engine_name: str, **cfg_kw):
    """The reference's ``run_dfl`` or ``run_dfl_fused`` from the JAX
    init -> (History, RecordingStrategy)."""
    cfg = JaxConfig(**{**CFG_KW, **cfg_kw}, algorithm=algo)
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, churn=jax_churn(churn), rounds=ROUNDS, **DATA_KW)
    strategy = RecordingStrategy(jax_make_strategy(
        cfg, jax_base_topology(cfg.num_workers, cfg.base_topology,
                               cfg.seed)))
    run = {"reference": jax_engine.run_dfl,
           "fused": jax_fused.run_dfl_fused}[engine_name]
    with xla_cache():
        hist = run(train, tx, ty, shards, cluster, cfg, strategy,
                   rounds=ROUNDS,
                   init_params=jax_init(cfg.seed, cfg.num_workers))
    return hist, strategy


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_reference(case):
    algo, fields, churn, replay = CASES[case]
    int8 = fields.get("compress") == "int8"
    h_ref, rec = run_jax(algo, churn, "reference", **fields)
    h_port = run_port(algo, churn, "reference", **fields)
    assert_parity(h_ref, h_port, ROUNDS, int8=int8)
    if "replan_every" in fields:
        # a frozen plan a segment: the fused engines against each other
        h_ref, rec = run_jax(algo, churn, "fused", **fields)
    h_port = run_port(algo, churn, "fused", replay=rec if replay else None,
                      **fields)
    assert_parity(h_ref, h_port, ROUNDS, int8=int8)


KEPT = 5


def _jax(algo: str, engine_name: str, time_budget=None):
    cfg = JaxConfig(**CFG_KW, algorithm=algo)
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, rounds=ROUNDS, **DATA_KW)
    if algo == "adpsgd":
        run = {"reference": jax_engine.run_adpsgd,
               "fused": jax_fused.run_adpsgd_fused}[engine_name]
        return run(train, tx, ty, shards, cluster, cfg, rounds=ROUNDS,
                   time_budget=time_budget)
    strategy = jax_make_strategy(cfg, jax_base_topology(
        cfg.num_workers, cfg.base_topology, cfg.seed))
    run = {"reference": jax_engine.run_dfl,
           "fused": jax_fused.run_dfl_fused}[engine_name]
    return run(train, tx, ty, shards, cluster, cfg, strategy, rounds=ROUNDS,
               time_budget=time_budget,
               init_params=jax_init(cfg.seed, cfg.num_workers))


def _port(algo: str, engine_name: str, time_budget: float):
    cfg = port_config(algorithm=algo)
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        cfg, rounds=ROUNDS, device="cpu", **DATA_KW)
    init = params_from_jax(jax_init(cfg.seed, cfg.num_workers))
    if algo == "adpsgd":
        run = {"reference": engine.run_adpsgd,
               "fused": fused.run_adpsgd_fused}[engine_name]
        return run(train, tx, ty, shards, cluster, cfg, rounds=ROUNDS,
                   time_budget=time_budget, init_params=init, device="cpu")
    strategy = make_strategy(cfg, make_base_topology(
        cfg.num_workers, cfg.base_topology, cfg.seed))
    run = {"reference": engine.run_dfl,
           "fused": fused.run_dfl_fused}[engine_name]
    return run(train, tx, ty, shards, cluster, cfg, strategy, rounds=ROUNDS,
               time_budget=time_budget, init_params=init, device="cpu")


@pytest.mark.parametrize("algo", ["fedhp", "adpsgd"])
def test_time_budget_stops_every_engine_alike(algo):
    full = _jax(algo, "reference")
    budget = full.records[KEPT - 1].cumulative_time
    h_ref = _jax(algo, "reference", time_budget=budget)
    assert len(h_ref.records) == KEPT
    assert len(_jax(algo, "fused", time_budget=budget).records) == KEPT
    for engine_name in ("reference", "fused"):
        h_port = _port(algo, engine_name, budget)
        assert_parity(h_ref, h_port, KEPT)
