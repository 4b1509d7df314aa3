"""The fused engines' batched ``seeds=`` axis: S experiments as lanes of
one run.

- The port's batched lanes against its own single-lane runs
  (``seeds=[s]``), as the reference's ``tests/test_fused_equivalence.py``
  holds its vmapped lanes: host record fields (and screening's rejection
  counts) exactly equal, device metrics within 1e-5 — for D-PSGD
  uncompressed, under int8, under top-k over sparse gossip, under
  ``robust="median"`` with attackers and under a leafmap, LD-SGD over
  sparse gossip, and AD-PSGD uncompressed and under ``screen:8``; and
  with churn (a join re-initialises rows from each lane's own fleet and
  resets its codec state): D-PSGD under int8 and under top-k, and
  AD-PSGD. On the
  CPU every lane comes out bit-equal: each lane's rows go through the
  same operations, in the same order, as its single run's (the model
  passes take the S·W workers at once, the codec kernels the lanes as
  rows, ``gossip_edges`` and ``robust_gossip`` the block-diagonal fleet,
  ``gossip_mix`` its lane-strided form).
- The lane whose seed is ``cfg.seed`` reproduces the unbatched run, and
  distinct seeds give distinct trajectories over a shared host control
  plane.
- The reference's batched lanes (``repro.core.fused.run_dfl_fused`` /
  ``run_adpsgd_fused`` with ``seeds``) against the port's single-lane
  runs started from the reference's init of each lane's seed (an adapter
  whose ``init`` returns it): the parity contract of
  ``tests/test_torch_engine.py``.
- The refusal matrix: what the reference refuses (an adaptive strategy
  with more than one seed, ``init_params`` with seeds, a mesh with seeds,
  seeds without ``fused=True``), the port refuses with the same
  exception type.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CFG_KW, DATA_KW, EXACT, JaxConfig, assert_parity,
                           jax_experiment, jax_init, port_config,
                           torch_churn)
from repro_torch.convert import params_from_jax
from repro_torch.core import experiment, fused, modelspec
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.experiment import run_algorithm
from repro_torch.core.topology import make_base_topology

ROUNDS = 4
# the churn schedule's join lands in round 6
CHURN_ROUNDS = 8
LANE_TOL = 1e-5
SEEDS = (3, 11, 12)          # 3 is port_config()'s seed
BYZ = dict(byzantine=(0, 5), byzantine_attack="signflip")

# id -> (algorithm, config fields)
CASES = {
    "dpsgd": ("dpsgd", {}),
    "dpsgd-int8": ("dpsgd", dict(compress="int8")),
    "dpsgd-sparse-topk": ("dpsgd", dict(gossip="sparse",
                                        compress="topk:0.1")),
    "dpsgd-median": ("dpsgd", dict(BYZ, robust="median")),
    "dpsgd-leafmap": ("dpsgd", dict(
        compress="leafmap:w1=topk:0.1,b=randk:0.5,default=int8")),
    "ldsgd-sparse": ("ldsgd", dict(gossip="sparse")),
    "adpsgd": ("adpsgd", {}),
    "adpsgd-screen": ("adpsgd", dict(BYZ, robust="screen:8")),
    "dpsgd-int8-churn": ("dpsgd", dict(compress="int8", churn=True)),
    "dpsgd-topk-churn": ("dpsgd", dict(compress="topk:0.1", churn=True)),
    "adpsgd-churn": ("adpsgd", dict(churn=True)),
}


def _run(algo, fields, **kw):
    """A fused run on the CPU; ``fields`` are config fields, and
    ``churn=True`` among them runs the shared churn schedule."""
    fields = dict(fields)
    churn = fields.pop("churn", False)
    return run_algorithm(algo, port_config(**fields),
                         rounds=CHURN_ROUNDS if churn else ROUNDS,
                         churn=torch_churn(churn), fused=True, device="cpu",
                         **DATA_KW, **kw)


def _assert_lane(hv, hi, tol: float = LANE_TOL) -> None:
    a, b = hv.as_arrays(), hi.as_arrays()
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("accuracy", "loss", "consensus"):
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=k)
    assert hv.screen_rejects == hi.screen_rejects
    for name, leaf in hv.final_params.items():
        assert bool(torch.isfinite(leaf).all()), name


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_match_single_lane_runs(case):
    algo, fields = CASES[case]
    batched = _run(algo, fields, seeds=SEEDS)
    assert isinstance(batched, list) and len(batched) == len(SEEDS)
    for s, hv in zip(SEEDS, batched):
        (hi,) = _run(algo, fields, seeds=[s])
        _assert_lane(hv, hi)
    # the cfg.seed lane is the unbatched run
    _assert_lane(batched[0], _run(algo, fields))
    if "screen" in case:
        assert sum(batched[0].screen_rejects) > 0
    # distinct lanes, one shared host control plane
    a, b = batched[1].as_arrays(), batched[2].as_arrays()
    assert not np.array_equal(a["loss"], b["loss"])
    np.testing.assert_array_equal(a["cumulative_time"], b["cumulative_time"])


class _JaxInitMlp(modelspec.MlpAdapter):
    """The port's MLP whose ``init`` returns the reference's
    ``adapter.init(PRNGKey(seed))`` for the seed its generator was
    seeded with — so a port lane starts where the reference's lane of
    that seed does."""

    def init(self, generator):
        p0 = jax_init(generator.initial_seed(), 1)
        return {k: v[0] for k, v in params_from_jax(p0).items()}


def _port_single_lane(algo: str, cfg, seed: int):
    """The port's fused run of one lane of ``seed`` from the reference's
    init (the unbatched run where seed is cfg.seed)."""
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        cfg, rounds=ROUNDS, device="cpu", **DATA_KW)
    adapter = _JaxInitMlp(32, 64, 10)
    kw = dict(rounds=ROUNDS, adapter=adapter, device="cpu")
    if seed == cfg.seed:
        kw["init_params"] = params_from_jax(jax_init(seed, cfg.num_workers))
    else:
        kw["seeds"] = [seed]
    if algo == "adpsgd":
        out = fused.run_adpsgd_fused(train, tx, ty, shards, cluster, cfg,
                                     **kw)
    else:
        strategy = make_strategy(cfg, make_base_topology(
            cfg.num_workers, cfg.base_topology, cfg.seed))
        out = fused.run_dfl_fused(train, tx, ty, shards, cluster, cfg,
                                  strategy, **kw)
    return out if seed == cfg.seed else out[0]


@pytest.mark.parametrize("algo,fields", [("dpsgd", {}),
                                         ("dpsgd", dict(compress="topk:0.1")),
                                         ("adpsgd", {})],
                         ids=["dpsgd", "dpsgd-topk", "adpsgd"])
def test_reference_lanes_match_port_single_lanes(algo, fields):
    seeds = (3, 11)
    jcfg = JaxConfig(**{**CFG_KW, **fields}, algorithm=algo)
    lanes = jax_experiment.run_algorithm(algo, jcfg, rounds=ROUNDS,
                                         fused=True, seeds=jnp.asarray(seeds),
                                         **DATA_KW)
    cfg = port_config(algorithm=algo, **fields)
    for s, h_ref in zip(seeds, lanes):
        assert_parity(h_ref, _port_single_lane(algo, cfg, s), ROUNDS)


def _jax_call(algo, seeds=None, *, mesh: bool = False, **kw):
    cfg = JaxConfig(**CFG_KW, algorithm=algo)

    def call():
        if mesh:
            kw["mesh"] = jax.make_mesh((1,), ("workers",))
        jax_experiment.run_algorithm(algo, cfg, rounds=2, seeds=seeds, **kw)
    return call


def _port_call(algo, seeds=None, **kw):
    return lambda: run_algorithm(algo, port_config(), rounds=2, seeds=seeds,
                                 device="cpu", **kw)


def _port_init_params_call(algo):
    cfg = port_config(algorithm=algo)

    def call():
        train, tx, ty, shards, cluster = experiment.setup_experiment(
            cfg, device="cpu")
        init = params_from_jax(jax_init(cfg.seed, cfg.num_workers))
        if algo == "adpsgd":
            fused.run_adpsgd_fused(train, tx, ty, shards, cluster, cfg,
                                   rounds=2, seeds=[1, 2],
                                   init_params=init, device="cpu")
        else:
            fused.run_dfl_fused(train, tx, ty, shards, cluster, cfg,
                                make_strategy(cfg, make_base_topology(
                                    cfg.num_workers, "full", cfg.seed)),
                                rounds=2, seeds=[1, 2], init_params=init,
                                device="cpu")
    return call


def _jax_init_params_call():
    from repro.core import fused as jax_fused
    from repro.core.algorithms import make_strategy as jax_make_strategy
    from repro.core.topology import make_base_topology as jax_base
    cfg = JaxConfig(**CFG_KW, algorithm="dpsgd")

    def call():
        train, tx, ty, shards, cluster = jax_experiment.setup_experiment(cfg)
        jax_fused.run_dfl_fused(
            train, tx, ty, shards, cluster, cfg,
            jax_make_strategy(cfg, jax_base(cfg.num_workers, "full",
                                            cfg.seed)),
            rounds=2, seeds=jnp.asarray([1, 2]),
            init_params=jax_init(cfg.seed, cfg.num_workers))
    return call


REFUSALS = {
    "fedhp-two-seeds": (_jax_call("fedhp", jnp.asarray([1, 2]), fused=True),
                        _port_call("fedhp", [1, 2], fused=True), "adapts"),
    "pens-two-seeds": (_jax_call("pens", jnp.asarray([1, 2]), fused=True),
                       _port_call("pens", [1, 2], fused=True), "adapts"),
    "seeds-without-fused": (_jax_call("dpsgd", jnp.asarray([1, 2])),
                            _port_call("dpsgd", [1, 2]), "fused=True"),
    "init-params-with-seeds": (_jax_init_params_call(),
                               _port_init_params_call("dpsgd"),
                               "init_params"),
    "mesh-with-seeds": (_jax_call("dpsgd", jnp.asarray([1, 2]), fused=True,
                                  mesh=True),
                        _port_call("dpsgd", [1, 2], fused=True,
                                   mesh=object()), "one lane"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_the_reference(case):
    jax_call, port_call, match = REFUSALS[case]
    with pytest.raises(Exception) as jax_err:
        jax_call()
    with pytest.raises(type(jax_err.value), match=match):
        port_call()


def test_adpsgd_init_params_with_seeds_is_refused():
    """The reference's ``run_adpsgd_fused`` takes no ``init_params``;
    the port's does, and refuses it with seeds as ``run_dfl_fused``
    does."""
    with pytest.raises(ValueError, match="init_params"):
        _port_init_params_call("adpsgd")()


def test_one_seed_of_an_adaptive_strategy_runs():
    """An adaptive strategy takes a batch of one lane, as the reference
    does: its plan is that lane's feedback."""
    (h,) = _run("fedhp", {}, seeds=[3])
    _assert_lane(h, _run("fedhp", {}))
    assert len(h.records) == ROUNDS


def test_lane_csr_and_table_are_block_diagonal():
    csr = (np.array([0, 1, 3, 3], np.int32), np.array([2, 0, 2], np.int32),
           np.array([0.5, 0.25, 0.25], np.float32))
    rp, col, w = fused.lane_csr(csr, 2, 3)
    np.testing.assert_array_equal(rp, [0, 1, 3, 3, 4, 6, 6])
    np.testing.assert_array_equal(col, [2, 0, 2, 5, 3, 5])
    np.testing.assert_array_equal(w, np.tile(csr[2], 2))
    assert fused.lane_csr(csr, 1, 3) is csr
    nbr, deg = fused.lane_table(np.array([[1, 2], [0, 0], [0, 1]]),
                                np.array([2, 1, 2]), 2)
    np.testing.assert_array_equal(nbr[3:], [[4, 5], [3, 3], [3, 4]])
    np.testing.assert_array_equal(deg, [2, 1, 2, 2, 1, 2])
