"""The port's sharded synchronous engines (``mesh=`` / ``cfg.sharded``) on
the CPU: the reference's grid (its ``tests/test_sharded_engine.py``) on
the port, each sharded run held to the port's unsharded run, and a few
cells held to the reference's unsharded ``run_dfl``.

``run_dfl(mesh=...)`` and ``run_dfl_fused(mesh=...)`` split the flat
[W, P] matrix into one block a shard of a ``make_worker_mesh(4,
devices=["cpu"] * 4)`` mesh: local SGD and the join blend run per block,
gossip takes the edge-list form routed by shard offset. The tolerances
are the reference's:

- host record fields (round, times, taus, links) come from the same
  control plane and must be bit-exact;
- device metrics differ only by the routed delta's summation order and
  the per-shard partial sums (about 1e-7 a round), so uncompressed runs
  meet ``DEVICE_TOL``;
- compressed runs meet ``SHARDED_COMPRESSED_TOL``: payloads are
  bit-identical per row, but int8's buckets turn the 1e-7 order noise
  into a whole quantum where a coordinate sits on a boundary (the
  reference measured 1.5e-3 accuracy over 10 rounds). FedHP is not
  paired with a codec: its integer tau and topology decisions read the
  noisy measurements, and a flipped plan would break the host fields.

The cells held to the reference (FedHP with and without churn on both
engines, D-PSGD under int8, and D-PSGD on a bf16 TINY_LM at W = 4 over 2
shards) meet the parity contract of ``tests/test_torch_engine.py``,
``tests/test_torch_codec_engine.py`` and ``tests/test_torch_bf16_engine.py``
from the reference's initialisation. The reference's own sharded engine
is not run here.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (DATA_KW, TINY_LM, assert_parity, port_config,
                           run_port, run_reference)
from repro.configs.base import FedHPConfig as JaxConfig
from repro.core.experiment import run_algorithm as jax_run_algorithm
from repro_torch.configs.base import FedHPConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import engine, experiment, fused
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.experiment import run_algorithm
from repro_torch.core.topology import make_base_topology
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.simulation.cluster import ChurnEvent, ChurnSchedule
from test_torch_bf16_engine import (CONSENSUS_RTOL, LOSS_RTOL,
                                    ROUNDS as BF16_ROUNDS, WORKERS,
                                    assert_bf16_parity, assert_rounded,
                                    bf16_adapters, reference_run)

# tier 1 runs the test files on parallel xdist workers: one core each
torch.set_num_threads(1)

CFG = FedHPConfig(num_workers=8, rounds=8, tau_init=5, tau_max=20,
                  lr=0.1, batch_size=32, seed=3, gossip="sparse")
SCHED = ChurnSchedule((
    ChurnEvent(2, "leave", 1),
    ChurnEvent(3, "crash", 6),
    ChurnEvent(4, "straggle", 2, factor=5.0, duration=3),
    ChurnEvent(6, "join", 1),
))
EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time")
DEVICE_TOL = {"accuracy": 1e-6, "loss": 1e-4, "consensus": 1e-4}
SHARDED_COMPRESSED_TOL = {"accuracy": 5e-3, "loss": 1e-2,
                          "consensus": 1e-2}
MESH = make_worker_mesh(4, devices=["cpu"] * 4)
ENGINES = pytest.mark.parametrize("fused_engine", [False, True],
                                  ids=["reference", "fused"])


def assert_equivalent(h_ref, h_shard, device_tol=DEVICE_TOL):
    assert len(h_ref.records) == len(h_shard.records)
    a, b = h_ref.as_arrays(), h_shard.as_arrays()
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, tol in device_tol.items():
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=k)


def pair(algo, *, fused_engine, churn=None, cfg=CFG, mesh=MESH):
    """``algo`` unsharded and sharded over ``mesh``, on the CPU."""
    kw = dict(DATA_KW, fused=fused_engine, churn=churn, device="cpu")
    return (run_algorithm(algo, cfg, **kw),
            run_algorithm(algo, cfg, mesh=mesh, **kw))


# ---------------------------------------------------------------------------
# sharded against the port's unsharded run
# ---------------------------------------------------------------------------

@ENGINES
@pytest.mark.parametrize("churn", [None, SCHED], ids=["nochurn", "churn"])
@pytest.mark.parametrize("algo", ["dpsgd", "ldsgd", "fedhp"])
def test_sharded_matches_unsharded(algo, churn, fused_engine):
    assert_equivalent(*pair(algo, fused_engine=fused_engine, churn=churn))


@ENGINES
@pytest.mark.parametrize("comp", ["int8", "topk:0.05", "randk:0.1"])
def test_sharded_matches_unsharded_compressed(comp, fused_engine):
    assert_equivalent(*pair("dpsgd", fused_engine=fused_engine,
                            cfg=replace(CFG, compress=comp)),
                      device_tol=SHARDED_COMPRESSED_TOL)


@ENGINES
def test_sharded_padding_w_not_divisible(fused_engine):
    """W = 10 over 4 shards: the fleet pads to 12 rows, whose inert rows
    (zero params, tau 0, no edges, zero metric weight) perturb nothing
    the host sees; the final parameters come back as the 10 real rows."""
    h_o, h_s = pair("fedhp", fused_engine=fused_engine,
                    cfg=replace(CFG, num_workers=10))
    assert_equivalent(h_o, h_s)
    for name, leaf in h_s.final_params.items():
        assert leaf.shape == h_o.final_params[name].shape, name
        assert leaf.shape[0] == 10, name


@ENGINES
def test_sharded_dense_config_uses_edge_form(fused_engine):
    """cfg.gossip="dense" still runs the edge-list transport when sharded
    (the per-edge weights are the dense matrix's off-diagonals), and
    matches the dense unsharded run."""
    assert_equivalent(*pair("dpsgd", fused_engine=fused_engine,
                            cfg=replace(CFG, gossip="dense")))


@ENGINES
def test_cfg_sharded_runs_one_cpu_shard(fused_engine):
    """``cfg.sharded=True`` without a mesh takes ``default_worker_mesh``:
    one shard on the CPU with ``device="cpu"``, the whole machinery."""
    kw = dict(DATA_KW, fused=fused_engine, churn=SCHED, device="cpu")
    assert_equivalent(run_algorithm("fedhp", CFG, **kw),
                      run_algorithm("fedhp", replace(CFG, sharded=True),
                                    **kw))


# ---------------------------------------------------------------------------
# what the sharded path refuses, as the reference refuses it
# ---------------------------------------------------------------------------

EXCLUSIONS = {
    "adpsgd": ("adpsgd", {}, {}, "AD-PSGD"),
    "pens-reference": ("pens", {}, {}, "cross-loss"),
    "pens-fused": ("pens", {}, dict(fused=True), "cross-loss"),
    "seeds": ("dpsgd", {}, dict(fused=True, seeds=[1, 2]), "seeds|lane"),
    "byzantine": ("dpsgd", dict(byzantine=(1,)), {}, "single-device"),
    "robust": ("dpsgd", dict(robust="trimmed:1"), {}, "single-device"),
    "leafmap-reference": ("dpsgd", dict(compress="leafmap:default=int8"),
                          {}, "leaf"),
    "leafmap-fused": ("dpsgd", dict(compress="leafmap:default=int8"),
                      dict(fused=True), "leaf"),
}


@pytest.mark.parametrize("case", list(EXCLUSIONS))
def test_sharded_exclusions_raise(case):
    """The port raises the reference's ``ValueError`` (the reference over
    a one-device JAX mesh, which it checks before it shards anything)."""
    algo, fields, kw, match = EXCLUSIONS[case]
    jax_kw = dict(kw)
    if "seeds" in jax_kw:
        jax_kw["seeds"] = np.asarray(jax_kw["seeds"])
    with pytest.raises(ValueError, match=match):
        jax_run_algorithm(algo, replace(JaxConfig(**_jax_fields()),
                                        **fields), rounds=1,
                          mesh=jax.make_mesh((1,), ("workers",)), **jax_kw)
    with pytest.raises(ValueError, match=match):
        run_algorithm(algo, replace(CFG, **fields), rounds=1, mesh=MESH,
                      device="cpu", **kw)


def _jax_fields() -> dict:
    return dict(num_workers=8, rounds=8, tau_init=5, tau_max=20, lr=0.1,
                batch_size=32, seed=3, gossip="sparse")


def test_adpsgd_engines_refuse_cfg_sharded():
    """The AD-PSGD engines themselves refuse ``cfg.sharded``."""
    cfg = replace(CFG, algorithm="adpsgd", sharded=True)
    args = experiment.setup_experiment(cfg, rounds=1, device="cpu")
    for run in (engine.run_adpsgd, fused.run_adpsgd_fused):
        with pytest.raises(ValueError, match="AD-PSGD"):
            run(*args, cfg, rounds=1, device="cpu")


# ---------------------------------------------------------------------------
# sharded against the reference's unsharded run_dfl
# ---------------------------------------------------------------------------

_reference_runs: dict = {}


def _reference(algo, churn, rounds, **kw):
    key = (algo, churn, rounds, tuple(sorted(kw.items())))
    if key not in _reference_runs:
        _reference_runs[key] = run_reference(algo, churn, rounds,
                                             gossip="sparse", **kw)[0]
    return _reference_runs[key]


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
@pytest.mark.parametrize("churn", [False, True], ids=["nochurn", "churn"])
def test_sharded_fedhp_matches_jax(churn, engine_name):
    """FedHP over 4 shards against the reference's unsharded ``run_dfl``
    under the parity contract: the plans match without replay."""
    h_ref = _reference("fedhp", churn, 8)
    h_port = run_port("fedhp", churn, engine_name, mesh=MESH,
                      gossip="sparse")
    assert_parity(h_ref, h_port, 8)


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
def test_sharded_int8_matches_jax(engine_name):
    """D-PSGD under int8 over 4 shards, 6 rounds, against the reference's
    unsharded run under int8's wider loss and consensus bounds."""
    h_ref = _reference("dpsgd", False, 6, compress="int8")
    h_port = run_port("dpsgd", False, engine_name, rounds=6, mesh=MESH,
                      gossip="sparse", compress="int8")
    assert_parity(h_ref, h_port, 6, int8=True)


def test_sharded_bf16_lm_matches_jax():
    """D-PSGD on the bf16 TINY_LM at W = 4 over 2 shards, both engines,
    against the reference's unsharded run under the bf16 bounds, every
    state the engines read rounded to bf16 (the flat blocks stay f32)."""
    spy = bf16_adapters()[1]
    h_ref, init = reference_run("dpsgd", WORKERS)
    mesh = make_worker_mesh(2, devices=["cpu"] * 2)
    pcfg = port_config(algorithm="dpsgd", model=TINY_LM,
                       num_workers=WORKERS)
    for run in (engine.run_dfl, fused.run_dfl_fused):
        train, tx, ty, shards, cluster = experiment.setup_experiment(
            pcfg, rounds=BF16_ROUNDS, device="cpu", **DATA_KW)
        strat = make_strategy(pcfg, make_base_topology(
            pcfg.num_workers, pcfg.base_topology, pcfg.seed))
        h_port = run(train, tx, ty, shards, cluster, pcfg, strat,
                     rounds=BF16_ROUNDS, adapter=spy,
                     init_params=params_from_jax(init), mesh=mesh,
                     device="cpu")
        assert_bf16_parity(h_ref, h_port, BF16_ROUNDS, loss_rtol=LOSS_RTOL,
                           consensus_rtol=CONSENSUS_RTOL)
    assert_rounded(spy)
