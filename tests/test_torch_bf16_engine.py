"""The port's synchronous engines training a bf16 registry LM, against
the reference: ``_torch_parity.TINY_LM`` with ``dtype="bfloat16"``
through the reference JAX ``engine.run_dfl`` and the port's
``run_dfl`` and ``run_dfl_fused`` on the CPU, from the reference's bf16
initialisation: D-PSGD for 3 rounds at W = 4 here, FedHP for 3 at
W = 8 in
``tests/test_torch_bf16_fedhp.py`` (its plans match the reference's
without replay there; at W = 4 a measurement's bf16 difference turns
one round's tau decision), and AD-PSGD at W = 4 in
``tests/test_torch_bf16_adpsgd.py``.

Host record fields are exactly equal and the final leaves come back in
bf16. Every state the engines hand the model holds bf16 values in the
bf16 leaves' columns (``RoundingSpy``). The device metrics cannot meet
the f32 parity contract: both packages round every weight to bf16 after
each SGD step and gossip, but their bf16 gradients differ by about 1%
(``tests/test_torch_bf16.py``: XLA on the CPU keeps f32 through fused
elementwise chains, torch rounds each op), so weights part by a bf16 ulp
wherever a step lands near a rounding boundary. Bounds: accuracy 1/512
absolute (one eval sample, as in f32), loss 2e-3 and consensus 2e-2
relative, about 3x the measured worst (D-PSGD 6.3e-4 / 6.5e-3, FedHP
2.7e-4 / 3.7e-3). A control holds them to account: the fused engine with
its rounding taken out (``round_leaves`` the identity) trains on
unrounded weights, which the spy counts, and parts from the reference by
6.4e-2 in consensus, past the bound (its loss, 7.7e-4, is not: the bf16
gradients' own scatter sets the loss gap, so consensus is the metric
that separates a run that rounds from one that does not).
"""
from __future__ import annotations

import functools
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (ACC_ATOL, CFG_KW, DATA_KW, EXACT, TINY_LM,
                           JaxConfig, RecordingStrategy, jax_base_topology,
                           jax_engine, jax_experiment, jax_make_strategy,
                           jax_modelspec, port_config, worst_diffs)
from repro_torch.convert import params_from_jax
from repro_torch.core import engine, experiment, fused, modelspec
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.topology import make_base_topology

ROUNDS = 3
WORKERS = 4
LOSS_RTOL = 2e-3
CONSENSUS_RTOL = 2e-2


class RoundingSpy(modelspec.RegistryAdapter):
    """The port's registry adapter, counting the states the engines hand
    the model (``views``, and ``unflatten`` at the end) and, in them, the
    entries of bf16 leaves that are not bf16 values: an engine that
    leaves a write unrounded shows here whether or not the metrics'
    bounds admit it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.reads = self.unrounded = 0

    def _record(self, flat: torch.Tensor) -> None:
        with torch.no_grad():
            for start, stop, dtype in self.narrow_spans():
                cols = flat[..., start:stop]
                self.unrounded += int((cols != cols.to(dtype).float()).sum())
        self.reads += 1

    def views(self, flat):
        self._record(flat)
        return super().views(flat)

    def unflatten(self, flat):
        self._record(flat)
        return super().unflatten(flat)


def bf16_adapters():
    """The reference's and the port's adapters of TINY_LM in bf16 (the
    port's a ``RoundingSpy``)."""
    jad, tad = jax_modelspec.get_adapter(TINY_LM), \
        modelspec.get_adapter(TINY_LM)
    return (jax_modelspec.RegistryAdapter(replace(jad.cfg, dtype="bfloat16"),
                                          jad.seq_len, jad.num_classes,
                                          "tiny-bf16"),
            RoundingSpy(replace(tad.cfg, dtype="bfloat16"), tad.seq_len,
                        tad.num_classes, "tiny-bf16"))


def unrounded(adapter: RoundingSpy) -> RoundingSpy:
    """``adapter`` with its rounding taken out: the control run."""
    adapter.round_leaves = lambda flat: flat
    return adapter


def bf16_init(jad, num_workers: int, seed: int):
    """The reference adapter's bf16 init, broadcast to the fleet."""
    p0 = jad.init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda v: np.broadcast_to(
        np.asarray(v), (num_workers,) + v.shape), p0)


def assert_bf16_parity(h_ref, h_port, rounds: int, *, loss_rtol: float,
                       consensus_rtol: float) -> dict:
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    assert len(h_ref.records) == len(h_port.records) == rounds
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(b["accuracy"], a["accuracy"], rtol=0,
                               atol=ACC_ATOL, err_msg="accuracy")
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=loss_rtol,
                               err_msg="loss")
    np.testing.assert_allclose(b["consensus"], a["consensus"],
                               rtol=consensus_rtol, atol=1e-6,
                               err_msg="consensus")
    for name, leaf in h_port.final_params.items():
        assert leaf.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(leaf.float()).all()), name
    return worst_diffs(a, b)


def assert_rounded(adapter: RoundingSpy) -> None:
    """Every state ``adapter`` was handed held bf16 values."""
    assert adapter.reads > 0 and adapter.unrounded == 0, \
        (adapter.reads, adapter.unrounded)


@functools.lru_cache(maxsize=None)
def reference_run(algo: str, workers: int):
    """``algo`` through the reference's ``run_dfl`` on the bf16 TINY_LM
    at W = ``workers`` -> (its history, its bf16 initialisation); kept
    for the control, which runs against the same history."""
    jad = bf16_adapters()[0]
    cfg = JaxConfig(**{**CFG_KW, "num_workers": workers}, algorithm=algo,
                    model=TINY_LM)
    init = bf16_init(jad, cfg.num_workers, cfg.seed)
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, rounds=ROUNDS, **DATA_KW)
    strategy = RecordingStrategy(jax_make_strategy(cfg, jax_base_topology(
        cfg.num_workers, cfg.base_topology, cfg.seed)))
    h_ref = jax_engine.run_dfl(train, tx, ty, shards, cluster, cfg,
                               strategy, rounds=ROUNDS, adapter=jad,
                               init_params=init)
    assert {str(l.dtype) for l in jax.tree.leaves(h_ref.final_params)} \
        == {"bfloat16"}
    return h_ref, init


def port_runs(algo: str, workers: int, adapter, runs, init) -> list:
    """``algo`` through each of the port's ``runs`` on ``adapter`` from
    the reference's ``init``."""
    pcfg = port_config(algorithm=algo, model=TINY_LM, num_workers=workers)
    hists = []
    for run in runs:
        train, tx, ty, shards, cluster = experiment.setup_experiment(
            pcfg, rounds=ROUNDS, device="cpu", **DATA_KW)
        strat = make_strategy(pcfg, make_base_topology(
            pcfg.num_workers, pcfg.base_topology, pcfg.seed))
        hists.append(run(train, tx, ty, shards, cluster, pcfg, strat,
                         rounds=ROUNDS, adapter=adapter,
                         init_params=params_from_jax(init), device="cpu"))
    return hists


def check_sync_engines(algo: str, workers: int) -> None:
    """``algo`` through the reference and both port engines, held to the
    bounds above, every state the port's engines read rounded."""
    spy = bf16_adapters()[1]
    h_ref, init = reference_run(algo, workers)
    for h_port in port_runs(algo, workers, spy,
                            (engine.run_dfl, fused.run_dfl_fused), init):
        print(algo, assert_bf16_parity(h_ref, h_port, ROUNDS,
                                       loss_rtol=LOSS_RTOL,
                                       consensus_rtol=CONSENSUS_RTOL))
    assert_rounded(spy)


def test_dpsgd_engines_match_reference_in_bf16():
    check_sync_engines("dpsgd", WORKERS)


def test_dpsgd_without_rounding_fails_the_bounds():
    """The control: the fused engine with ``round_leaves`` the identity
    reads unrounded weights and parts from the reference past the
    consensus bound."""
    spy = unrounded(bf16_adapters()[1])
    h_ref, init = reference_run("dpsgd", WORKERS)
    (h_ctrl,) = port_runs("dpsgd", WORKERS, spy, (fused.run_dfl_fused,),
                          init)
    assert spy.unrounded > 0
    with pytest.raises(AssertionError, match="consensus"):
        assert_bf16_parity(h_ref, h_ctrl, ROUNDS, loss_rtol=LOSS_RTOL,
                           consensus_rtol=CONSENSUS_RTOL)
