"""The port's synchronous engines training a registry LM, against the
reference: FedHP.

A tiny dense LM (``_torch_parity.TINY_LM``: d 32, 2 layers, 2 query
heads over 1 KV head, d_ff 32, vocabulary 32, sequences of 12 tokens)
trains at W = 8 for 5 rounds through the reference JAX
``engine.run_dfl`` and the port's ``run_dfl`` and ``run_dfl_fused`` on
the CPU, from the same seeds and the reference's initialisation
(``convert.params_from_jax``): FedHP with and without churn here;
D-PSGD with and without churn, under ``gossip="sparse"`` and under
``robust="median"``, and AD-PSGD in
``tests/test_torch_registry_scenarios.py``.

The model's size is chosen where the reference's own trajectory is
stable: at d 16 with sequences of 8 tokens a 1e-7 relative perturbation
of the reference's initialisation passes 1e-2 of its parameters within
5 D-PSGD rounds, so the two packages' float noise alone would decide
the comparison there; at this size it stays below 1e-3 (both checked in
``tests/test_torch_registry.py``). The measurement stack (every
worker evaluated on all W x 256 eval sequences) makes a FedHP round
cost seconds of one core in each package, so this file holds the FedHP
cases alone.

Both packages run the model's spec path, ``use_flash_kernel`` off: the
reference's attention is its plain jnp composition (the one its flash
kernel's backward recomputes through), the port's its plain version.
The flash path is held against the reference's Pallas kernel in
``tests/test_torch_registry.py``.

Tolerances are the parity contract of ``tests/test_torch_engine.py``:
host fields exactly equal (FedHP's plans match without replay), accuracy
within 1/512, loss and consensus within 1e-4 relative, consensus also
within 1e-6 absolute (on FedHP's complete-graph rounds the fleet sits at
exact consensus and both packages read f32 noise there).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import (DATA_KW, TINY_LM, assert_parity, port_config,
                           run_port, run_reference)
from repro_torch.core import engine, modelspec
from repro_torch.core.experiment import setup_experiment

ROUNDS = 5


@pytest.mark.parametrize("churn", [False, True], ids=["nochurn", "churn"])
def test_fedhp_engines_match_reference(churn):
    h_ref, _ = run_reference("fedhp", churn, ROUNDS, model=TINY_LM)
    for engine_name in ("reference", "fused"):
        h_port = run_port("fedhp", churn, engine_name, rounds=ROUNDS,
                          model=TINY_LM)
        assert_parity(h_ref, h_port, ROUNDS)
    adapter = modelspec.get_adapter(TINY_LM)
    final = h_port.final_params
    assert sorted(final) == [l.name for l in adapter.leaf_offsets()]
    for l in adapter.leaf_offsets():
        assert tuple(final[l.name].shape) == (8,) + l.shape


def test_setup_experiment_builds_the_token_corpus():
    cfg = port_config(model=TINY_LM)
    train, tx, ty, shards, cluster = setup_experiment(cfg, device="cpu",
                                                      **DATA_KW)
    adapter = modelspec.get_adapter(TINY_LM)
    assert train.x.shape[1:] == (12,) and train.x.dtype == np.int32
    assert tx.dtype == torch.int32 and tuple(tx.shape[1:]) == (12,)
    assert int(tx.max()) < 32 and len(shards) == cfg.num_workers
    assert cluster.model_bits == 32 * adapter.param_count


def test_gradient_groups_give_each_worker_its_own_gradient(monkeypatch):
    """A fleet computed in groups of workers (``workers_per_pass``) has
    the same per-worker losses and gradients as one pass."""
    adapter = modelspec.get_adapter(TINY_LM)
    gen = torch.Generator().manual_seed(0)
    flat = adapter.flatten({k: v.expand(4, *v.shape).clone()
                            for k, v in adapter.init(gen).items()})
    flat = flat + 0.01 * torch.randn(flat.shape, generator=gen)
    x = torch.randint(0, 32, (4, 6, 12), generator=gen, dtype=torch.int32)
    y = torch.zeros(4, 6, dtype=torch.long)
    whole = engine._loss_and_grad(adapter, flat, x, y)
    monkeypatch.setattr(type(adapter), "workers_per_pass",
                        lambda self, xx: 3)
    parts = engine._loss_and_grad(adapter, flat, x, y)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_workers_per_pass_keeps_a_pass_within_budget():
    """At the smollm-360m width of the card's run (4 layers, vocabulary
    6,144, S = 16) the measurement stack runs 2 workers a pass, a local
    SGD step the whole fleet."""
    from repro_torch.configs import smollm_360m
    from dataclasses import replace
    cfg = replace(smollm_360m.CONFIG, num_layers=4, vocab_size=6144,
                  dtype="float32", remat="none")
    adapter = modelspec.RegistryAdapter(cfg, 16, 8, "smollm-4l")
    assert adapter.param_count == 45_228_480
    stack = torch.zeros(8, 1, dtype=torch.int32).expand(8, 8 * 256 * 16)
    assert adapter.workers_per_pass(stack.view(8, 8, 256, 16)) == 2
    batch = torch.zeros(8, 32, 16, dtype=torch.int32)
    assert adapter.workers_per_pass(batch) == 8
