"""The port's two AD-PSGD engines training a bf16 registry LM, against
the reference's ``engine.run_adpsgd``: ``TINY_LM`` in bf16 at W = 4 for
3 rounds (4 events a round) from the reference's bf16 initialisation, on
the CPU.

Host record fields (the event schedule, staleness, clock) are exactly
equal, the final leaves come back in bf16, and the port's two engines
agree with each other within 1e-6 (they run the same rounding steps).
Against the reference the bounds are wider than the synchronous
engines' (``tests/test_torch_bf16_engine.py``): the port rounds at each
of the reference's bf16 operations — the stale delta, the delta applied
to the live row, the pairwise average — while XLA on the CPU fuses an
event's bf16 arithmetic and keeps f32 between those steps, so the two
part by a bf16 ulp at each event as well as through the gradients.
Bounds: accuracy 1/512, loss 5e-3 and consensus 5e-2 relative, about 3.5x
and 4x the measured worst (1.4e-3 / 1.2e-2 at W = 8, 4.3e-4 / 1.1e-2
here). Those bounds do not separate a run that skips the rounding: the
control (the fused engine with ``round_leaves`` the identity) parts from
the reference by 6.5e-4 in loss and 2.0e-2 in consensus. What holds the
rounding here is ``RoundingSpy``: every state the engines hand the model
holds bf16 values, and the control's do not.
"""
from __future__ import annotations

import numpy as np
import torch

from _torch_parity import (CFG_KW, DATA_KW, TINY_LM, JaxConfig, jax_engine,
                           jax_experiment, port_config, worst_diffs)
from test_torch_bf16_engine import (ROUNDS, WORKERS, assert_bf16_parity,
                                    assert_rounded, bf16_adapters, bf16_init,
                                    unrounded)
from repro_torch.convert import params_from_jax
from repro_torch.core import engine, experiment, fused

LOSS_RTOL = 5e-3
CONSENSUS_RTOL = 5e-2


def test_adpsgd_engines_match_reference_in_bf16():
    jad, tad = bf16_adapters()
    cfg = JaxConfig(**{**CFG_KW, "num_workers": WORKERS},
                    algorithm="adpsgd", model=TINY_LM)
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, rounds=ROUNDS, **DATA_KW)
    h_ref = jax_engine.run_adpsgd(train, tx, ty, shards, cluster, cfg,
                                  rounds=ROUNDS, adapter=jad)
    init = params_from_jax(bf16_init(jad, cfg.num_workers, cfg.seed))
    pcfg = port_config(algorithm="adpsgd", model=TINY_LM,
                       num_workers=WORKERS)
    hists = []
    for run in (engine.run_adpsgd, fused.run_adpsgd_fused):
        train, tx, ty, shards, cluster = experiment.setup_experiment(
            pcfg, rounds=ROUNDS, device="cpu", **DATA_KW)
        hists.append(run(train, tx, ty, shards, cluster, pcfg,
                         rounds=ROUNDS, adapter=tad, init_params=init,
                         device="cpu"))
        print(run.__name__, assert_bf16_parity(
            h_ref, hists[-1], ROUNDS, loss_rtol=LOSS_RTOL,
            consensus_rtol=CONSENSUS_RTOL))
    assert_rounded(tad)
    # the control: the spy sees the unrounded weights
    ctrl = unrounded(bf16_adapters()[1])
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        pcfg, rounds=ROUNDS, device="cpu", **DATA_KW)
    fused.run_adpsgd_fused(train, tx, ty, shards, cluster, pcfg,
                           rounds=ROUNDS, adapter=ctrl, init_params=init,
                           device="cpu")
    assert ctrl.unrounded > 0
    gaps = worst_diffs(*(h.as_arrays() for h in hists))
    assert gaps["accuracy"] <= 1e-6 and gaps["loss"] <= 1e-6 \
        and gaps["consensus"] <= 1e-6, gaps
    for k, v in hists[0].final_params.items():
        assert torch.allclose(v.float(), hists[1].final_params[k].float(),
                              rtol=2.0 ** -7, atol=0), k
    assert np.isfinite(hists[1].as_arrays()["loss"]).all()
