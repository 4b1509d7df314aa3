"""The trainer's round loop in bf16 and under ``--compressed`` against
the reference JAX package, on the CPU.

The reference runs ``launch/train.py``'s loop in a 4-device subprocess
(``tests/_torch_train_ref.py``): the smollm-360m smoke config at
``dtype="bfloat16"`` (remat "block"), W = 4 on a ``(4, 1)`` mesh, 4
rounds, tau_max 2, S = 64, a global batch of 8; and the f32 config with
``--compressed`` (int8 gossip, a fresh residual every round) for 3
rounds. The port's loop runs from the reference's init and batches.

bf16, held: every round's topology and taus equal; the loss within
2e-3 relative (measured 2.8e-5) and the neighbour distances within 2e-2
(measured 1.9e-3), the bounds of the bf16 engine tests
(``tests/test_torch_bf16_engine.py``): the two packages' bf16 products
round differently, so weights part by an ulp or a few (1.9-3.8% of them
here: under 5%, the parameters' gap in norm within 1e-3 relative,
measured 1.2e-4); and every state the loop holds has bf16 values. The
reference rounds each write twice on a bf16 leaf — the SGD update, then
the difference; each matching's gossip term, then the sum — and the
port does the same: the control, a port whose gossip rounds its f32 mix
once, parts from the reference's distances by 10% in round 1 and trips
the bound.

``--compressed``, held: topology and taus equal, the loss within 1e-4
relative (measured 8.6e-8), every round's parameters within one int8
quantum of their leaf (max |x| / 127; measured 1.5e-7). The residual's
bits are held to the eager oracle in ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _torch_train import port_run, ref_rows, reference, rel_gap
from repro_torch.configs import get_smoke_config
from repro_torch.runtime import collectives

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

BF16_LOSS_RTOL, BF16_DIST_RTOL = 2e-3, 2e-2
# the parameters' relative gap in norm, and the share of weights that part
BF16_PARAM_RTOL, BF16_PARTED = 1e-3, 0.05
INT8_LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("train_ref_bf16"), "bf16",
                     "int8")


def _bf16_config():
    return dataclasses.replace(get_smoke_config("smollm-360m"),
                               dtype="bfloat16")


@pytest.fixture(scope="module")
def bf16_run(ref):
    return port_run(ref["bf16"], "run", _bf16_config(), 4)


@pytest.fixture(scope="module")
def int8_run(ref):
    return port_run(ref["int8"], "run", get_smoke_config("smollm-360m"), 3,
                    compressed=True)


def _plans_equal(z, run):
    for r in run.rounds:
        np.testing.assert_array_equal(r.adj, z[f"run/round{r.round}/adj"])
        np.testing.assert_array_equal(r.taus, z[f"run/round{r.round}/taus"])
    np.testing.assert_array_equal(run.adj, z["run/final_adj"])
    np.testing.assert_array_equal(run.taus, z["run/final_taus"])


def test_bf16_plans_equal(ref, bf16_run):
    run, _ = bf16_run
    assert len(run.rounds) == 4
    _plans_equal(ref["bf16"], run)


def test_bf16_losses(ref, bf16_run):
    run, _ = bf16_run
    for r in run.rounds:
        assert rel_gap(r.loss, ref["bf16"][f"run/round{r.round}/loss"]) \
            <= BF16_LOSS_RTOL


def test_bf16_distances(ref, bf16_run):
    run, _ = bf16_run
    for r in run.rounds:
        assert rel_gap(r.dists, ref["bf16"][f"run/round{r.round}/dists"]) \
            <= BF16_DIST_RTOL


def test_bf16_states_hold_bf16_values(ref, bf16_run):
    run, snaps = bf16_run
    assert run.layout.narrow_spans() == ((0, run.layout.param_count,
                                          torch.bfloat16),)
    for flat in [*snaps.values(), run.params]:
        assert torch.equal(flat, flat.to(torch.bfloat16).float())


def test_bf16_parameters_part_in_a_few_weights(ref, bf16_run):
    run, snaps = bf16_run
    names = [leaf.name for leaf in run.layout.leaf_offsets()]
    for h, flat in snaps.items():
        want = torch.from_numpy(ref_rows(ref["bf16"], f"run/round{h}/params",
                                         names))
        gap = torch.linalg.vector_norm(flat - want) / \
            torch.linalg.vector_norm(want)
        assert float(gap) <= BF16_PARAM_RTOL
        assert float((flat != want).float().mean()) < BF16_PARTED


def test_bf16_one_rounding_control_trips_the_bound(ref, monkeypatch):
    mix = collectives.matching_mix

    def one_rounding(rows, weights, narrow_spans=(), centre=None):
        out = mix(rows, weights, centre=centre)    # the f32 form
        for a, b, dt in narrow_spans:
            out[:, a:b] = out[:, a:b].to(dt).float()
        return out

    monkeypatch.setattr(collectives, "matching_mix", one_rounding)
    run, _ = port_run(ref["bf16"], "run", _bf16_config(), 2)
    gap = rel_gap(run.rounds[1].dists, ref["bf16"]["run/round1/dists"])
    assert gap > BF16_DIST_RTOL, gap


def test_int8_plans_and_losses(ref, int8_run):
    run, _ = int8_run
    z = ref["int8"]
    assert len(run.rounds) == 3 and all(r.dists is None for r in run.rounds)
    _plans_equal(z, run)
    for r in run.rounds:
        assert rel_gap(r.loss, z[f"run/round{r.round}/loss"]) <= \
            INT8_LOSS_RTOL


def test_int8_parameters_within_a_quantum(ref, int8_run):
    run, snaps = int8_run
    z = ref["int8"]
    for h, flat in snaps.items():
        for leaf in run.layout.leaf_offsets():
            want = z[f"run/round{h}/params/{leaf.name}"].reshape(4, -1)
            got = flat[:, leaf.start:leaf.stop].numpy()
            quantum = float(np.abs(want).max()) / 127.0
            np.testing.assert_allclose(got, want, rtol=0, atol=quantum)
