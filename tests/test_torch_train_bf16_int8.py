"""The trainer's round loop in bf16 under ``--compressed`` against the
reference JAX package, on the CPU.

The reference runs ``launch/train.py``'s loop with ``--compressed`` in a
4-device subprocess (``tests/_torch_train_ref.py``, case ``bf16_int8``):
the smollm-360m smoke config at ``dtype="bfloat16"`` (remat "block"), W
= 4 on a ``(4, 1)`` mesh, 3 rounds, tau_max 2, S = 64, a global batch of
8, the int8 codec a leaf with a fresh residual every round. The port's
loop runs from the reference's init and batches.

Held: every round's topology and taus equal; the loss within 2e-3
relative (measured 2.9e-5); every round's parameters hold bf16 values,
within 1e-3 relative of the reference's in norm (measured 2.2e-4), and
part from them in under 5% of the weights (measured 1.8-3.5%, rising
over the rounds: the two packages' bf16 products round differently, and
a weight an ulp away can quantize a step away) — the bounds of
``tests/test_torch_train_bf16.py``. The reference's compressed gossip
rounds each matching's term and sum to bf16 (``a + (w_m (ŷ_partner −
ŷ_i)).astype(bf16)``), and so does the port's; the control, a port whose
compressed gossip rounds its f32 mix once, parts in 5.8-9.8% of the
weights and trips the bound. The gossip alone is held bit-equal to the
reference's on bf16 leaves in ``tests/test_torch_train.py``.
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

LOSS_RTOL = 2e-3
# the parameters' relative gap in norm, and the share of weights that part
PARAM_RTOL, PARTED = 1e-3, 0.05
ROUNDS = 3


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("train_ref_bf16_int8"),
                     "bf16_int8")["bf16_int8"]


def _config():
    return dataclasses.replace(get_smoke_config("smollm-360m"),
                               dtype="bfloat16")


def _run(ref):
    return port_run(ref, "run", _config(), ROUNDS, compressed=True)


@pytest.fixture(scope="module")
def run(ref):
    return _run(ref)


def _parted(ref, layout, snaps):
    """{round: (the gap in norm, the share of weights that part)}."""
    names = [leaf.name for leaf in layout.leaf_offsets()]
    out = {}
    for h, flat in snaps.items():
        want = torch.from_numpy(ref_rows(ref, f"run/round{h}/params", names))
        gap = torch.linalg.vector_norm(flat - want) / \
            torch.linalg.vector_norm(want)
        out[h] = float(gap), float((flat != want).float().mean())
    return out


def test_plans_and_losses(ref, run):
    result, _ = run
    assert len(result.rounds) == ROUNDS
    assert all(r.dists is None for r in result.rounds)
    for r in result.rounds:
        np.testing.assert_array_equal(r.adj, ref[f"run/round{r.round}/adj"])
        np.testing.assert_array_equal(r.taus,
                                      ref[f"run/round{r.round}/taus"])
        assert rel_gap(r.loss, ref[f"run/round{r.round}/loss"]) <= LOSS_RTOL
    np.testing.assert_array_equal(result.adj, ref["run/final_adj"])
    np.testing.assert_array_equal(result.taus, ref["run/final_taus"])


def test_states_hold_bf16_values(run):
    result, snaps = run
    for flat in [*snaps.values(), result.params]:
        assert torch.equal(flat, flat.to(torch.bfloat16).float())


def test_parameters_part_in_a_few_weights(ref, run):
    result, snaps = run
    assert sorted(snaps) == list(range(ROUNDS))
    for h, (gap, parted) in _parted(ref, result.layout, snaps).items():
        assert gap <= PARAM_RTOL, (h, gap)
        assert parted < PARTED, (h, parted)


def test_one_rounding_control_trips_the_bound(ref, monkeypatch):
    mix = collectives.matching_mix

    def one_rounding(rows, weights, narrow_spans=(), centre=None):
        out = mix(rows, weights, centre=centre)    # the f32 form
        for a, b, dt in narrow_spans:
            out[:, a:b] = out[:, a:b].to(dt).float()
        return out

    monkeypatch.setattr(collectives, "matching_mix", one_rounding)
    result, snaps = _run(ref)
    parted = max(p for _, p in _parted(ref, result.layout, snaps).values())
    assert parted > PARTED, parted
