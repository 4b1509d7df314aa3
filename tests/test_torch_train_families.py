"""The trainer on the families past the dense one, against the reference
JAX package, on the CPU.

The reference runs ``launch/train.py``'s round loop in a 4-device
subprocess (``tests/_torch_train_ref.py``, case ``whisper``): the
whisper-large-v3 smoke config (the encdec family, f32), W = 4 on a
``(4, 1)`` mesh, 2 rounds, tau_max 2, S = 64 frames (8 decoder tokens),
a global batch of 8, lr 0.01. The port's loop runs from the reference's
init and batches (``frames``, ``tokens``, ``labels``). Held, with the f32
bounds of ``tests/test_torch_train.py``: every round's topology and
taus equal, the loss and the measured neighbour distances within 1e-4
relative (measured 0 and 1.2e-7; the reference's round-0 loss is
5.6253), every round's parameters within 1e-5 absolute (measured
6.0e-8).

The port budgets a training pass by ``RegistryAdapter.
activation_bytes_per_token`` (``runtime/steps.loss_and_grad``), a count
with no counterpart in the reference: it must exist, and be positive,
for every config of every family (the encdec family had none, and its
trainer raised).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_train import port_run, ref_rows, reference, rel_gap
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import modelspec
from repro_torch.launch import train as trainer

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

LOSS_RTOL = DIST_RTOL = 1e-4
PARAM_ATOL = 1e-5
ROUNDS = 2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("train_ref_whisper"),
                     "whisper")["whisper"]


@pytest.fixture(scope="module")
def whisper_run(ref):
    return port_run(ref, "run", get_smoke_config("whisper-large-v3"), ROUNDS)


def test_whisper_batches_are_encdecs(ref):
    names = {k.rsplit("/", 1)[1] for k in ref if "/batch/" in k}
    assert names == {"frames", "labels", "tokens"}


def test_whisper_plans_equal(ref, whisper_run):
    run, _ = whisper_run
    assert [r.round for r in run.rounds] == list(range(ROUNDS))
    for r in run.rounds:
        np.testing.assert_array_equal(r.adj, ref[f"run/round{r.round}/adj"])
        np.testing.assert_array_equal(r.taus, ref[f"run/round{r.round}/taus"])
    np.testing.assert_array_equal(run.adj, ref["run/final_adj"])
    np.testing.assert_array_equal(run.taus, ref["run/final_taus"])


def test_whisper_losses_and_distances(ref, whisper_run):
    run, _ = whisper_run
    for r in run.rounds:
        pre = f"run/round{r.round}"
        assert rel_gap(r.loss, ref[f"{pre}/loss"]) <= LOSS_RTOL
        assert rel_gap(r.dists, ref[f"{pre}/dists"]) <= DIST_RTOL


def test_whisper_parameters(ref, whisper_run):
    run, snaps = whisper_run
    names = [leaf.name for leaf in run.layout.leaf_offsets()]
    for r in run.rounds:
        np.testing.assert_allclose(
            snaps[r.round].numpy(),
            ref_rows(ref, f"run/round{r.round}/params", names),
            rtol=0, atol=PARAM_ATOL)


def test_cli_trains_whisper(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DEVICES", "4")
    assert trainer.main(["--arch", "whisper-large-v3", "--smoke", "--steps",
                         "2", "--workers", "4", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[1:3]] == ["round 0", "round 1"]
    assert lines[-1] == "done"


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_bytes_per_token(arch, smoke):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    adapter = modelspec.RegistryAdapter(cfg, 65, 0, f"{arch}@test")
    per_token = adapter.activation_bytes_per_token()
    assert isinstance(per_token, int)
    # at least the logits and their log-softmax, in f32
    assert per_token > 8 * cfg.vocab_size
