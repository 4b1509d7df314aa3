"""The trainer on the families past the dense one, against the reference
JAX package, on the CPU.

The reference runs ``launch/train.py``'s round loop in one 4-device
subprocess (``tests/_torch_train_ref.py``, cases ``whisper``, ``moe``,
``hybrid``, ``xlstm`` and ``vlm``): the smoke configs of
whisper-large-v3 (encdec: ``frames``, ``tokens``, ``labels``),
olmoe-1b-7b (moe), zamba2-7b (hybrid), xlstm-1.3b (xlstm) and
qwen2-vl-2b (vlm: ``vision_embeds`` and ``mrope_positions`` besides the
tokens), f32, W = 4 on a ``(4, 1)`` mesh, 2 rounds, tau_max 2, S = 64, a
global batch of 8. The port's loop runs from the reference's init and
batches at the reference's lr. Held, with the f32 bounds of
``tests/test_torch_train.py``: every round's topology and taus equal,
the loss and the measured neighbour distances within 1e-4 relative,
every round's parameters within 1e-5 absolute. Measured (loss /
distances / parameters, worst round; ``tests/_torch_train_gaps.py``):
whisper 8.5e-8 / 2.3e-7 / 6.0e-8, moe 0 / 1.7e-7 / 1.2e-7, hybrid 1.7e-7
/ 4.3e-6 / 2.7e-7, xlstm 1.7e-7 / 3.3e-7 / 3.3e-7, vlm 0 / 2.1e-7 /
6.0e-8.

The lr: 0.01 (the trainer tests') but for zamba2-7b, 0.002. ROADMAP.md
queue 3 finds these families chaotic at the registry tests' settings, in
the reference too, so each rate is one where the reference's own
trajectory is quiet: run from its init moved one f32 ulp a weight
(``tests/_torch_train_ref.py``'s ``FAMILY:nudge``), it parts from
itself after 2 rounds by at most 8.3e-8 / 1.1e-7 / 3.6e-7 (moe), 0 /
4.0e-7 / 7.2e-7 (xlstm), 8.6e-8 / 7.2e-8 / 1.2e-7 (vlm) and 8.3e-8 /
3.2e-6 / 3.6e-7 (zamba2-7b at 0.002) in loss / distances / parameters.
At 0.01 (``hybrid@0.01``) zamba2-7b's smoke config parts from itself by
7.4e-6 / 6.4e-4 / 1.6e-4, past the parameter bound, and the port parts
from it by 5.8e-7 / 2.5e-4 / 2.5e-5, no farther than the nudge: the
trajectory amplifies last-ulp differences there, not a fault.

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

from _torch_train import SHAPE, port_run, ref_rows, reference, rel_gap
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import modelspec
from repro_torch.launch import train as trainer
from repro_torch.models import registry

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

LOSS_RTOL = DIST_RTOL = 1e-4
PARAM_ATOL = 1e-5
ROUNDS = 2


# case of tests/_torch_train_ref.py -> the smoke config's arch
FAMILIES = {"whisper": "whisper-large-v3", "moe": "olmoe-1b-7b",
            "hybrid": "zamba2-7b", "xlstm": "xlstm-1.3b",
            "vlm": "qwen2-vl-2b"}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("train_ref_families"),
                     *FAMILIES)


@pytest.fixture(scope="module")
def runs(refs):
    return {}


@pytest.fixture(params=list(FAMILIES))
def family(request, refs, runs):
    """(family, the reference's run, the port's (TrainRun, snapshots)
    from its init and batches at its lr)."""
    name = request.param
    ref = refs[name]
    if name not in runs:
        runs[name] = port_run(ref, "run", get_smoke_config(FAMILIES[name]),
                              ROUNDS, lr=float(ref["run/base_lr"]))
    return name, ref, runs[name]


def test_batches_are_the_familys(family):
    name, ref, _ = family
    names = {k.rsplit("/", 1)[1] for k in ref if "/batch/" in k}
    want = set(registry.batch_shapes(get_smoke_config(FAMILIES[name]),
                                     SHAPE))
    assert names == want
    if name == "whisper":
        assert names == {"frames", "labels", "tokens"}
    if name == "vlm":
        assert {"vision_embeds", "mrope_positions"} <= names


def test_plans_equal(family):
    _, ref, (run, _) = family
    assert [r.round for r in run.rounds] == list(range(ROUNDS))
    for r in run.rounds:
        np.testing.assert_array_equal(r.adj, ref[f"run/round{r.round}/adj"])
        np.testing.assert_array_equal(r.taus, ref[f"run/round{r.round}/taus"])
    np.testing.assert_array_equal(run.adj, ref["run/final_adj"])
    np.testing.assert_array_equal(run.taus, ref["run/final_taus"])


def test_losses_and_distances(family):
    _, ref, (run, _) = family
    for r in run.rounds:
        pre = f"run/round{r.round}"
        assert rel_gap(r.loss, ref[f"{pre}/loss"]) <= LOSS_RTOL
        assert rel_gap(r.dists, ref[f"{pre}/dists"]) <= DIST_RTOL


def test_parameters(family):
    _, ref, (run, snaps) = family
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
