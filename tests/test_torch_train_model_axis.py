"""The trainer over a model axis — a DFL worker's replica over the slots
of the mesh's ``model`` axis (``runtime/sharding``'s spec rules executed
by ``runtime/steps``, ``models/dense.loss_fn_pieces``,
``core/modelspec.SlotAdapter``) — against the reference JAX package, on
the CPU.

The reference runs ``launch/train.py``'s round loop on a ``(2, 2)``
``("data", "model")`` mesh of 4 host devices (``tests/_torch_train_ref.py``,
cases ``model_dp``, ``model_tp`` and ``model_tp_kv1``): W = 2 workers,
f32, 2 rounds, tau_max 2, S = 64, a global batch of 8, on smollm-360m's
smoke config (``within_worker="dp"``: each slot holds the whole replica
and takes 2 of its worker's 4 sequences), internlm2-20b's (``"tp"``:
wq / wk / wv / w_up / w_gate column-split, wo / w_down row-split, the
embedding and head split over the vocabulary) and internlm2-20b's with
one kv head (the rule replicates wk / wv on every slot). The port's
loop runs from the reference's init and batches on 4 CPU slots of one
mesh. Held, with PERF.md §2's f32 trainer bounds:

- every round's topology and taus equal;
- the loss and the measured distances within 1e-4 relative (measured
  1.7e-7 and 2.7e-7), the parameters, the slots' pieces joined, within
  1e-5 absolute (measured 6.0e-8);
- each slot's pieces have the shapes ``param_spec`` gives them on the
  mesh (a dim over its axes' slots), and the port's own layout
  (``convert.slot_pieces``) cuts the reference's init into them;
- the reference sums each matching's squared distance over the model
  axis (``src/repro/runtime/collectives.py:96``), a leaf held whole by
  every slot once a slot, so a dp replica's distance is sqrt(2) times
  the worker's: the reference's own measure on this config, round 0 from
  one init, is 0.0267692 on a (2, 1) mesh against 0.0378573 on (2, 2).
  The port's dp distances at (2, 2) are sqrt(2) times its (2, 1) ones
  within 1e-6 relative;
- under ``--compressed`` (``model_tp_int8``, the reference's loop with
  the int8 codec a leaf shard) each slot codes its own pieces: the
  parameters within one int8 quantum of the reference's, where coding
  whole leaves (the control) parts by more;
- a checkpoint the port saves at (2, 2) holds whole worker-stacked
  leaves (the reference's format: its round 0 within 1e-5) and resumes
  at (2, 1) into the trajectory it resumes into at (2, 2) (loss 1e-4,
  parameters 1e-5);
- ``launch/mesh.slot_groups``: worker i's slots row-major, as
  ``jax.make_mesh`` lays devices out;
- a model axis the port does not execute raises (FSDP, dp's sequence
  fallback, a tp cut inside a head: ``tests/test_torch_train.py``). The
  moe, hybrid, xlstm, encdec and vlm families' model axis is
  ``tests/test_torch_train_model_axis_families.py``'s.
"""
from __future__ import annotations

import dataclasses
import math
import shutil

import numpy as np
import pytest
import torch

from _torch_train import (MODEL_MESH as MESH, MODEL_ROUNDS as ROUNDS,
                          PARAM_ATOL, LOSS_RTOL, check_round, int8_quanta,
                          model_axis_run, model_mesh, ref_init, reference,
                          rel_gap)
from repro_torch import convert
from repro_torch.checkpoint import list_steps, load_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh, model_devices, slot_groups
from repro_torch.runtime import sharding

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

W = MESH[0]
# case of tests/_torch_train_ref.py -> (arch, config fields)
CASES = {"model_dp": ("smollm-360m", {}),
         "model_tp": ("internlm2-20b", {}),
         "model_tp_kv1": ("internlm2-20b", {"num_kv_heads": 1})}


def _cfg(case: str):
    arch, fields = CASES[case]
    return dataclasses.replace(get_smoke_config(arch), **fields)


def _port(z, case, shape=MESH, **kw):
    return model_axis_run(z, _cfg(case.removesuffix("_int8")), shape, **kw)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("train_ref_model"), *CASES,
                     "model_tp_int8")


@pytest.fixture(scope="module")
def runs(refs):
    return {case: _port(refs[case], case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_trajectory(refs, runs, case):
    z, (run, snaps) = refs[case], runs[case]
    assert run.layout.model == 2 and isinstance(run.params, tuple)
    assert [r.round for r in run.rounds] == list(range(ROUNDS))
    for r in run.rounds:
        check_round(z, r, snaps[r.round])
    np.testing.assert_array_equal(run.adj, z["run/final_adj"])
    np.testing.assert_array_equal(run.taus, z["run/final_taus"])


@pytest.mark.parametrize("case", list(CASES))
def test_slot_pieces_have_param_spec_shapes(refs, runs, case):
    run, _ = runs[case]
    cfg, mesh = _cfg(case), model_mesh()
    layout = run.layout
    whole = layout.whole_shapes()
    split = 0
    for j, slot in enumerate(run.params):
        views = layout.views(slot)
        for k, shape in whole.items():
            spec = sharding.param_spec(k, (W, *shape), cfg, mesh,
                                       worker_dim=True)
            want = tuple(d // sharding.spec_shards(mesh, (ax,))
                         if ax is not None else d
                         for d, ax in zip((W, *shape), spec))
            # the worker dim stays whole in the port's slot matrix
            assert tuple(views[k].shape) == (W, *want[1:]), (k, spec)
            split += j == 0 and want[1:] != tuple(shape)
    # dp holds every leaf whole; tp splits all but the norms (and, with
    # one kv head, wk / wv)
    assert split == {"model_dp": 0, "model_tp": 9, "model_tp_kv1": 7}[case]
    # convert.slot_pieces cuts the reference's init as the layout does
    init = {k: v[None].expand(W, *v.shape)
            for k, v in ref_init(refs[case]).items()}
    for j, pieces in enumerate(convert.slot_pieces(init, cfg, mesh,
                                                   lead=1)):
        assert torch.equal(layout.flatten(pieces),
                           layout.flatten_slots(init)[j])


def test_dp_distances_are_sqrt2_times_one_slot(refs, runs):
    z = refs["model_dp"]
    run22, _ = runs["model_dp"]
    run21, snaps21 = _port(z, "model_dp", shape=(2, 1))
    assert run21.layout.model == 1
    for a, b in zip(run22.rounds, run21.rounds):
        assert rel_gap(a.dists, math.sqrt(2.0) * b.dists) <= 1e-6
        # the loss and the trajectory are the worker's, whatever the axis
        check_round(z, b, snaps21[b.round], dists=False)


def test_compressed_codes_each_slots_pieces(refs):
    """``--compressed`` on tp: each slot codes its own pieces, a tile
    following the piece (the reference's "per leaf shard"): plans equal,
    the loss within 1e-4, the parameters within one int8 quantum of
    their leaf (measured 3.0e-4 of one). The control codes whole leaves
    (the same run at (2, 1)) and parts by more than a quantum by round 1
    (measured 2.9)."""
    z = refs["model_tp_int8"]
    run, snaps = _port(z, "model_tp_int8", compressed=True)
    for r in run.rounds:
        check_round(z, r, {}, dists=False)
        assert r.dists is None and int8_quanta(z, snaps, r.round) <= 1.0
    _, whole = _port(z, "model_tp_int8", shape=(2, 1), compressed=True)
    assert int8_quanta(z, whole, ROUNDS - 1) > 1.0


def test_checkpoint_at_two_slots_resumes_at_one(refs, tmp_path):
    z = refs["model_tp"]
    ckpt = tmp_path / "ckpt"
    run, _ = _port(z, "model_tp", rounds=1, checkpoint_dir=str(ckpt),
                   checkpoint_every=1)
    assert list_steps(str(ckpt)) == [0]
    template = {k: torch.empty((W, *s), device="meta")
                for k, s in run.layout.whole_shapes().items()}
    state, _ = load_checkpoint(str(ckpt), template, 0)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), z[f"run/round0/params/{k}"],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    resumed = {}
    for shape in (MESH, (2, 1)):
        here = tmp_path / f"resume{shape[1]}"
        shutil.copytree(ckpt, here)
        resumed[shape] = _port(z, "model_tp", shape=shape, start=1,
                               checkpoint_dir=str(here), resume=True)
    (a, snaps_a), (b, snaps_b) = resumed[MESH], resumed[(2, 1)]
    assert a.layout.model == 2 and b.layout.model == 1
    assert [r.round for r in a.rounds] == [r.round for r in b.rounds] == [1]
    ra, rb = a.rounds[0], b.rounds[0]
    np.testing.assert_array_equal(ra.adj, rb.adj)
    np.testing.assert_array_equal(ra.taus, rb.taus)
    assert rel_gap(rb.loss, ra.loss) <= LOSS_RTOL
    for k, v in snaps_b[1].items():
        np.testing.assert_allclose(v.numpy(), snaps_a[1][k].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("shape,axes,workers,want", [
    ((2, 2), ("data", "model"), ("data",), [[0, 1], [2, 3]]),
    ((4, 1), ("data", "model"), ("data",), [[0], [1], [2], [3]]),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"),
     [[0, 1], [2, 3], [4, 5], [6, 7]]),
    ((2, 2, 2), ("pod", "data", "model"), ("pod",),
     [[0, 1, 2, 3], [4, 5, 6, 7]])])
def test_slot_groups_row_major(shape, axes, workers, want):
    """Worker i's slots, as ``jax.make_mesh`` lays devices out row-major:
    the worker axes' index, then the other axes' slots in order."""
    mesh = make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))
    assert slot_groups(mesh, workers) == want
    assert len(model_devices(mesh, workers)) == len(want[0])
