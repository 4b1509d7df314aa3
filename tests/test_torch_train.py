"""The trainer slice — ``repro_torch.launch.train``, ``runtime/steps``,
the matching collectives, the ``(data, model)`` mesh, the config pieces
— against the reference JAX package, on the CPU.

The reference runs in a subprocess with 4 host devices
(``tests/_torch_train_ref.py``): ``launch/train.py``'s round loop on a
``(4, 1)`` mesh (smollm-360m smoke config, f32, W = 4, 4 rounds, tau_max
2, S = 64, a global batch of 8), then the same loop resumed from its
checkpoints to 6 rounds, and the matching collectives on a random tree.
The port's loop runs from the reference's init and batches on 4 CPU
slots of one mesh. Held:

- every round's topology and taus (the controller's decisions) equal;
- the loss within 1e-4 relative (measured 8.6e-8), the measured
  neighbour distances within 1e-4 relative (measured 2.7e-7; a distance
  of an unmatched worker exactly 0 on both sides), every round's
  parameters within 1e-5 absolute (measured 6.0e-8);
- the port's checkpoints equal the reference's steps and hold its
  leaves within 1e-5; the port resumed from the reference's checkpoint
  matches the reference's resumed run as above;
- ``matchings_as_pairs`` and ``matching_weight_tables`` bit-equal;
  ``gossip_fn`` within 1e-6 of the reference's (measured: bit-equal on
  the full graph, whose weights are 1/4; 4.8e-7 on the ring, where XLA
  contracts the reference's acc + w (y − x) at w = 1/3 into an FMA) and
  within 1e-5 of the dense mix ``mixing_matrix_uniform(adj) @ x``; on
  bf16 leaves bit-equal to the reference's (each matching's term and
  sum rounded to bf16), also beside an f32 leaf; its distances worker
  0's to each partner, within 1e-6 relative of the reference's;
- ``gossip_compressed_fn``: int8's residual bit-equal to the eager
  oracle (``compression.quantize_flat`` / ``dequantize_flat`` a leaf and
  a worker) and its mixed leaves within one int8 quantum of the jitted
  reference's (measured 7.2e-7: the jitted reference's quantize and
  residual are contracted into FMAs, ROADMAP.md queue 3); top-k (from x̂
  = x and from a lagging x̂) and rand-k at steps 0 and 1 within 1e-6
  (measured 0 on the full graph, 4.8e-7 on the ring), their state equal;
  on bf16 leaves int8 and rand-k bit-equal to the reference's (each
  matching's term and sum rounded to bf16), where the f32 mix rounded
  once parts in over 10% of the entries; ``ring_allreduce_mean_fn``
  within 1e-6 (measured equal);
- ``param_count`` / ``active_param_count`` of all ten configs, the
  (arch, shape) cells, ``RunConfig``'s defaults, the worker counts and
  batch split, ``make_debug_mesh``'s shrink rule and messages, and the
  serving steps' abstract arguments, as the reference's;
- ``experiment.model_bits_for`` and ``synthetic.worker_batch_iterator``
  as the reference's (the iterator bit-equal), ``replace_dataset``;
- ``python -m repro_torch.launch.train --smoke --device cpu`` with
  ``REPRO_DEVICES=4`` exits 0, and on a model axis of 2 (``REPRO_DEVICES``
  past ``--workers``: smollm-360m in dp, internlm2-20b in tp) runs to
  ``done``; ``--production``, ``--multi-pod``, a mesh over two devices
  and a model axis the port does not execute (FSDP, dp's sequence
  fallback, a tp cut inside a head) raise ``NotImplementedError``, where
  every family builds on it, and xlstm-1.3b, whisper-large-v3 and
  qwen2-vl-2b run to ``done`` on 2 slots a worker. The trajectories on a
  model axis are in ``tests/test_torch_train_model_axis.py`` and
  ``tests/test_torch_train_model_axis_families.py``.

The bf16 and ``--compressed`` trajectories are in
``tests/test_torch_train_bf16.py`` and
``tests/test_torch_train_bf16_int8.py``.
"""
from __future__ import annotations

import dataclasses
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (SHAPE, TAU_MAX, W, cpu_mesh, port_run, ref_rows,
                          reference, rel_gap)
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import arch_shape_cells as jax_cells
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import FedHPConfig as JaxFedHPConfig
from repro.core import compression as jax_compression
from repro.core import experiment as jax_experiment
from repro.data import synthetic as jax_synthetic
from repro.models import registry as jax_registry
from repro.runtime import sharding as jax_sharding
from repro.runtime import steps as jax_steps
from repro_torch.checkpoint import load_checkpoint, list_steps
from repro_torch.configs import (ARCH_IDS, RunConfig, arch_shape_cells,
                                 get_config, get_smoke_config)
from repro_torch.configs.base import FedHPConfig, InputShape
from repro_torch.core import experiment
from repro_torch.core import topology as topo
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train as trainer
from repro_torch.models import registry
from repro_torch.data import synthetic
from repro_torch.runtime import collectives, sharding, steps

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

ROUNDS = 4
LOSS_RTOL = DIST_RTOL = 1e-4
PARAM_ATOL = 1e-5
GOSSIP_ATOL = 1e-6


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_ref")
    z = reference(out, "f32", "collectives")
    z["ckpt_dir"] = out / "ckpt"
    return z


@pytest.fixture(scope="module")
def f32_run(ref, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("port_ckpt")
    run, snaps = port_run(ref["f32"], "run", get_smoke_config("smollm-360m"),
                          ROUNDS, checkpoint_dir=str(ckpt),
                          checkpoint_every=2)
    return run, snaps, ckpt


@pytest.fixture(scope="module")
def resumed_run(ref, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("resume_ckpt") / "ckpt"
    shutil.copytree(ref["ckpt_dir"], ckpt)
    return port_run(ref["f32"], "resume", get_smoke_config("smollm-360m"),
                    ROUNDS + 2, checkpoint_dir=str(ckpt), checkpoint_every=2,
                    resume=True)


def _names(run):
    return [leaf.name for leaf in run.layout.leaf_offsets()]


def _check_trajectory(z, tag, run, snaps):
    """Plans equal; loss, distances and parameters within the f32
    bounds, every round."""
    assert [r.round for r in run.rounds] == \
        list(range(int(z[f"{tag}/start_round"]), len(snaps)
                   + int(z[f"{tag}/start_round"])))
    for r in run.rounds:
        pre = f"{tag}/round{r.round}"
        np.testing.assert_array_equal(r.adj, z[f"{pre}/adj"])
        np.testing.assert_array_equal(r.taus, z[f"{pre}/taus"])
        assert rel_gap(r.loss, z[f"{pre}/loss"]) <= LOSS_RTOL
        assert rel_gap(r.dists, z[f"{pre}/dists"]) <= DIST_RTOL
        np.testing.assert_allclose(
            snaps[r.round].numpy(), ref_rows(z, f"{pre}/params", _names(run)),
            rtol=0, atol=PARAM_ATOL)
    np.testing.assert_array_equal(run.adj, z[f"{tag}/final_adj"])
    np.testing.assert_array_equal(run.taus, z[f"{tag}/final_taus"])


# ---------------------------------------------------------------------------
# the round loop against the reference's
# ---------------------------------------------------------------------------

def test_f32_plans_equal(ref, f32_run):
    run, _, _ = f32_run
    z = ref["f32"]
    for r in run.rounds:
        np.testing.assert_array_equal(r.adj, z[f"run/round{r.round}/adj"])
        np.testing.assert_array_equal(r.taus, z[f"run/round{r.round}/taus"])
    assert [int(r.adj.sum()) // 2 for r in run.rounds] == [6, 4, 3, 4]


def test_f32_losses(ref, f32_run):
    run, _, _ = f32_run
    for r in run.rounds:
        assert rel_gap(r.loss, ref["f32"][f"run/round{r.round}/loss"]) \
            <= LOSS_RTOL


def test_f32_distances_are_worker0s(ref, f32_run):
    run, snaps, _ = f32_run
    z = ref["f32"]
    for r in run.rounds:
        assert rel_gap(r.dists, z[f"run/round{r.round}/dists"]) <= DIST_RTOL
        assert r.dists.shape == (len(topo.matching_decomposition(r.adj)),)


def test_f32_trajectory(ref, f32_run):
    run, snaps, _ = f32_run
    _check_trajectory(ref["f32"], "run", run, snaps)


def test_checkpoints_match_reference(ref, f32_run):
    run, _, ckpt = f32_run
    assert list_steps(str(ckpt)) == list_steps(str(ref["ckpt_dir"])) == [1, 3]
    template = {leaf.name: torch.empty((W, *leaf.shape), device="meta")
                for leaf in run.layout.leaf_offsets()}
    for step in (1, 3):
        ours, meta = load_checkpoint(str(ckpt), template, step)
        theirs, ref_meta = load_checkpoint(str(ref["ckpt_dir"]), template,
                                           step)
        assert meta["arch"] == ref_meta["arch"] == "smollm-360m"
        assert rel_gap(meta["loss"], ref_meta["loss"]) <= LOSS_RTOL
        for k in template:
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                       rtol=0, atol=PARAM_ATOL)


def test_resume_matches_reference_resume(ref, resumed_run):
    run, snaps = resumed_run
    assert int(ref["f32"]["resume/start_round"]) == 4
    assert [r.round for r in run.rounds] == [4, 5]
    _check_trajectory(ref["f32"], "resume", run, snaps)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_smoke_exits_zero(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DEVICES", "4")
    assert trainer.main(["--smoke", "--steps", "4", "--workers", "4",
                         "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("mesh {'data': 4, 'model': 1} -> 4 DFL "
                               "workers; arch=smollm-360m seq=64 batch=8")
    assert [ln.split(":")[0] for ln in lines[1:5]] == \
        [f"round {h}" for h in range(4)]
    assert lines[-1] == "done"


@pytest.mark.parametrize("argv,env", [
    (["--workers", "4"], "8"),                  # a model axis of 2
    (["--workers", "2"], "4"),
    (["--workers", "4", "--production"], "4"),
    (["--workers", "4", "--multi-pod"], "4"),
])
def test_cli_refuses_the_model_axis(monkeypatch, capsys, argv, env):
    """The model axis runs (smollm-360m's dp layout past ``--workers``);
    the pod meshes stay refused (ROADMAP.md queue 1, items 4.5-4.6)."""
    monkeypatch.setenv("REPRO_DEVICES", env)
    cmd = ["--smoke", "--steps", "1", "--device", "cpu", *argv]
    if "--production" in argv or "--multi-pod" in argv:
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            trainer.main(cmd)
        return
    assert trainer.main(cmd) == 0
    lines = capsys.readouterr().out.splitlines()
    w = int(argv[1])
    assert lines[0].startswith(f"mesh {{'data': {w}, 'model': 2}} -> {w} "
                               "DFL workers; arch=smollm-360m")
    assert lines[1].startswith("round 0:") and lines[-1] == "done"


def test_cli_runs_tensor_parallel(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DEVICES", "4")
    assert trainer.main(["--smoke", "--steps", "2", "--workers", "2",
                         "--device", "cpu", "--arch", "internlm2-20b"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("mesh {'data': 2, 'model': 2} -> 2 DFL "
                               "workers; arch=internlm2-20b")
    assert [ln.split(":")[0] for ln in lines[1:3]] == ["round 0", "round 1"]
    assert lines[-1] == "done"


def test_step_refuses_the_model_axis():
    """The model axis raises where the port does not execute it, with
    ROADMAP.md's item: FSDP axes, dp's fallback to a sequence split (b_w
    not a multiple of the axis: whisper-large-v3 and qwen2-vl-2b with
    one sequence a worker, smollm-360m), a tp cut inside a head
    (xlstm-1.3b's smoke config, 2 heads, over 4 slots), a family under a
    ``within_worker`` it does not run there (qwen2-vl-2b in tp); every
    family builds on 2 slots in its config's mode."""
    mesh = meshlib.make_debug_mesh((2, 2), devices=["cpu"] * 4)
    item = "ROADMAP.md queue 1, item 4.4"
    fsdp = dataclasses.replace(get_smoke_config("internlm2-20b"),
                               worker_axes=("pod",), fsdp_axes=("data",))
    with pytest.raises(NotImplementedError, match="FSDP.*" + item):
        steps.make_train_step(fsdp, mesh, SHAPE)
    one_a_worker = InputShape("t", 64, 2, "train")        # b_w 1 over 2
    for arch in ("smollm-360m", "whisper-large-v3", "qwen2-vl-2b"):
        with pytest.raises(NotImplementedError,
                           match="sequence split.*" + item):
            steps.make_train_step(get_smoke_config(arch), mesh,
                                  one_a_worker)
    four = meshlib.make_debug_mesh((2, 4), devices=["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="split a head.*" + item):
        steps.make_train_step(get_smoke_config("xlstm-1.3b"), four, SHAPE)
    vlm_tp = dataclasses.replace(get_smoke_config("qwen2-vl-2b"),
                                 within_worker="tp")
    with pytest.raises(NotImplementedError, match="'tp'.*" + item):
        steps.make_train_step(vlm_tp, mesh, SHAPE)
    # a model axis of 1, and every family on 2 slots
    steps.make_train_step(get_smoke_config("xlstm-1.3b"), cpu_mesh(),
                          SHAPE)
    for arch in ("internlm2-20b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
                 "zamba2-7b", "xlstm-1.3b", "whisper-large-v3",
                 "qwen2-vl-2b"):
        bundle = steps.make_train_step(get_smoke_config(arch), mesh, SHAPE)
        assert bundle.layout.model == 2 and len(bundle.abstract_args[0]) == 2


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-large-v3",
                                  "qwen2-vl-2b"])
def test_cli_runs_the_last_families_on_the_model_axis(monkeypatch, capsys,
                                                      arch):
    """xlstm-1.3b in tp, whisper-large-v3 and qwen2-vl-2b in dp, 2 slots
    a worker, run to ``done``."""
    monkeypatch.setenv("REPRO_DEVICES", "4")
    assert trainer.main(["--smoke", "--steps", "2", "--workers", "2",
                         "--device", "cpu", "--arch", arch]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("mesh {'data': 2, 'model': 2} -> 2 DFL "
                               f"workers; arch={arch}")
    assert [ln.split(":")[0] for ln in lines[1:3]] == ["round 0", "round 1"]
    assert lines[-1] == "done"


@pytest.mark.parametrize("arch,slots,what", [
    ("whisper-large-v3", "8", "sequence split"),    # b_w 2 over 4 slots
    ("qwen2-vl-2b", "8", "sequence split"),
    ("xlstm-1.3b", "8", "split a head"),            # 2 heads over 4 slots
    ("nemotron-4-340b", "4", "FSDP")])              # as published
def test_cli_refuses_what_the_model_axis_does_not_run(monkeypatch, arch,
                                                      slots, what):
    """Each refusal raises before any weight is made (nemotron-4-340b as
    published: its FSDP axis is refused while the step is built)."""
    monkeypatch.setenv("REPRO_DEVICES", slots)
    smoke = ["--smoke"] if arch != "nemotron-4-340b" else []
    with pytest.raises(NotImplementedError,
                       match=what + ".*ROADMAP.md queue 1, item 4.4"):
        trainer.main([*smoke, "--steps", "1", "--workers", "2",
                      "--device", "cpu", "--arch", arch])


def test_train_refuses_a_mesh_over_two_devices():
    mesh = meshlib.DeviceMesh((torch.device("cpu"), torch.device("meta")),
                              (2, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="span 2 devices"):
        trainer.train(get_smoke_config("smollm-360m"), SHAPE, mesh,
                      steps_total=1, log=lambda line: None)


# ---------------------------------------------------------------------------
# the matching collectives
# ---------------------------------------------------------------------------

TOPOLOGIES = ("full", "ring")
LEAVES = ("a", "b")                 # [W, 6, 32] and [W, 40]
SPANS = [(0, 6 * 32), (6 * 32, 6 * 32 + 40)]


def _x(ref) -> torch.Tensor:
    """The collectives' input tree as the flat [W, P] rows."""
    return torch.from_numpy(ref_rows(ref["collectives"], "x", LEAVES))


def _setup(ref, name):
    z = ref["collectives"]
    adj = z[f"{name}/adj"]
    pairs = collectives.matchings_as_pairs(adj)
    wt = collectives.matching_weight_tables(
        adj, topo.mixing_matrix_uniform(adj))
    return z, adj, pairs, wt


def _assert_rows(got: torch.Tensor, z, prefix, atol=GOSSIP_ATOL):
    np.testing.assert_allclose(got.numpy(), ref_rows(z, prefix, LEAVES),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_matchings_bit_equal(ref, name):
    z, adj, pairs, wt = _setup(ref, name)
    np.testing.assert_array_equal(np.asarray(pairs), z[f"{name}/pairs"])
    np.testing.assert_array_equal(wt, z[f"{name}/wt"])
    assert wt.dtype == np.float32


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_gossip_matches_reference_and_dense_mix(ref, name):
    z, adj, pairs, wt = _setup(ref, name)
    x = _x(ref)
    y = collectives.gossip_fn(cpu_mesh(), ("data",), pairs, wt)(x)
    _assert_rows(y, z, f"{name}/gossip")
    mix = torch.from_numpy(topo.mixing_matrix_uniform(adj)).float()
    torch.testing.assert_close(y, mix @ x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_gossip_on_bf16_leaves_rounds_as_the_reference(ref, name):
    z, _, pairs, wt = _setup(ref, name)
    x = _x(ref).to(torch.bfloat16).float()
    want = ref_rows(z, f"{name}/gossip_bf16", LEAVES)
    everything = ((0, x.shape[1], torch.bfloat16),)
    y = collectives.gossip_fn(cpu_mesh(), ("data",), pairs, wt,
                              narrow_spans=everything)(x)
    np.testing.assert_array_equal(y.numpy(), want)
    # leaf a in bf16, leaf b in f32: each leaf's columns from its form
    a, b = SPANS
    mixed = torch.cat([x[:, a[0]:a[1]], _x(ref)[:, b[0]:b[1]]], dim=1)
    y = collectives.gossip_fn(cpu_mesh(), ("data",), pairs, wt,
                              narrow_spans=((*a, torch.bfloat16),))(mixed)
    np.testing.assert_array_equal(y[:, a[0]:a[1]].numpy(),
                                  want[:, a[0]:a[1]])
    np.testing.assert_allclose(
        y[:, b[0]:b[1]].numpy(),
        ref_rows(z, f"{name}/gossip", LEAVES)[:, b[0]:b[1]], rtol=0,
        atol=GOSSIP_ATOL)


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_gossip_distances_are_worker0s(ref, name):
    z, _, pairs, wt = _setup(ref, name)
    x = _x(ref)
    y, d = collectives.gossip_fn(cpu_mesh(), ("data",), pairs, wt,
                                 measure_distances=True)(x)
    _assert_rows(y, z, f"{name}/gossip_d")
    assert rel_gap(d.numpy(), z[f"{name}/dists"]) <= 1e-6
    want = [float(torch.linalg.vector_norm(x[0] - x[perm[0][1]]))
            for perm in pairs]
    assert rel_gap(d.numpy(), want) <= 1e-6


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_compressed_int8_residual_is_the_eager_oracle(ref, name):
    z, _, pairs, wt = _setup(ref, name)
    x = _x(ref)
    gossip = collectives.gossip_compressed_fn(cpu_mesh(), ("data",), pairs,
                                              wt, leaf_spans=SPANS)
    y, err = gossip(x, torch.zeros_like(x), 0)
    for a, b in SPANS:
        for i in range(W):
            blk = x[i, a:b].numpy()
            q, s = jax_compression.quantize_flat(jnp.asarray(blk))
            deq = np.asarray(jax_compression.dequantize_flat(q, s, blk.size))
            np.testing.assert_array_equal(err[i, a:b].numpy(), blk - deq)
        quantum = float(x[:, a:b].abs().max()) / 127.0
        np.testing.assert_allclose(
            y[:, a:b].numpy(), ref_rows(z, f"{name}/int8/y", LEAVES)[:, a:b],
            rtol=0, atol=quantum)
    # a fresh residual (the train step's None) is the zeros' round
    y0, err0 = gossip(x, None, 0)
    assert torch.equal(y0, y) and torch.equal(err0, err)


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("case,kw", [
    ("int8", {}), ("randk0", dict(mode="randk:0.25", seed=7))])
def test_compressed_on_bf16_leaves_rounds_as_the_reference(ref, name, case,
                                                          kw):
    z, _, pairs, wt = _setup(ref, name)
    x = _x(ref).to(torch.bfloat16).float()
    want = ref_rows(z, f"{name}/{case}_bf16/y", LEAVES)
    everything = ((0, x.shape[1], torch.bfloat16),)
    y, _ = collectives.gossip_compressed_fn(
        cpu_mesh(), ("data",), pairs, wt, leaf_spans=SPANS,
        narrow_spans=everything, **kw)(x, None, 0)
    np.testing.assert_array_equal(y.numpy(), want)
    # the control: the f32 mix rounded once parts from the reference
    once, _ = collectives.gossip_compressed_fn(
        cpu_mesh(), ("data",), pairs, wt, leaf_spans=SPANS, **kw)(x, None, 0)
    assert (once.to(torch.bfloat16).float().numpy() != want).mean() > 0.1


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("case,kw,state", [
    ("topk", dict(mode="topk:0.25", gamma=0.5), "x"),
    ("topk_lag", dict(mode="topk:0.25", gamma=0.5), "lag"),
    ("randk0", dict(mode="randk:0.25", seed=7), "zeros"),
    ("randk1", dict(mode="randk:0.25", seed=7), "zeros"),
])
def test_compressed_sparse_matches_reference(ref, name, case, kw, state):
    z, _, pairs, wt = _setup(ref, name)
    x = _x(ref)
    err = {"x": x.clone(), "lag": x * 0.5, "zeros": torch.zeros_like(x)}[
        state]
    step = 1 if case == "randk1" else 0
    y, new = collectives.gossip_compressed_fn(
        cpu_mesh(), ("data",), pairs, wt, leaf_spans=SPANS, **kw)(x, err,
                                                                  step)
    _assert_rows(y, z, f"{name}/{case}/y")
    _assert_rows(new, z, f"{name}/{case}/err")
    if case.startswith("randk"):
        assert new is err


def test_randk_mask_advances_with_step(ref):
    _, _, pairs, wt = _setup(ref, "full")
    x = _x(ref)
    g = collectives.gossip_compressed_fn(cpu_mesh(), ("data",), pairs, wt,
                                         mode="randk:0.25", seed=7,
                                         leaf_spans=SPANS)
    y0, _ = g(x, None, 0)
    y1, _ = g(x, None, 1)
    assert not torch.equal(y0, y1)
    torch.testing.assert_close(y0.mean(0), x.mean(0), rtol=0, atol=1e-6)


def test_ring_allreduce_mean(ref):
    y = collectives.ring_allreduce_mean_fn(cpu_mesh(), ("data",))(_x(ref))
    _assert_rows(y, ref["collectives"], "allreduce")


# ---------------------------------------------------------------------------
# configs, mesh, sharding, steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_counts_match_reference(arch):
    ours, theirs = get_config(arch), jax_config(arch)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert [s.name for s in ours.shape_list()] == \
        [s.name for s in theirs.shape_list()]
    smoke = get_smoke_config(arch)
    assert smoke.param_count() == jax_smoke_config(arch).param_count()


def test_cells_and_run_config():
    assert ARCH_IDS == JAX_ARCH_IDS
    for skipped in (False, True):
        assert [(a, n, dataclasses.astuple(s)) for a, n, s in
                arch_shape_cells(skipped)] == \
            [(a, n, dataclasses.astuple(s)) for a, n, s in
             jax_cells(skipped)]
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(
        JaxRunConfig())


def test_debug_mesh_shrinks_as_the_reference(ref):
    z = ref["collectives"]
    for i in range(int(z["mesh/cases"])):
        shape = tuple(int(n) for n in z[f"mesh/{i}/in_shape"])
        axes = tuple(str(a) for a in z[f"mesh/{i}/axes"])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = meshlib.make_debug_mesh(shape, axes, shrink=True,
                                        devices=["cpu"] * 4)
        assert tuple(m.shape.values()) == tuple(z[f"mesh/{i}/shape"])
        assert m.axis_names == axes
        assert [str(c.message) for c in caught] == \
            [w for w in z[f"mesh/{i}/warning"] if w]
        assert all(c.category is UserWarning for c in caught)


def test_meshes_raise_without_enough_devices(monkeypatch):
    with pytest.raises(ValueError, match=r"make_debug_mesh\(2, 2\) needs 4"):
        meshlib.make_debug_mesh((2, 2), devices=["cpu"] * 3)
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} devices"):
            meshlib.make_production_mesh(multi_pod=multi_pod,
                                         devices=["cpu"] * 8)
    m = meshlib.make_production_mesh(devices=["cpu"] * 256)
    assert m.shape == {"data": 16, "model": 16}
    monkeypatch.setenv("REPRO_DEVICES", "3")
    assert meshlib.host_devices("cpu") == [torch.device("cpu")] * 3
    assert trainer.build_mesh(2, device="cpu").shape == {"data": 1,
                                                         "model": 2}


@pytest.mark.parametrize("arch", ["smollm-360m", "kimi-k2-1t-a32b",
                                  "nemotron-4-340b", "whisper-large-v3"])
@pytest.mark.parametrize("shape,axes", [
    ((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
    ((2, 4, 2), ("pod", "data", "model")), ((8,), ("data",))])
def test_worker_counts_match_reference(arch, shape, axes):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = meshlib.make_mesh(shape, axes, devices=["cpu"] * 16)
    # the reference's functions read only ``mesh.shape``
    assert sharding.worker_axes_in_mesh(cfg, mesh) == \
        jax_sharding.worker_axes_in_mesh(jcfg, mesh)
    assert sharding.num_workers(cfg, mesh) == \
        jax_sharding.num_workers(jcfg, mesh)


def test_stacked_shapes_and_batch_split_match_reference():
    cfg, jcfg = get_smoke_config("qwen2-vl-2b"), jax_smoke_config(
        "qwen2-vl-2b")
    shape = InputShape("t", 64, 8, "train")
    ours = sharding.split_batch_shapes(registry.batch_shapes(cfg, shape), 4)
    theirs = jax_steps._split_batch_for_workers(
        jax_registry.batch_shapes(jcfg, shape), 4)
    assert {k: v[0] for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    leaves = registry.leaf_shapes(cfg)
    stacked = sharding.stack_worker_dim(leaves, 4)
    assert all(stacked[k] == (4, *v) for k, v in leaves.items())
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
    split = sharding.split_batch(batch, 4)["tokens"]
    assert split.shape == (4, 2, 3) and torch.equal(split[1], batch[
        "tokens"][2:4])
    with pytest.raises(ValueError, match="does not split"):
        sharding.split_batch(batch, 3)


@pytest.mark.parametrize("arch,kind", [("smollm-360m", "prefill"),
                                       ("smollm-360m", "decode"),
                                       ("zamba2-7b", "decode"),
                                       ("whisper-large-v3", "prefill")])
def test_serve_steps_abstract_args_match_reference(arch, kind):
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    shape = InputShape("s", 32, 2, kind)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    theirs = jax_steps.make_step(jcfg, jmesh, shape).abstract_args
    ours = steps.make_step(cfg, meshlib.make_mesh((1, 1), ("data", "model"),
                                                  devices=["cpu"]),
                           shape).abstract_args
    from repro_torch.convert import _flat_items
    for mine, jax_tree in zip(ours, theirs):
        if isinstance(mine, torch.Tensor):        # decode tokens [1, B, 1]
            assert tuple(mine.shape)[1:] == tuple(jax_tree.shape)
            continue
        want = dict(_flat_items(jax_tree))
        assert sorted(mine) == sorted(want)
        for k, v in mine.items():
            assert v.device.type == "meta"
            lead = 0 if k == "len" else 1
            assert tuple(v.shape)[lead:] == tuple(want[k].shape), k


def test_serve_steps_run():
    cfg = get_smoke_config("smollm-360m")
    mesh = meshlib.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    gen = torch.Generator().manual_seed(0)
    params = {k: v[None] for k, v in registry.init_params(cfg, gen).items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, 8), generator=gen)
    logits = steps.make_step(cfg, mesh, InputShape("p", 8, 2, "prefill")) \
        .fn(params, {"tokens": tokens})
    want, cache = registry.run_prefill(cfg, params, {"tokens": tokens},
                                       max_len=9)
    torch.testing.assert_close(logits, want, rtol=1e-6, atol=1e-6)
    bundle = steps.make_step(cfg, mesh, InputShape("d", 9, 2, "decode"))
    nxt = torch.argmax(want, dim=-1)[..., None]
    length = cache["len"].clone()
    got, out = bundle.fn(params, cache, nxt)
    assert got.shape == (1, 2, cfg.vocab_size)
    # the decode step writes its cache in place
    assert out is cache and int(cache["len"]) == int(length) + 1


def test_train_step_abstract_args():
    cfg = get_smoke_config("smollm-360m")
    bundle = steps.make_train_step(cfg, cpu_mesh(), SHAPE, tau_max=TAU_MAX)
    params, batch, taus, lr = bundle.abstract_args
    assert params.shape == (W, bundle.layout.param_count)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {"tokens": (W, TAU_MAX, 2, 64), "labels": (W, TAU_MAX, 2, 64)}
    assert taus.shape == (W,) and lr.shape == ()
    assert params.dtype == torch.float32 and params.device.type == "meta"


# ---------------------------------------------------------------------------
# experiment and data leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["mlp", "mlp:32", "dense:d=32,layers=1",
                                   "moe:d=32,layers=1"])
def test_model_bits_for_matches_reference(model):
    assert experiment.model_bits_for(FedHPConfig(model=model), dim=16,
                                     num_classes=5) == \
        jax_experiment.model_bits_for(JaxFedHPConfig(model=model), dim=16,
                                      num_classes=5)


def test_replace_dataset():
    data = synthetic.make_classification_data(100, 8, 3, seed=1)
    out = experiment.replace_dataset(data, data.x[:10], data.y[:10])
    assert out.num_classes == 3 and out.x.shape == (10, 8)
    assert np.array_equal(out.y, data.y[:10])


@pytest.mark.parametrize("shard_len,batch", [(37, 8), (5, 8), (16, 4)])
def test_worker_batch_iterator_bit_equal(shard_len, batch):
    data = synthetic.make_classification_data(200, 6, 4, seed=2)
    shard = np.random.default_rng(0).permutation(200)[:shard_len]
    ours = synthetic.worker_batch_iterator(data, shard, batch, seed=3)
    theirs = jax_synthetic.worker_batch_iterator(
        jax_synthetic.Dataset(data.x, data.y, data.num_classes), shard,
        batch, seed=3)
    for _ in range(12):
        a, b = next(ours), next(theirs)
        assert np.array_equal(a["x"], b["x"]) and \
            np.array_equal(a["y"], b["y"])
    with pytest.raises(ValueError, match="empty shard"):
        next(synthetic.worker_batch_iterator(data, shard[:0], 4))
