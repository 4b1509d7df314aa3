"""The trainer's model axis for the moe, hybrid, xlstm, encdec and vlm
families — a DFL worker's replica over the slots of the mesh's ``model``
axis, its leaves cut by ``runtime/sharding``'s spec rules
(``models/moe.loss_fn_pieces``, ``models/hybrid.loss_fn_pieces``,
``models/xlstm.loss_fn_pieces``) or, in dp, each slot the whole replica
and its share of the batch — against the reference JAX package, on the
CPU.

The reference runs ``launch/train.py``'s round loop on a ``(2, 2)``
``("data", "model")`` mesh of 4 host devices (``tests/_torch_train_ref.py``,
cases ``model_moe``, ``model_moe_shared``, ``model_moe_int8``,
``model_hybrid``, ``model_xlstm``, ``model_whisper`` and ``model_vlm``,
one subprocess): W = 2 workers, f32, 2 rounds, tau_max 2, S = 64, a
global batch of 8, on olmoe-1b-7b's smoke config (its 8 experts over the
model axis, 4 a slot; the router and norms whole), kimi-k2-1t-a32b's (a
shared expert besides, column-parallel in, row-parallel out),
zamba2-7b's at its family lr 0.002 (Mamba2's ``in_proj`` split on its
columns, ``conv_w`` on its channels, ``out_proj`` on its rows; the
shared attention + MLP blocks by the dense rules), xlstm-1.3b's (tp: the
mLSTM's ``w_up`` / ``wq`` / ``wk`` / ``wv`` on their columns, ``w_down``
on its rows, the sLSTM's ``w_in`` on its columns and ``r`` on its heads;
the FFN's width 85 does not divide and stays whole), whisper-large-v3's
and qwen2-vl-2b's (dp: each slot the whole replica and 2 of its worker's
4 sequences). The port's loop runs from the reference's init and
batches on 4 CPU slots of one mesh. Held, with PERF.md section 2's f32
model-axis bounds:

- every round's topology and taus equal; the loss and the measured
  distances within 1e-4 relative, the parameters, the slots' pieces
  joined, within 1e-5 absolute (xlstm measured 8.3e-8, 4.5e-7, 4.8e-7;
  whisper 0, 0, 6.0e-8; qwen2-vl 1.7e-7, 8.7e-8, 3.0e-8);
- each leaf is split on the dim the rules give it (the expert dim, a
  projection's columns or rows, a table's vocabulary) or held whole;
- in dp (whisper, qwen2-vl) the reference counts every leaf once a slot,
  so the distances at (2, 2) are sqrt(2) times the port's own at
  (2, 1), within 1e-6 relative;
- under ``--compressed`` (``model_moe_int8``) each slot codes its own
  pieces: round 0 within 1e-4 (loss) and one int8 quantum (parameters)
  of the reference's, round 1 within 1e-4 and a tenth of a quantum of
  the reference's step from the loop's own round-0 state;
- a checkpoint the port saves at (2, 2) holds whole leaves (the
  reference's round 0 within 1e-5) and resumes at (2, 1) into the
  trajectory it resumes into at (2, 2) (loss 1e-4, parameters 1e-5), on
  olmoe-1b-7b and on xlstm-1.3b;
- piece by piece, on the same weights and inputs: the expert-parallel
  FFN (``moe.moe_ffn_pieces``) against the unsplit ``apply_moe_ffn``
  (``_moe_ffn_flat``), its output and its gradients bit-equal (the
  experts' products are the same per expert), with and without
  ``moe_shard_groups``, and with kimi-k2's shared expert within 1e-6 of
  the largest magnitude (its row-parallel sum reorders); the Mamba2
  block over 2 slots (``ssm.mamba2_pieces``) against
  ``ssm.apply_mamba2`` within 1e-6 of the largest magnitude (the
  row-parallel ``out_proj`` reorders a sum); the mLSTM and sLSTM blocks
  over 2 and 4 slots (``xlstm.mlstm_pieces``, ``xlstm.slstm_pieces``) on
  an xLSTM of d 96 and 4 heads, where every cut divides (``w_up``'s 384
  columns, at 4 slots a cut inside each of its a | gate halves; the
  FFN's 128), against ``apply_mlstm`` / ``apply_slstm``, outputs and
  gradients within 1e-6 of the largest magnitude.
"""
from __future__ import annotations

import dataclasses
import math
import shutil

import numpy as np
import pytest
import torch

from _torch_train import (LOSS_RTOL, MODEL_MESH as MESH,
                          MODEL_ROUNDS as ROUNDS, PARAM_ATOL, SHAPE,
                          check_round, int8_quanta, model_axis_run,
                          model_mesh, rel_gap, reference)
from repro_torch.checkpoint import list_steps, load_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import moe, registry, ssm, xlstm
from repro_torch.runtime import steps

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

W = MESH[0]
# case of tests/_torch_train_ref.py -> (arch, lr)
CASES = {"model_moe": ("olmoe-1b-7b", 0.01),
         "model_moe_shared": ("kimi-k2-1t-a32b", 0.01),
         "model_hybrid": ("zamba2-7b", 0.002),
         "model_xlstm": ("xlstm-1.3b", 0.01),
         "model_whisper": ("whisper-large-v3", 0.01),
         "model_vlm": ("qwen2-vl-2b", 0.01)}
# the cases in dp: every leaf whole on every slot
DP_CASES = ("model_whisper", "model_vlm")
# each case's leaves the rules split -> the dim of one worker's leaf
SPLITS = {
    "model_moe": {"embed": 0, "lm_head": 1, "blocks/attn/wq": 2,
                  "blocks/attn/wk": 2, "blocks/attn/wv": 2,
                  "blocks/attn/wo": 1, "blocks/moe/w_gate": 1,
                  "blocks/moe/w_up": 1, "blocks/moe/w_down": 1},
    "model_hybrid": {"embed": 0, "lm_head": 1, "mamba/mamba/in_proj": 3,
                     "mamba/mamba/conv_w": 3, "mamba/mamba/out_proj": 2,
                     "shared/attn/wq": 2, "shared/attn/wk": 2,
                     "shared/attn/wv": 2, "shared/attn/wo": 1,
                     "shared/mlp/w_up": 2, "shared/mlp/w_gate": 2,
                     "shared/mlp/w_down": 1}}
SPLITS["model_xlstm"] = {
    "embed": 0, "lm_head": 1, "mlstm/w_up": 3, "mlstm/wq": 3,
    "mlstm/wk": 3, "mlstm/wv": 3, "mlstm/w_down": 2, "slstm/w_in": 2,
    "slstm/r": 2, "tail/w_up": 2, "tail/wq": 2, "tail/wk": 2,
    "tail/wv": 2, "tail/w_down": 1}
SPLITS.update({case: {} for case in DP_CASES})
SPLITS["model_moe_shared"] = {**SPLITS["model_moe"],
                              "blocks/moe/shared/w_up": 2,
                              "blocks/moe/shared/w_gate": 2,
                              "blocks/moe/shared/w_down": 1}


def _cfg(case: str):
    return get_smoke_config(CASES[case.removesuffix("_int8")][0])


def _run(z, case, shape=MESH, **kw):
    return model_axis_run(z, _cfg(case), shape,
                          lr=CASES[case.removesuffix("_int8")][1], **kw)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("train_ref_families"), *CASES,
                     "model_moe_int8")


@pytest.fixture(scope="module")
def runs(refs):
    return {case: _run(refs[case], case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_family_model_axis_trajectory(refs, runs, case):
    z, (run, snaps) = refs[case], runs[case]
    assert run.layout.model == 2 and isinstance(run.params, tuple)
    assert [r.round for r in run.rounds] == list(range(ROUNDS))
    for r in run.rounds:
        check_round(z, r, snaps[r.round])
    np.testing.assert_array_equal(run.adj, z["run/final_adj"])
    np.testing.assert_array_equal(run.taus, z["run/final_taus"])


@pytest.mark.parametrize("case", list(CASES))
def test_family_leaves_split_by_the_rules(runs, case):
    """The leaves split, each on its rule's dim, and every other leaf
    (the router, the norms, ``a_log``, ``conv_b``, ``d_skip``,
    ``dt_bias``, the mLSTM's gates, the sLSTM's bias and FFN; in dp
    every leaf) whole on both slots."""
    layout = runs[case][0].layout
    assert {k: d for k, d in layout.splits.items() if d is not None} \
        == SPLITS[case]
    whole, piece = layout.whole_shapes(), layout.leaf_shapes()
    for k, shape in whole.items():
        dim = SPLITS[case].get(k)
        want = list(shape)
        if dim is not None:
            want[dim] //= 2
        assert piece[k] == tuple(want), k


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_family_distances_are_sqrt2_times_one_slot(refs, runs, case):
    """Each slot holds every leaf whole, and the reference counts a whole
    leaf once a slot: the (2, 2) distances are sqrt(2) times the (2, 1)
    run's (measured 1.1e-7 and 6.8e-8 apart in round 0, 0 in round 1),
    whose loss and trajectory are the reference's."""
    z = refs[case]
    run21, snaps21 = _run(z, case, shape=(2, 1))
    assert run21.layout.model == 1
    for a, b in zip(runs[case][0].rounds, run21.rounds):
        assert rel_gap(a.dists, math.sqrt(2.0) * b.dists) <= 1e-6
        check_round(z, b, snaps21[b.round], dists=False)


def _reference_step_from(tmp_path, z, starts: dict, h: int) -> dict:
    """The reference's round-h step (``_torch_train_ref.py``'s
    ``model_moe_int8:from`` cases, one subprocess) from each of
    ``starts`` {tag: the whole worker-stacked leaves before round h}, on
    the reference run's round-h batch, topology, taus and lr -> {tag:
    {"run/round<h>/loss", "run/round<h>/params/<leaf>"}}, ``z``'s keys."""
    pre = f"run/round{h}"
    inputs = {k[len(pre) + 1:]: v for k, v in z.items()
              if k.startswith(f"{pre}/batch/")}
    inputs.update(adj=z[f"{pre}/adj"], taus=z[f"{pre}/taus"],
                  lr=z[f"{pre}/lr"])
    for tag, leaves in starts.items():
        np.savez(tmp_path / f"model_moe_int8:from{tag}.in.npz", **inputs,
                 **{f"params/{k}": v.numpy() for k, v in leaves.items()})
    got = reference(tmp_path, *[f"model_moe_int8:from{t}" for t in starts])
    return {tag: {f"{pre}/loss": out["loss"],
                  **{f"{pre}/{k}": v for k, v in out.items()
                     if k.startswith("params/")}}
            for tag, out in ((t, got[f"model_moe_int8:from{t}"])
                             for t in starts)}


def test_moe_int8_codes_each_slots_pieces(refs, tmp_path):
    """``--compressed`` on the experts' axis, each slot coding its own
    pieces (the reference's "per leaf shard"). The loop's plans equal the
    reference's every round. Round 0: the loss within 1e-4 and the
    parameters within one int8 quantum of their leaf (measured 0.44: one
    code of ``w_up`` on the other side of a rounding boundary, as far as
    the reference parts from itself when its init moves one ulp, and as
    far with its CPU code built without fused multiply-adds;
    ``tests/_torch_train_gaps.py model_moe_int8``). That code moves the
    reference's round 1 by 3.2e-4 in loss and 11.7 quanta, so round 1 of
    the loop is held against the reference's own round-1 step from the
    loop's round-0 state: the loss within 1e-4 (measured 8.1e-8) and the
    parameters within a tenth of a quantum (measured 1.4e-4). The control
    codes whole leaves (the loop at (2, 1)) and parts from that step by
    more than a tenth of a quantum (measured 0.96)."""
    z = refs["model_moe_int8"]
    runs = {}
    for shape in (MESH, (2, 1)):
        run, snaps = _run(z, "model_moe_int8", shape=shape, compressed=True)
        assert run.layout.model == shape[1]
        for r in run.rounds:
            assert r.dists is None
            np.testing.assert_array_equal(r.adj, z[f"run/round{r.round}/adj"])
            np.testing.assert_array_equal(r.taus,
                                          z[f"run/round{r.round}/taus"])
        runs[shape] = run, snaps
    run, snaps = runs[MESH]
    check_round(z, run.rounds[0], {}, dists=False)
    assert int8_quanta(z, snaps, 0) <= 1.0
    steps1 = _reference_step_from(tmp_path, z, {
        shape[1]: s[0] for shape, (_, s) in runs.items()}, 1)
    assert rel_gap(run.rounds[1].loss, steps1[2]["run/round1/loss"]) \
        <= LOSS_RTOL
    assert int8_quanta(steps1[2], snaps, 1) < 0.1 \
        < int8_quanta(steps1[1], runs[(2, 1)][1], 1)


def _checkpoint_resumes(refs, tmp_path, case: str) -> None:
    """A checkpoint of ``case`` saved at (2, 2) holds the reference's
    whole leaves and resumes at (2, 1) into the trajectory it resumes
    into at (2, 2)."""
    z = refs[case]
    ckpt = tmp_path / "ckpt"
    run, _ = _run(z, case, rounds=1, checkpoint_dir=str(ckpt),
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
        resumed[shape] = _run(z, case, shape=shape, start=1,
                              checkpoint_dir=str(here), resume=True)
    (a, snaps_a), (b, snaps_b) = resumed[MESH], resumed[(2, 1)]
    assert a.layout.model == 2 and b.layout.model == 1
    ra, rb = a.rounds[0], b.rounds[0]
    assert ra.round == rb.round == 1
    np.testing.assert_array_equal(ra.adj, rb.adj)
    np.testing.assert_array_equal(ra.taus, rb.taus)
    assert rel_gap(rb.loss, ra.loss) <= LOSS_RTOL
    for k, v in snaps_b[1].items():
        np.testing.assert_allclose(v.numpy(), snaps_a[1][k].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_moe_checkpoint_at_two_slots_resumes_at_one(refs, tmp_path):
    _checkpoint_resumes(refs, tmp_path, "model_moe")


def test_xlstm_checkpoint_at_two_slots_resumes_at_one(refs, tmp_path):
    _checkpoint_resumes(refs, tmp_path, "model_xlstm")


# ---------------------------------------------------------------------------
# piece by piece
# ---------------------------------------------------------------------------

def _slots_and_whole(cfg, stack: str, idx: tuple, m: int = 2):
    """One block of ``cfg``'s smoke weights (W = 2 workers, distinct) as
    the (2, m) layout's m slots' pieces and whole -> (pieces, whole),
    leaves requiring grad."""
    layout = steps.train_layout(cfg, SHAPE, model_mesh((W, m)))
    gen = torch.Generator().manual_seed(3)
    stacked = {k: torch.stack([v, v + 0.01 * torch.randn(
        v.shape, generator=gen)]) for k, v in registry.init_params(
        cfg, torch.Generator().manual_seed(2)).items()}
    whole = {k: v.detach().clone().requires_grad_() for k, v in
             L.layer(stacked, stack, idx).items()}
    pieces = [{k: v.detach().clone().requires_grad_() for k, v in
               L.layer(p, stack, idx).items()} for p in layout.cut(stacked)]
    return pieces, whole, layout


def _near(got: torch.Tensor, want: torch.Tensor, rel: float, what="") -> None:
    """max |got - want| within ``rel`` of max |want| (f32 sums in another
    order; 0 holds them bit-equal)."""
    gap = float((got - want).abs().max())
    assert gap <= rel * float(want.abs().max()), (what, gap)


def _grads_match(pieces, whole, layout, stack, idx, rel) -> None:
    """Each slot's gradient of its piece equals the whole leaf's gradient
    cut the same way, slot 0's where the leaf is whole (the others
    read none). The leaves are one layer's, at ``idx`` of ``stack``."""
    for k, g in whole.items():
        dim = layout.splits.get(f"{stack}/{k}")
        if dim is not None:         # the worker dim for the layer dims
            dim += 1 - len(idx)
        if pieces[0][k].grad is None:
            assert g.grad is None, k
            continue
        cut = [g.grad] * len(pieces) if dim is None else \
            list(torch.chunk(g.grad, len(pieces), dim=dim))
        for j, p in enumerate(pieces):
            if dim is None and j:
                assert p[k].grad is None, k
                continue
            _near(p[k].grad, cut[j], rel, k)


@pytest.mark.parametrize("arch,groups", [("olmoe-1b-7b", 0),
                                         ("olmoe-1b-7b", 4),
                                         ("kimi-k2-1t-a32b", 0)])
def test_expert_parallel_ffn_matches_the_unsplit_layer(arch, groups):
    """Output, aux loss and gradients: bit-equal without a shared expert
    (each expert's product is the unsplit layer's), and within 1e-6 of
    the largest magnitude with kimi-k2's (its row-parallel sum reorders;
    measured 5.5e-8 of the output's)."""
    cfg = dataclasses.replace(get_smoke_config(arch),
                              moe_shard_groups=groups)
    rel = 1e-6 if cfg.num_shared_experts else 0.0
    pieces, whole, layout = _slots_and_whole(cfg, "blocks", (0,))
    x = torch.randn(W, 2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    y, aux = moe.apply_moe_ffn(L.sub(whole, "moe"), x1, cfg)
    yp, auxp = moe.moe_ffn_pieces([L.sub(p, "moe") for p in pieces], x2,
                                  cfg)
    _near(yp.detach(), y.detach(), rel)
    assert torch.equal(auxp, aux)
    # a weighted sum, so that every output feeds the gradient
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    ((y * w).sum() + aux.sum()).backward()
    ((yp * w).sum() + auxp.sum()).backward()
    _near(x2.grad, x1.grad, rel)
    moe_whole = {k: v for k, v in whole.items() if k.startswith("moe/")}
    _grads_match([{k: p[k] for k in moe_whole} for p in pieces], moe_whole,
                 layout, "blocks", (0,), rel)


def test_mamba2_block_over_two_slots_matches_apply_mamba2():
    """Output and gradients within 1e-6 of the largest magnitude (the
    row-parallel ``out_proj`` reorders a sum; measured 3.4e-7 of the
    output's, 5.8e-7 of x's gradient's)."""
    cfg = get_smoke_config("zamba2-7b")
    pieces, whole, layout = _slots_and_whole(cfg, "mamba", (0, 1))
    x = torch.randn(W, 2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = ssm.apply_mamba2(L.sub(whole, "mamba"), x1, cfg.ssm_state)
    yp = ssm.mamba2_pieces([L.sub(p, "mamba") for p in pieces], x2,
                           cfg.ssm_state)
    _near(yp.detach(), y.detach(), 1e-6)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    (y * w).sum().backward()
    (yp * w).sum().backward()
    _near(x2.grad, x1.grad, 1e-6)
    mamba = {k: v for k, v in whole.items() if k.startswith("mamba/")}
    _grads_match([{k: p[k] for k in mamba} for p in pieces], mamba, layout,
                 "mamba", (0, 1), 1e-6)


# an xLSTM whose every cut divides over 2 and 4 slots: d_up 192 (4 heads
# of 48, n_qk 24), w_up 384 columns, w_in 384, the FFN 128 wide
XLSTM_BLOCKS = dict(d_model=96, num_heads=4, num_kv_heads=4)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_block_over_slots_matches_the_unsplit_block(block, m):
    """Output and gradients within 1e-6 of the largest magnitude (the
    row-parallel w_down / w_ffn_down and ln_inner's RMS over the joined
    heads reorder sums)."""
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"),
                              **XLSTM_BLOCKS)
    idx = (0, 1) if block == "mlstm" else (0,)
    pieces, whole, layout = _slots_and_whole(cfg, block, idx, m)
    split = {k for k in whole if layout.splits.get(f"{block}/{k}")
             is not None}
    assert split == ({"w_up", "wq", "wk", "wv", "w_down"} if block ==
                     "mlstm" else {"w_in", "r", "w_ffn_gate", "w_ffn_up",
                                   "w_ffn_down"})
    x = torch.randn(W, 2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    if block == "mlstm":
        y = xlstm.apply_mlstm(whole, x1, cfg)
        yp = xlstm.mlstm_pieces(pieces, x2, cfg)
    else:
        y = xlstm.apply_slstm(whole, x1, cfg)[0]
        yp = xlstm.slstm_pieces(pieces, x2, cfg)[0]
    _near(yp.detach(), y.detach(), 1e-6)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    (y * w).sum().backward()
    (yp * w).sum().backward()
    _near(x2.grad, x1.grad, 1e-6)
    _grads_match(pieces, whole, layout, block, idx, 1e-6)
