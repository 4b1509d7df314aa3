#!/usr/bin/env python3
"""Where a model-axis round's measured distance parts from the same round
at a model extent of 1, leaf by leaf, against how far the round at extent
1 parts from itself: the witness behind ``chip_smoke.py`` phase 7's
cross-extent distance bounds (``ModelCase.dist_rtol``).

    python3 tools/model_axis_witness.py LABEL [LABEL ...]

LABEL is a case of ``chip_smoke.MODEL_PIECE_CASES`` (``e`` to ``j``).
Each case runs phase 7's round (its published config at its depth,
bf16, the flash kernel, W = 2 at its global batch, S and lr, its seeded
init and batch): at ``(2, 1)``; at ``(2, 1)`` again (the card's own
run-to-run spread); at ``(2, 1)`` from the init nudged one bf16 ulp a
weight, four ways (``NUDGES``): every nonzero bf16 weight up, every one
down, and up or down by a coin of two fixed seeds, each f32 weight moved
one f32 ulp the same way; and at ``(2, 2)``. Each run's
``consensus_dist`` calls are watched: worker 0's squared distance to
its partner, leaf by leaf (at ``(2, 2)`` the slots' pieces added, a leaf
every slot holds whole once a slot, the reference's rule). It prints one
JSON line a run (loss, distance) and one a case: each run's relative gap
from the first run's distance (the ``(2, 2)`` run's from the rule's,
sqrt(d^2 + d^2 of the whole leaves)), the nudges' largest gap (the sound
spread; a bound is twice it), the controls' gaps, which a bound must
reject (the ``(2, 2)`` distance against the rule counting a whole leaf
once; the ``(2, 2)`` distance of slot 0's partial alone, a sum over the
model axis left out, against the rule), and the leaves that carry the
most of each gap, with their squared distances. Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import json
import math
import sys
from dataclasses import replace
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the nudges of the start: every weight up, every one down, or a coin of
# a seed for each
NUDGES = ("up", "down", 11, 12)
TOP = 8


def _nudged(p1: dict, how) -> dict:
    """``p1`` with each nonzero bf16 weight one bf16 ulp and each nonzero
    f32 weight one f32 ulp up (``how`` "up"), down ("down") or up or
    down by a coin of seed ``how``."""
    gen = torch.Generator(device="cuda").manual_seed(
        how if isinstance(how, int) else 0)
    out = {}
    for k, v in p1.items():
        if isinstance(how, int):
            sign = torch.randint(0, 2, v.shape, generator=gen,
                                 device="cuda") * 2.0 - 1.0
        else:
            sign = torch.full(v.shape, 1.0 if how == "up" else -1.0,
                              device="cuda")
        if v.dtype == torch.bfloat16:
            moved = (v.float() + sign * ref.bf16_ulp(v)).to(torch.bfloat16)
        else:
            moved = torch.nextafter(v, sign * torch.inf)
        out[k] = torch.where(v == 0, v, moved)
    return out


def _round(case, cfg, p1, batches, model: int) -> dict:
    """One phase-7 round of ``case`` at (2, ``model``) -> {"loss", "dist",
    "leaves": {name: worker 0's squared distance to its partner, f64}}."""
    shape = cs.case_shape(case)
    mesh = cs._trainer_mesh(cs.TP_WORKERS, cs.TP_WORKERS * model, model)
    layout = cs.steps.train_layout(cfg, shape, mesh)
    spans = [(l.name, l.start, l.stop) for l in layout.leaf_offsets()]
    whole = {l.name for l in layout.leaf_offsets()
             if layout.splits.get(l.name) is None}
    calls: list[dict[str, float]] = []
    orig = ops.consensus_dist

    def spy(x, u):
        calls.append({name: float((x[a:b].double() - u[0, a:b].double())
                                  .square().sum()) for name, a, b in spans})
        return orig(x, u)

    ops.consensus_dist = spy
    try:
        run, _, _ = cs._train_run(cfg, mesh, p1, batches, 1, shape=shape,
                                  lr=case.lr)
    finally:
        ops.consensus_dist = orig
    r0 = run.rounds[0]
    del run
    torch.cuda.empty_cache()
    # a call a slot: their sum is the reference's rule
    leaves = {k: sum(c[k] for c in calls) for k in calls[0]}
    return {"loss": r0.loss, "dist": float(r0.dists[0]), "leaves": leaves,
            "slot0": calls[0], "whole": sorted(whole) if model > 1 else []}


def _gap(got: dict, want: dict) -> dict:
    """The distance's relative gap of leaves ``got`` from ``want`` and the
    leaves that carry the most of it."""
    d_ref = math.sqrt(sum(want.values()))
    d_got = math.sqrt(sum(got.values()))
    moved = sorted(want, key=lambda k: -abs(got[k] - want[k]))
    return {"dist_rel_gap": abs(d_got - d_ref) / d_ref,
            "top_leaves": [{"leaf": k, "d2": got[k], "d2_ref": want[k]}
                           for k in moved[:TOP]]}


def witness(label: str) -> None:
    case = next(c for c in cs.MODEL_PIECE_CASES if c.label == label)
    cfg = replace(cs.get_config(case.arch), use_flash_kernel=True,
                  **cs.case_depth(case))
    gen = torch.Generator(device="cuda").manual_seed(cs.TRAIN_SEED)
    p1 = cs.registry.init_params(cfg, gen)
    batches = [next(cs.trainer.random_batches(cfg, cs.case_shape(case),
                                              cs.TRAIN_SEED + 1, "cuda"))]
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    runs = {"one": _round(case, cfg, p1, batches, 1),
            "one_again": _round(case, cfg, p1, batches, 1)}
    for how in NUDGES:
        runs[f"one_nudged_{how}"] = _round(case, cfg, _nudged(p1, how),
                                           batches, 1)
    runs["two"] = _round(case, cfg, p1, batches, 2)
    for name, r in runs.items():
        print(json.dumps({"case": label, "arch": case.arch, "run": name,
                          "loss": r["loss"], "dist": r["dist"]}), flush=True)
    base = runs["one"]
    # the rule: a leaf every (2, 2) slot holds whole counts once a slot
    rule = {k: v * (2 if k in runs["two"]["whole"] else 1)
            for k, v in base["leaves"].items()}
    out = {"case": label, "arch": case.arch, "bound": case.dist_rtol}
    for name, r in runs.items():
        if name != "one":
            out[name] = _gap(r["leaves"], rule if name == "two"
                             else base["leaves"])
    out["spread"] = max(out[f"one_nudged_{how}"]["dist_rel_gap"]
                        for how in NUDGES)
    # the controls, each a fault of the (2, 2) distance: the rule counting
    # a whole leaf once; a slot's partial left out (slot 0's alone)
    out["control_whole_once"] = _gap(runs["two"]["leaves"], base["leaves"])
    out["control_one_slot"] = _gap(runs["two"]["slot0"], rule)
    print(json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("model_axis_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    ops.build()
    for label in sys.argv[1:] or ["g"]:
        witness(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
