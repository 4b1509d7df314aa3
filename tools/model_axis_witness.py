#!/usr/bin/env python3
"""Where a model-axis round's measured distance parts from the same round
at a model extent of 1, leaf by leaf, against how far the round at extent
1 parts from itself: the witness behind ``chip_smoke.py`` phase 7's
distance bound on its (e), (f) and (g) cases.

    python3 tools/model_axis_witness.py LABEL [LABEL ...]

LABEL is a case of ``chip_smoke.MODEL_PIECE_CASES`` (``e``, ``f``,
``g``). Each case runs phase 7's round (its published config at its
depth, bf16, the flash kernel, W = 2 at S = 4,096, its seeded init and
batch) four times: at ``(2, 1)``; at ``(2, 1)`` again (the card's own
run-to-run spread); at ``(2, 1)`` from the init with every nonzero bf16
weight moved one bf16 ulp up or down by a fixed-seed coin and every f32
weight scaled by (1 + 1e-7 z); and at ``(2, 2)``. Each run's
``consensus_dist`` calls are watched: worker 0's squared distance to
its partner, leaf by leaf (at ``(2, 2)`` the slots' pieces added, a leaf
every slot holds whole once a slot, the reference's rule). It prints one
JSON line a run (loss, distance) and one a case: each run's relative gap
from the first run's distance (the ``(2, 2)`` run's from the rule's,
sqrt(d^2 + d^2 of the whole leaves)), and the leaves that carry the
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

NUDGE = 1e-7
NUDGE_SEED = 11
TOP = 8


def _nudged(p1: dict) -> dict:
    """``p1`` with each nonzero bf16 weight one bf16 ulp up or down (a
    fixed-seed coin) and each f32 weight scaled by (1 + NUDGE z)."""
    gen = torch.Generator(device="cuda").manual_seed(NUDGE_SEED)
    out = {}
    for k, v in p1.items():
        if v.dtype == torch.bfloat16:
            sign = torch.randint(0, 2, v.shape, generator=gen,
                                 device="cuda") * 2.0 - 1.0
            moved = (v.float() + sign * ref.bf16_ulp(v)).to(torch.bfloat16)
            out[k] = torch.where(v == 0, v, moved)
        else:
            out[k] = v * (1.0 + NUDGE * torch.randn(
                v.shape, generator=gen, device="cuda"))
    return out


def _round(cfg, p1, batches, model: int) -> dict:
    """One phase-7 round at (2, ``model``) -> {"loss", "dist", "leaves":
    {name: worker 0's squared distance to its partner, f64}}."""
    mesh = cs._trainer_mesh(cs.TP_WORKERS, cs.TP_WORKERS * model, model)
    layout = cs.steps.train_layout(cfg, cs.TP_SHAPE, mesh)
    spans = [(l.name, l.start, l.stop) for l in layout.leaf_offsets()]
    whole = {l.name for l in layout.leaf_offsets()
             if layout.splits.get(l.name) is None}
    leaves: dict[str, float] = {}
    orig = ops.consensus_dist

    def spy(x, u):
        for name, a, b in spans:
            d2 = float((x[a:b].double() - u[0, a:b].double()).square().sum())
            leaves[name] = leaves.get(name, 0.0) + d2
        return orig(x, u)

    ops.consensus_dist = spy
    try:
        run, _, _ = cs._train_run(cfg, mesh, p1, batches, 1,
                                  shape=cs.TP_SHAPE)
    finally:
        ops.consensus_dist = orig
    r0 = run.rounds[0]
    del run
    torch.cuda.empty_cache()
    return {"loss": r0.loss, "dist": float(r0.dists[0]), "leaves": leaves,
            "whole": sorted(whole) if model > 1 else []}


def witness(label: str) -> None:
    _, arch, layers, _ = next(c for c in cs.MODEL_PIECE_CASES
                              if c[0] == label)
    cfg = replace(cs.get_config(arch), num_layers=layers,
                  use_flash_kernel=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.TRAIN_SEED)
    p1 = cs.registry.init_params(cfg, gen)
    batches = [next(cs.trainer.random_batches(cfg, cs.TP_SHAPE,
                                              cs.TRAIN_SEED + 1, "cuda"))]
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    runs = {"one": _round(cfg, p1, batches, 1),
            "one_again": _round(cfg, p1, batches, 1),
            "one_nudged": _round(cfg, _nudged(p1), batches, 1),
            "two": _round(cfg, p1, batches, 2)}
    for name, r in runs.items():
        print(json.dumps({"case": label, "arch": arch, "run": name,
                          "loss": r["loss"], "dist": r["dist"]}), flush=True)
    base = runs["one"]
    # the rule: a leaf every (2, 2) slot holds whole counts once a slot
    rule = {k: v * (2 if k in runs["two"]["whole"] else 1)
            for k, v in base["leaves"].items()}
    want = {"one_again": base["leaves"], "one_nudged": base["leaves"],
            "two": rule}
    out = {"case": label, "arch": arch}
    for name, ref_leaves in want.items():
        got = runs[name]["leaves"]
        d_ref = math.sqrt(sum(ref_leaves.values()))
        d_got = math.sqrt(sum(got.values()))
        moved = sorted(ref_leaves, key=lambda k: -abs(got[k] - ref_leaves[k]))
        out[name] = {
            "dist_rel_gap": abs(d_got - d_ref) / d_ref,
            "top_leaves": [{"leaf": k, "d2": got[k], "d2_ref": ref_leaves[k]}
                           for k in moved[:TOP]]}
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
