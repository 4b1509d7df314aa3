#!/usr/bin/env python3
"""How far the port's trainer parts from the reference's on each family's
smoke config, and how far the reference parts from itself when its init
moves one f32 ulp a weight: the witness behind the learning rates of
``tests/test_torch_train_families.py``, on the CPU.

    PYTHONPATH=src python tests/_torch_train_gaps.py [FAMILY[@LR] ...]

FAMILY is a case of ``tests/_torch_train_ref.py`` (whisper, moe, hybrid,
xlstm, vlm; default all five), at its own lr unless ``@LR`` names
another. The reference runs each case and its ``:nudge`` twin in one
subprocess; the port's loop runs from the reference's init and batches
at the same lr. For each family and round it prints the worst gaps from
the reference's run, in the test's terms (loss and distances relative,
parameters absolute), of the port and of the nudged reference: where the
nudge parts the reference from itself as far as the port parts from it,
the trajectory amplifies last-ulp differences at that lr, and the test
cannot tell a fault from it.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from _torch_train import port_run, ref_rows, reference, rel_gap  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402

ARCHS = {"whisper": "whisper-large-v3", "moe": "olmoe-1b-7b",
         "hybrid": "zamba2-7b", "xlstm": "xlstm-1.3b", "vlm": "qwen2-vl-2b"}
ROUNDS = 2


def _gaps(want: tuple, loss, dists, params) -> str:
    """loss and distances relative, parameters absolute, from ``want``'s
    (loss, distances, parameters)."""
    return (f"loss {rel_gap(loss, want[0]):.2e} "
            f"dists {rel_gap(dists, want[1]):.2e} "
            f"params {np.abs(params - want[2]).max():.2e}")


def main(argv) -> int:
    torch.set_num_threads(1)
    cases = argv or list(ARCHS)
    with tempfile.TemporaryDirectory() as tmp:
        runs = reference(Path(tmp), *[c for case in cases
                                      for c in (case, f"{case}:nudge")])
    for case in cases:
        family = case.partition("@")[0]
        ref, nudged = runs[case], runs[f"{case}:nudge"]
        run, snaps = port_run(ref, "run", get_smoke_config(ARCHS[family]),
                              ROUNDS, lr=float(ref["run/base_lr"]))
        names = [leaf.name for leaf in run.layout.leaf_offsets()]
        print(f"{case} ({ARCHS[family]}, lr {float(ref['run/base_lr'])})")
        for r in run.rounds:
            pre = f"run/round{r.round}"
            want = (ref[f"{pre}/loss"], ref[f"{pre}/dists"],
                    ref_rows(ref, f"{pre}/params", names))
            print(f"  round {r.round} port   " + _gaps(
                want, r.loss, r.dists, snaps[r.round].numpy()))
            print(f"  round {r.round} nudged " + _gaps(
                want, nudged[f"{pre}/loss"], nudged[f"{pre}/dists"],
                ref_rows(nudged, f"{pre}/params", names)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
