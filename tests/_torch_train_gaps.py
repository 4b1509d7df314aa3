#!/usr/bin/env python3
"""How far the port's trainer parts from the reference's on each family's
smoke config, and how far the reference parts from itself when its init
moves one f32 ulp a weight: the witness behind the learning rates of
``tests/test_torch_train_families.py``, on the CPU.

    PYTHONPATH=src python tests/_torch_train_gaps.py [FAMILY[@LR] ...]
    PYTHONPATH=src python tests/_torch_train_gaps.py model_moe_int8

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

``model_moe_int8`` (``--compressed`` on olmoe-1b-7b's experts' axis, the
``(2, 2)`` mesh) prints each round's loss gap (relative) and parameter
gap (in int8 quanta of the leaf, ``int8_quanta``) from the reference's
run of the port's loop, of the nudged reference and of the reference
with XLA's CPU code built for AVX (``:nofma``: no fused multiply-add; a
subprocess of its own), and the worst leaf of each; then the port's gaps
from the ``:nofma`` run.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from _torch_train import (int8_quanta, model_axis_run, port_run,  # noqa: E402
                          ref_rows, reference, rel_gap)
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


def _leaves(z: dict, h: int) -> dict:
    pre = f"run/round{h}/params/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in z.items()
            if k.startswith(pre)}


def _worst_leaf(z: dict, leaves: dict, h: int) -> str:
    gaps = {k: int8_quanta(z, {h: {k: v}}, h) for k, v in leaves.items()}
    return max(gaps, key=gaps.get)


def model_int8(case: str) -> None:
    """The ``model_moe_int8`` witnesses (the module's docstring)."""
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as tmp2:
        runs = reference(Path(tmp), case, f"{case}:nudge")
        runs.update(reference(Path(tmp2), f"{case}:nofma"))
    ref = runs[case]
    run, snaps = model_axis_run(ref, get_smoke_config("olmoe-1b-7b"),
                                lr=float(ref["run/base_lr"]),
                                compressed=True)
    print(f"{case} (olmoe-1b-7b, (2, 2), lr {float(ref['run/base_lr'])})")
    for r in run.rounds:
        h = r.round
        rows = {"port": (r.loss, snaps[h])}
        for variant in ("nudge", "nofma"):
            z = runs[f"{case}:{variant}"]
            rows[variant] = (float(z[f"run/round{h}/loss"]), _leaves(z, h))
        for name, (loss, leaves) in rows.items():
            print(f"  round {h} {name:6} loss "
                  f"{rel_gap(loss, ref[f'run/round{h}/loss']):.2e} params "
                  f"{int8_quanta(ref, {h: leaves}, h):.4f} quanta (worst "
                  f"{_worst_leaf(ref, leaves, h)})")
        nofma = runs[f"{case}:nofma"]
        print(f"  round {h} port from nofma: loss "
              f"{rel_gap(r.loss, nofma[f'run/round{h}/loss']):.2e} params "
              f"{int8_quanta(nofma, snaps, h):.4f} quanta")


def main(argv) -> int:
    torch.set_num_threads(1)
    if argv == ["model_moe_int8"]:
        model_int8(argv[0])
        return 0
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
