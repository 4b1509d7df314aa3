#!/usr/bin/env python3
"""How far a registry family path's trajectory moves when its start moves
by about one ulp, on one card: the witness behind the learning rates of
``chip_smoke.FAMILY_PATHS`` and the bf16 bounds of phase 4.

    python3 tools/family_witness.py ARCH:LR[:ref] ... [--rounds N]

Each setting runs FedHP on ``chip_smoke.py``'s phase-4 path for ARCH (its
depth, P and W from ``FAMILY_PATHS``, the ``erdos:0.5`` base) at
learning rate LR through the fused engine twice: from the path's seeded
weights, and from those weights with every element scaled by
(1 + 1e-7 z), z standard normal from a fixed seed. With ``:ref`` the
port's reference engine runs too, from the seeded weights. For each run
it prints the loss, accuracy and consensus of every round and whether
they are finite; then the gaps of the perturbed run and of the reference
engine from the fused run, in phase 4's terms (``chip_smoke.history_gaps``:
loss and consensus relative, accuracy and final parameters absolute).
Where the perturbed gap is of the order of the engines' gap, the
engines part at that rate because the trajectory itself amplifies
last-ulp differences, not through a fault of either engine.

ARCH ``smollm-360m-bf16`` is the registry path as published
(``chip_smoke.LM_BF16_MODEL``: bf16 leaves, remat "block", W = 8, its
``LM_BF16_ROUNDS``): there the nudge moves every nonzero weight by one
bf16 ulp, up or down by a fixed-seed coin (a bf16 weight cannot move by
1e-7 relative). Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

NUDGE = 1e-7
NUDGE_SEED = 11
BF16_PATH = "smollm-360m-bf16"


def _setting(text: str):
    arch, lr, *flag = text.split(":")
    if flag not in ([], ["ref"]):
        raise argparse.ArgumentTypeError(f"bad setting {text!r}")
    if arch == BF16_PATH:
        return (arch, {"num_layers": 4}, cs.LM_PARAMS,
                cs.LM_CFG.num_workers), float(lr), bool(flag)
    path = next(p for p in cs.FAMILY_PATHS if p[0] == arch)
    return path[:4], float(lr), bool(flag)


def _nudged_start(adapter, num_workers: int, seed: int) -> dict:
    """The seeded weights every worker starts from, each element scaled
    by (1 + NUDGE z) — or, for a bf16 leaf, moved by one bf16 ulp up or
    down — as the engines' worker-stacked ``init_params``."""
    p0 = adapter.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(NUDGE_SEED)
    out = {}
    for k, v in p0.items():
        if v.dtype == torch.bfloat16:
            sign = torch.randint(0, 2, v.shape, generator=gen) * 2.0 - 1.0
            nudged = (v.float() + sign * ref.bf16_ulp(v)).to(torch.bfloat16)
            nudged = torch.where(v == 0, v, nudged)
        else:
            nudged = v * (1.0 + NUDGE * torch.randn(v.shape, generator=gen))
        out[k] = nudged.expand(num_workers, *v.shape)
    return out


def _run(adapter, fdata, w, lr, rounds, *, fused_engine, init_params=None):
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hist, _ = cs._lm_run(adapter, fdata, "fedhp", rounds,
                         fused_engine=fused_engine, num_workers=w, lr=lr,
                         init_params=init_params, **cs.LM_PARITY_FIELDS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # every run's final weights wait on the host, in double the memory
    # of one [W, P] matrix
    hist.final_params = {k: v.cpu() for k, v in hist.final_params.items()}
    return hist, secs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("settings", nargs="+", type=_setting)
    parser.add_argument("--rounds", type=int, default=None,
                        help="rounds a run (default: the path's, "
                             "FAMILY_ROUNDS or LM_BF16_ROUNDS)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("family_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    ops.build()
    data, _ = cs._lm_data()
    for (arch, depth, params, w), lr, with_ref in args.settings:
        if arch == BF16_PATH:
            adapter = cs.lm_adapter(cs.LM_BF16_MODEL)
            rounds = args.rounds or cs.LM_BF16_ROUNDS
        else:
            adapter = cs.family_adapter(arch, depth, params)
            rounds = args.rounds or cs.FAMILY_ROUNDS
        fdata = cs._fleet_data(data, w)
        start = _nudged_start(adapter, w, cs.LM_CFG.seed)
        runs = {"fused": _run(adapter, fdata, w, lr, rounds,
                              fused_engine=True),
                "nudged": _run(adapter, fdata, w, lr, rounds,
                               fused_engine=True, init_params=start)}
        del start
        if with_ref:
            runs["reference"] = _run(adapter, fdata, w, lr, rounds,
                                     fused_engine=False)
        label = f"{arch}:{cs._depth_tag(depth)} W={w} lr={lr}"
        for what, (hist, secs) in runs.items():
            a = hist.as_arrays()
            print(f"[witness] {label} run={what} "
                  f"loss={a['loss'].tolist()} "
                  f"accuracy={a['accuracy'].tolist()} "
                  f"consensus={a['consensus'].tolist()} "
                  f"mean_tau={a['mean_tau'].tolist()} "
                  f"num_links={a['num_links'].tolist()} "
                  f"finite={bool(np.isfinite(a['loss']).all())} "
                  f"seconds={secs:.3f}", flush=True)
        fused_hist = runs["fused"][0]
        for what in runs:
            if what != "fused":
                gaps = cs.history_gaps(fused_hist, runs[what][0])
                print(f"[witness] {label} gap={what}-vs-fused "
                      + " ".join(f"{k}={v!r}" for k, v in gaps.items()),
                      flush=True)
        del runs, fused_hist
    return 0


if __name__ == "__main__":
    sys.exit(main())
