"""Shared helpers of the trainer tests (``tests/test_torch_train*.py``):
the reference's runs, made in a 4-device subprocess
(``tests/_torch_train_ref.py``), and the port's round loop
(``repro_torch.launch.train.train``) driven from the reference's init
and batches on a mesh of 4 CPU slots."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import train

REPO = Path(__file__).resolve().parents[1]
W, SEQ, TAU_MAX = 4, 64, 2
SHAPE = InputShape("train_4k", seq_len=SEQ, global_batch=2 * W, kind="train")


def reference(out_dir: Path, *cases: str) -> dict[str, dict]:
    """Run the reference's ``cases`` (``_torch_train_ref.py``) into
    ``out_dir`` -> {case: {key: array}}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_train_ref.py"),
         str(out_dir), *cases], env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for case in cases:
        with np.load(out_dir / f"{case}.npz") as z:
            out[case] = {k: z[k] for k in z.files}
    return out


def cpu_mesh():
    """The reference tests' ``(4, 1)`` ``("data", "model")`` mesh, as 4
    slots of the CPU."""
    return make_debug_mesh((W, 1), devices=["cpu"] * W)


def port_run(z: dict, tag: str, cfg, rounds: int, **kw):
    """The port's loop from the reference run ``tag``'s init and batches
    (its rounds from ``start_round``) -> (TrainRun, {round: the [W, P]
    matrix after it})."""
    init = {k[len(f"{tag}/init/"):]: torch.from_numpy(v)
            for k, v in z.items() if k.startswith(f"{tag}/init/")}
    start = int(z[f"{tag}/start_round"])
    batches = iter([{k.rsplit("/", 1)[1]: torch.from_numpy(v)
                     for k, v in z.items()
                     if k.startswith(f"{tag}/round{h}/batch/")}
                    for h in range(start, rounds)])
    snaps: dict[int, torch.Tensor] = {}
    run = train(cfg, SHAPE, cpu_mesh(), steps_total=rounds, tau_max=TAU_MAX,
                init_params=init, batches=batches,
                on_round=lambda h, p, log: snaps.__setitem__(h, p.clone()),
                log=lambda line: None, **kw)
    return run, snaps


def ref_rows(z: dict, prefix: str, names) -> np.ndarray:
    """The reference's worker-stacked leaves under ``prefix`` as the
    port's flat [W, P] rows (``names`` in layout order)."""
    return np.concatenate([z[f"{prefix}/{k}"].reshape(W, -1) for k in names],
                          axis=1)


def rel_gap(port, ref) -> float:
    """max |port - ref| / |ref| over the entries, where both are 0 counting
    0 and a zero of one side against a non-zero of the other counting
    inf."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    both0 = (port == 0) & (ref == 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(port - ref) / np.abs(ref)
    return float(np.max(np.where(both0, 0.0, gap), initial=0.0))
