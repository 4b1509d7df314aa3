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


# ---------------------------------------------------------------------------
# the model axis (tests/test_torch_train_model_axis*.py)
# ---------------------------------------------------------------------------

MODEL_MESH = (2, 2)
MODEL_ROUNDS = 2
# PERF.md section 2's f32 bounds of the trainer on a model axis
LOSS_RTOL = DIST_RTOL = 1e-4
PARAM_ATOL = 1e-5


def model_mesh(shape=MODEL_MESH):
    """A ``("data", "model")`` mesh of ``shape`` over CPU slots."""
    return make_debug_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def ref_init(z: dict) -> dict:
    """The reference run's one-worker init {name: tensor}."""
    return {k[len("run/init/"):]: torch.from_numpy(v)
            for k, v in z.items() if k.startswith("run/init/")}


def model_axis_run(z: dict, cfg, shape=MODEL_MESH, rounds=MODEL_ROUNDS,
                   start=0, **kw):
    """The port's loop from the reference's init and batches (its rounds
    from ``start``) on a ``shape`` mesh -> (TrainRun, {round: the whole
    worker-stacked leaves after it})."""
    from repro_torch.runtime import steps
    snaps = {}
    layout = steps.train_layout(cfg, SHAPE, model_mesh(shape))

    def keep(h, params, log):
        snaps[h] = {k: v.clone() for k, v in layout.join(params).items()}

    batches = iter([{k.rsplit("/", 1)[1]: torch.from_numpy(v)
                     for k, v in z.items()
                     if k.startswith(f"run/round{h}/batch/")}
                    for h in range(start, rounds)])
    run = train(cfg, SHAPE, model_mesh(shape), steps_total=rounds,
                tau_max=TAU_MAX, init_params=ref_init(z), batches=batches,
                on_round=keep, log=lambda line: None, **kw)
    return run, snaps


def check_round(z: dict, r, leaves: dict, *, dists: bool = True) -> None:
    """Round ``r`` (a ``RoundLog``) and its whole leaves against the
    reference's: topology and taus equal, loss and distances within
    ``LOSS_RTOL`` / ``DIST_RTOL``, each leaf within ``PARAM_ATOL``."""
    pre = f"run/round{r.round}"
    np.testing.assert_array_equal(r.adj, z[f"{pre}/adj"])
    np.testing.assert_array_equal(r.taus, z[f"{pre}/taus"])
    assert rel_gap(r.loss, z[f"{pre}/loss"]) <= LOSS_RTOL
    if dists:
        assert rel_gap(r.dists, z[f"{pre}/dists"]) <= DIST_RTOL
    for k, v in leaves.items():
        np.testing.assert_allclose(v.float().numpy(), z[f"{pre}/params/{k}"],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


def int8_quanta(z: dict, snaps: dict, h: int) -> float:
    """The largest gap of round h's leaves from the reference's, in int8
    quanta of the leaf (max |x| / 127)."""
    pre = f"run/round{h}/params"
    return max(float(np.abs(v.numpy() - z[f"{pre}/{k}"]).max()
                     / (np.abs(z[f"{pre}/{k}"]).max() / 127.0))
               for k, v in snaps[h].items())
