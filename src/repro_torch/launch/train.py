"""End-to-end DFL training driver: FedHP controller + the round step —
the port of ``repro.launch.train``.

Each round:
  1. the coordinator (host process) decides the topology A^h and per-worker
     taus from last round's measurements (Alg. 3),
  2. the round step runs tau_i masked local updates + matching-wise
     gossip (runtime/steps.py) and reports neighbour consensus distances,
  3. measurements feed the ConsensusTracker / controller for round h+1,
  4. periodic checkpoints (atomic, elastic-restorable).

At smoke scale on the CPU::

    REPRO_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-360m --smoke --steps 4 --workers 4 --device cpu

Without ``--device`` it runs on the card. ``REPRO_DEVICES=n`` makes the
mesh n slots of the one device (the reference's fake host devices), and
the mesh is ``(data, model)`` with the data axis as the DFL workers, as
the reference builds it; without it the slots are the visible cards.
Past ``--workers`` the mesh grows a model axis: a worker's replica lives
on its model-axis slots (``runtime/sharding``'s rules: data parallelism
within the worker under ``within_worker="dp"``, the dense, encdec and
vlm families; tensor parallelism under ``"tp"``, the dense family's
heads and projections, the moe family's experts over the axis, hybrid's
Mamba2 projections and xlstm's mLSTM / sLSTM projections split), e.g. on
the CPU::

    REPRO_DEVICES=8 PYTHONPATH=src python -m repro_torch.launch.train \
        --smoke --workers 4 --device cpu
    REPRO_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.train \
        --arch xlstm-1.3b --smoke --workers 2 --device cpu

The fleet lives on one device: a mesh whose slots span more than one
device, ``--production`` and ``--multi-pod`` raise
``NotImplementedError`` (the multi-process launcher, ROADMAP.md queue 1,
items 4.5 and 4.6), as does a model axis the port does not execute
(FSDP axes, dp's fallback to a sequence split where a worker's
sequences do not divide over the axis, a tp cut inside a head; item
4.4). Wall-clock heterogeneity is synthesized by the SimCluster
profile, as in the reference.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import elastic_reshard
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import FedHPConfig, InputShape, ModelConfig
from repro_torch.core.consensus import ConsensusTracker
from repro_torch.core.controller import AdaptiveController
from repro_torch.core.engine import resolve_device
from repro_torch.core.topology import make_base_topology, \
    matching_decomposition
from repro_torch.launch.mesh import (DeviceMesh, host_devices,
                                     make_mesh, model_devices)
from repro_torch.models import registry
from repro_torch.runtime import sharding, steps
from repro_torch.simulation.cluster import SimCluster


def build_mesh(workers: int, *, production: bool = False,
               multi_pod: bool = False, device=None) -> DeviceMesh:
    """The reference's ``build_mesh``: over the n slots of
    ``host_devices(device)``, the model axis doubles from 1 while n /
    model exceeds ``workers``, and the data axis takes the rest.
    ``production`` / ``multi_pod`` raise ``NotImplementedError``."""
    if production or multi_pod:
        raise NotImplementedError(
            "--production / --multi-pod need a multi-process launcher, "
            "which is not ported to repro_torch yet (ROADMAP.md queue 1, "
            "items 4.5 and 4.6)")
    devices = host_devices(device)
    n = len(devices)
    model = 1
    while (n // model) > workers and model < n:
        model *= 2
    return make_mesh((n // model, model), ("data", "model"), devices=devices)


def random_batches(cfg: ModelConfig, shape: InputShape, seed: int,
                   device) -> Iterator[dict]:
    """The launcher's batches: a random global batch ({name: [b, ...]},
    ``registry.make_batch``) a round from one generator seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield {k: v[0] for k, v in registry.make_batch(cfg, shape,
                                                       gen).items()}


@dataclass
class RoundLog:
    """One round of a run: its index, the (topology, taus) it ran with,
    learning rate, loss, the measured distances (None under
    ``compressed``) and wall seconds of the step (ended by a device
    sync)."""

    round: int
    adj: np.ndarray
    taus: np.ndarray
    lr: float
    loss: float
    dists: np.ndarray | None
    seconds: float


@dataclass
class TrainRun:
    """A run's result: the rounds it ran, the final [W, P] matrix (a
    tuple of the slots' [W, P_slot] matrices on a model axis; whole leaves
    by ``layout.join``) and its layout, and the next round's (topology,
    taus)."""

    rounds: list[RoundLog] = field(default_factory=list)
    params: torch.Tensor | None = None
    layout: object = None
    adj: np.ndarray | None = None
    taus: np.ndarray | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, shape: InputShape, mesh: DeviceMesh, *,
          steps_total: int, tau_max: int = 2, lr: float = 0.01,
          seed: int = 0, compressed: bool = False, checkpoint_dir: str = "",
          checkpoint_every: int = 5, resume: bool = False,
          init_params: dict | None = None,
          batches: Iterator[dict] | None = None,
          on_round: Callable | None = None,
          log: Callable[[str], None] = print) -> TrainRun:
    """The reference's round loop (``launch/train.py:main`` after the
    arguments) over ``mesh``, whose slots must share one device, where
    the run lives. On a model axis of m > 1 slots the state is one
    [W, P_slot] matrix a slot (``steps.train_layout``), slot j's on the
    device of worker 0's j-th slot (``mesh.model_devices``).

    ``init_params``: one worker's whole parameters {name: tensor},
    broadcast to every worker and cut into the slots' pieces (default
    ``registry.init_params`` from ``seed``); ``batches``: one global
    batch {name: [b, ...]} a round (default ``random_batches`` from
    ``seed + 1``, restarted on resume as the reference's stream is);
    ``on_round(h, params, log)`` sees every round's result. Checkpoints
    hold the whole worker-stacked leaves by name, the slots' pieces
    joined (the reference's on-disk format), so a run resumes at any
    model extent."""
    if len(set(mesh.devices)) != 1:
        raise NotImplementedError(
            f"the mesh's slots span {len(set(mesh.devices))} devices; the "
            "port keeps the fleet on one (a multi-card mesh needs the "
            "multi-process launcher, ROADMAP.md queue 1, item 4.6)")
    worker_axes = sharding.worker_axes_in_mesh(cfg, mesh)
    w = sharding.mesh_workers(mesh, worker_axes)
    slot_devs = model_devices(mesh, worker_axes)
    dev = slot_devs[0]
    log(f"mesh {mesh.shape} -> {w} DFL workers; arch={cfg.name} "
        f"seq={shape.seq_len} batch={shape.global_batch}")

    fcfg = FedHPConfig(num_workers=w, rounds=steps_total, tau_max=tau_max,
                       tau_init=tau_max, lr=lr, seed=seed)
    base = make_base_topology(w, "full" if w <= 8 else "erdos:0.3", seed)
    controller = AdaptiveController(base, tau_max=fcfg.tau_max) \
        if w > 1 else None
    tracker = ConsensusTracker(w, fcfg.beta1, fcfg.beta2)
    cluster = SimCluster(w, model_bits=32.0 * cfg.param_count(), seed=seed)

    # --- init state -------------------------------------------------------
    layout = steps.train_layout(cfg, shape, mesh)
    if init_params is None:
        init_params = registry.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed))

    def place(stacked: dict):
        """Whole worker-stacked leaves -> the run's state: [W, P], or a
        tuple of the slots' matrices, each on its slot's device."""
        slots = [layout.round_leaves_(f.to(d).expand(w, -1).contiguous())
                 for f, d in zip(layout.flatten_slots(stacked), slot_devs)]
        return slots[0] if layout.model == 1 else tuple(slots)

    params = place({k: torch.as_tensor(v).to(dev)[None]
                    for k, v in init_params.items()})
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    start_round = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        dtypes = registry.leaf_dtypes(cfg)
        template = {k: torch.empty((w, *s), dtype=dtypes[k], device="meta")
                    for k, s in layout.whole_shapes().items()}
        state, meta = ckpt.restore(template)
        params = place({k: v.to(dev) for k, v in
                        elastic_reshard(state, w).items()})
        start_round = int(meta["step"]) + 1
        log(f"resumed from step {meta['step']} "
            f"(elastic reshard -> {w} workers)")
    if batches is None:
        batches = random_batches(cfg, shape, seed + 1, dev)

    run = TrainRun(layout=layout)
    adj = base
    taus = np.full(w, fcfg.tau_init, np.int64)
    mu, beta = cluster.sample_mu(), cluster.sample_beta()
    built: dict = {}
    loss = float("nan")
    for h in range(start_round, steps_total):
        lr_h = float(np.float32(lr * (fcfg.lr_decay ** h)))
        tau_cap = int(max(taus.max(), 1))
        key = (tuple(map(tuple, adj)), tau_cap)
        if key not in built:
            built[key] = steps.make_train_step(
                cfg, mesh, shape, adj=adj, tau_max=tau_cap,
                compressed=compressed,
                measure_distances=not compressed and w > 1)
        step_fn = built[key].fn

        batch = sharding.split_batch(
            {k: v.to(dev) for k, v in next(batches).items()}, w)
        if tau_cap > 1:
            batch = {k: v[:, None].expand(w, tau_cap, *v.shape[1:])
                     for k, v in batch.items()}

        ran_adj, ran_taus = adj, taus
        _sync(dev)
        t0 = time.perf_counter()
        params, loss_t, aux = step_fn(params, batch,
                                      torch.as_tensor(taus, dtype=torch.int32),
                                      lr_h)
        loss = float(loss_t)
        _sync(dev)
        dt = time.perf_counter() - t0

        # --- coordinator: measurements -> next round's (adj, taus) -------
        mu, beta = cluster.sample_mu(), cluster.sample_beta()
        d = None
        if controller is not None:
            if "neighbor_dists" in aux:
                d = aux["neighbor_dists"].cpu().numpy()
                # distances are per matching; approximate the edge matrix
                pair = np.zeros((w, w))
                for m, match in enumerate(matching_decomposition(adj)):
                    for (i, j) in match:
                        pair[i, j] = pair[j, i] = d[m]
                tracker.update(adj, pair, mean_update_norm=float(d.mean()))
            decision = controller.decide(
                mu, beta, tracker, f1=loss, smooth_l=1.0, sigma=1.0,
                eta=lr_h, rounds=steps_total)
            adj, taus = decision.adj, decision.taus
        log(f"round {h}: loss={loss:.4f} tau_max={tau_cap} "
            f"links={int(adj.sum()) // 2} wall={dt:.1f}s")
        run.rounds.append(RoundLog(h, ran_adj, ran_taus, lr_h, loss, d, dt))
        if on_round is not None:
            on_round(h, params, run.rounds[-1])

        if ckpt and (h + 1) % checkpoint_every == 0:
            ckpt.save(h, layout.join(params),
                      meta={"arch": cfg.name, "loss": loss})
    if ckpt:
        ckpt.save(steps_total - 1, layout.join(params),
                  meta={"arch": cfg.name, "loss": loss})
    run.params, run.adj, run.taus = params, adj, taus
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch/seq (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tau-max", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--production", action="store_true",
                    help="the pod mesh: not ported (ROADMAP.md queue 1, "
                    "item 4.5); raises")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production, the multi-pod mesh: not "
                    "ported; raises")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compressed", action="store_true",
                    help="int8 gossip (a fresh residual each round)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card otherwise")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.smoke:
        shape = InputShape(shape.name, seq_len=64,
                           global_batch=2 * args.workers, kind="train")
    resolve_device(args.device)
    mesh = build_mesh(args.workers, production=args.production,
                      multi_pod=args.multi_pod, device=args.device)
    train(cfg, shape, mesh, steps_total=args.steps, tau_max=args.tau_max,
          lr=args.lr, seed=args.seed, compressed=args.compressed,
          checkpoint_dir=args.checkpoint_dir,
          checkpoint_every=args.checkpoint_every, resume=args.resume)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
