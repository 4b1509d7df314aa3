"""The worker mesh of the port's sharded execution — the port of
``repro.launch.mesh.make_worker_mesh``.

The reference's sharded path is one program over the local devices of a
one-axis ``jax.sharding.Mesh`` (its CPU tests fake several host
devices). Here the mesh is an ordered list of ``torch.device``s, one per
shard, in one process: shard ``s`` holds rows ``[s·rows, (s+1)·rows)``
of the padded ``[w_pad, P]`` worker matrix on ``devices[s]``. A device
may repeat (``["cpu"] * 4``, or four shards on one card): shards on one
device hand blocks to each other without a copy. ``make_debug_mesh`` and
``make_production_mesh`` (launch/train's ``(data, model)`` mesh) wait
for ROADMAP.md queue 1 item 4.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class WorkerMesh:
    """A one-axis mesh of shards: ``devices[s]`` holds shard s. Every
    shard lives on one kind of device: blocks move between shards with
    non-blocking copies, which a copy from a card into host memory would
    let a reader race."""

    devices: tuple[torch.device, ...]
    axis: str = "workers"

    def __post_init__(self):
        kinds = {d.type for d in self.devices}
        if len(kinds) > 1:
            raise ValueError(f"WorkerMesh: shards on {sorted(kinds)} "
                             "devices; every shard must be on one kind")


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_worker_mesh(num_shards: int | None = None, axis: str = "workers",
                     *, devices=None) -> WorkerMesh:
    """A mesh of ``num_shards`` shards over the first ``num_shards`` of
    ``devices`` (default: every visible CUDA device; ``num_shards``
    defaults to all of them). ``devices`` may repeat a device — the
    counterpart of the reference's fake host devices — but not mix the
    CPU with cards (``WorkerMesh``); ``devices=["cpu"]`` is a one-shard
    CPU mesh."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    ndev = len(devices)
    if num_shards is None:
        num_shards = ndev
    if num_shards < 1 or num_shards > ndev:
        raise ValueError(
            f"make_worker_mesh: num_shards={num_shards} out of range for a "
            f"host with {ndev} devices")
    return WorkerMesh(tuple(devices[:num_shards]), axis)
