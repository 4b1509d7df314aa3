"""Device meshes of the port — the port of ``repro.launch.mesh``.

The reference's meshes are ``jax.sharding.Mesh``es over the local
devices (its CPU tests fake several host devices). Here a mesh is an
ordered list of ``torch.device``s in one process, and a device may
repeat — the counterpart of the fake host devices: ``REPRO_DEVICES=n``
makes n slots of the one device a run is on (``host_devices``).

- ``make_worker_mesh`` -> ``WorkerMesh``: the sharded execution's
  one-axis mesh; shard ``s`` holds rows ``[s·rows, (s+1)·rows)`` of the
  padded ``[w_pad, P]`` worker matrix on ``devices[s]`` (shards on one
  device hand blocks to each other without a copy).
- ``make_debug_mesh`` / ``make_production_mesh`` -> ``DeviceMesh``:
  launch/train's named-axis mesh (``("data", "model")``; ``("pod",
  "data", "model")`` multi-pod), slots laid out row-major over the axes
  as ``jax.make_mesh`` lays out devices; ``slot_groups`` names the
  slots that hold each DFL worker's pieces (its model-axis slots), and
  ``model_devices`` where the trainer keeps each model-axis slot's
  matrix of the fleet's pieces.
"""
from __future__ import annotations

import math
import os
import warnings
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


@dataclass(frozen=True)
class DeviceMesh:
    """A named-axis mesh: ``axis_sizes[i]`` slots along ``axis_names[i]``,
    ``devices`` the slots in row-major order (a device may repeat)."""

    devices: tuple[torch.device, ...]
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"DeviceMesh: {len(self.axis_sizes)} sizes for "
                             f"axes {self.axis_names}")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"DeviceMesh: {len(self.devices)} slots for a "
                             f"mesh of shape {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))


def slot_groups(mesh: DeviceMesh, worker_axes) -> list[list[int]]:
    """The slots that hold each DFL worker's pieces: for worker i (row-major
    over ``worker_axes``, in mesh order, as the reference's
    ``axis_index(worker_axes)``), the indices into ``mesh.devices`` of its
    slots along the other axes, in row-major order. On a ``(data, model)
    = (4, 2)`` mesh worker i holds slots [2 i, 2 i + 1]; on a mesh whose
    other axes have size 1, one slot a worker."""
    names = mesh.axis_names
    ids = torch.arange(len(mesh.devices)).reshape(mesh.axis_sizes)
    lead = [i for i, a in enumerate(names) if a in worker_axes]
    rest = [i for i, a in enumerate(names) if a not in worker_axes]
    w = math.prod(mesh.axis_sizes[i] for i in lead)
    return ids.permute(*lead, *rest).reshape(w, -1).tolist()


def model_devices(mesh: DeviceMesh, worker_axes) -> list[torch.device]:
    """The device of each model-axis slot of worker 0's group
    (``slot_groups``): where the fleet's matrix of that slot's pieces
    lives while the whole fleet is on one device."""
    return [mesh.devices[s] for s in slot_groups(mesh, worker_axes)[0]]


def host_devices(device=None) -> list[torch.device]:
    """The slots a run's meshes are built over: ``REPRO_DEVICES=n`` slots
    of ``device`` when that is set (the reference's fake host devices),
    else every visible card for ``device=None`` and one slot of any
    named device."""
    n = os.environ.get("REPRO_DEVICES")
    if device is None and not n:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    dev = _device("cuda" if device is None else device)
    return [dev] * (int(n) if n else 1)


def make_mesh(shape, axes, *, devices=None) -> DeviceMesh:
    """``jax.make_mesh``: a mesh of ``shape`` over the first
    prod(shape) of ``devices`` (default ``host_devices()``); raises
    ``ValueError`` when there are fewer."""
    devices = host_devices() if devices is None else \
        [_device(d) for d in devices]
    need = math.prod(shape)
    if need > len(devices):
        raise ValueError(f"mesh of shape {tuple(shape)} needs {need} devices; "
                         f"{len(devices)} available")
    return DeviceMesh(tuple(devices[:need]), tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceMesh:
    """The pod mesh: 16 x 16 = 256 slots ``("data", "model")``
    single-pod, 2 x 16 x 16 ``("pod", "data", "model")`` multi-pod. With
    fewer ``devices`` (default ``host_devices()``) it raises as
    ``make_debug_mesh(shrink=False)`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_debug_mesh(shape, axes, devices=devices)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *,
                    shrink: bool = False, devices=None) -> DeviceMesh:
    """Small mesh for CPU tests over ``devices`` (default
    ``host_devices()``: set ``REPRO_DEVICES`` for several slots).

    There must be at least ``prod(shape)`` devices. With ``shrink=False``
    (default) fewer raise ``ValueError``; with ``shrink=True`` axis sizes
    are halved deterministically (leftmost even axis first, then forced
    to 1) until the mesh fits, with a ``UserWarning`` naming the final
    shape — the reference's rule and messages."""
    devices = host_devices() if devices is None else \
        [_device(d) for d in devices]
    ndev = len(devices)
    need = math.prod(shape)
    if need > ndev:
        if not shrink:
            raise ValueError(
                f"make_debug_mesh{tuple(shape)} needs {need} devices but the "
                f"host exposes {ndev}; set REPRO_DEVICES={need} for {need} "
                f"slots of one device, or pass shrink=True")
        sizes = list(shape)
        while math.prod(sizes) > ndev:
            for i, s in enumerate(sizes):
                if s > 1 and s % 2 == 0:
                    sizes[i] = s // 2
                    break
            else:
                for i, s in enumerate(sizes):
                    if s > 1:
                        sizes[i] = 1
                        break
        shape = tuple(sizes)
        warnings.warn(
            f"make_debug_mesh: host has {ndev} devices; shrank mesh to "
            f"{shape} over axes {tuple(axes)}", UserWarning, stacklevel=2)
    return make_mesh(shape, axes, devices=devices)
