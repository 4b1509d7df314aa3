"""Worker layouts — the port of the parts of ``repro.runtime.sharding``
the port runs: the DFL worker count of a named-axis mesh
(``worker_axes_in_mesh``, ``num_workers``), the worker-stacked shapes
and the ``[W, b / W, ...]`` batch split of launch/train's round step, and
the worker-stack layout of the sharded DFL engines, which keep each
worker's whole replica on its worker's shard: only the leading worker dim
splits, contiguously, ``rows = w_pad / n_shards`` rows a shard.

The reference's ``param_spec`` / ``cache_spec`` rule tables shard a
replica over the ``model`` axis (tensor parallelism within a worker);
they wait for the model axis, ROADMAP.md queue 1 item 4.
"""
from __future__ import annotations

import numpy as np
import torch


def worker_axes_in_mesh(cfg, mesh) -> tuple[str, ...]:
    """The subset of ``cfg.worker_axes`` present in the mesh."""
    return tuple(a for a in cfg.worker_axes if a in mesh.shape)


def num_workers(cfg, mesh) -> int:
    """DFL worker count = product of the mesh's worker-axis sizes."""
    n = 1
    for a in worker_axes_in_mesh(cfg, mesh):
        n *= mesh.shape[a]
    return max(n, 1)


MODEL_AXIS = ("a mesh axis beside the worker axes of size > 1 splits a "
              "worker's replica (tensor parallelism over the model axis), "
              "which is not ported to repro_torch yet (ROADMAP.md queue 1, "
              "item 4)")


def mesh_workers(mesh, worker_axes) -> int:
    """``num_workers`` over ``worker_axes``: the product of their sizes,
    for a mesh whose other axes all have size 1 — a worker's replica
    lives whole on one slot. Raises ``NotImplementedError``
    (``MODEL_AXIS``) otherwise."""
    n, rest = 1, 1
    for a, size in mesh.shape.items():
        if a in worker_axes:
            n *= size
        else:
            rest *= size
    if rest > 1:
        raise NotImplementedError(MODEL_AXIS)
    return n


def _stacked(spec, w: int):
    """One shape (a tuple of ints) or (shape, dtype) pair with a leading
    dim of ``w``."""
    if len(spec) == 2 and isinstance(spec[1], torch.dtype):
        return ((w, *spec[0]), spec[1])
    return (w, *spec)


def stack_worker_dim(shapes: dict, w: int) -> dict:
    """Add a leading worker dim to every leaf of ``shapes`` ({name:
    shape} as ``registry.leaf_shapes`` gives it, or {name: (shape,
    dtype)} as ``registry.batch_shapes``)."""
    return {k: _stacked(v, w) for k, v in shapes.items()}


def split_batch_shapes(shapes: dict, w: int) -> dict:
    """{name: (shape, dtype)} of a global batch [b, ...] -> the per-worker
    split [W, b / W, ...] (the reference's ``_split_batch_for_workers``;
    b must divide by W)."""
    out = {}
    for k, (shape, dt) in shapes.items():
        b = shape[0]
        if b % w and w != 1:
            raise ValueError(f"batch leaf {k!r} of {b} rows does not split "
                             f"over {w} workers")
        out[k] = ((w, b // w, *shape[1:]), dt)
    return out


def split_batch(batch: dict, w: int) -> dict:
    """A global batch {name: [b, ...]} -> {name: [W, b / W, ...]} views,
    worker i taking rows [i·b/W, (i+1)·b/W)."""
    split_batch_shapes({k: (tuple(v.shape), v.dtype)
                        for k, v in batch.items()}, w)
    return {k: v.reshape(w, v.shape[0] // w, *v.shape[1:])
            for k, v in batch.items()}


def worker_shard_extent(mesh, worker_axes) -> int:
    """Number of row-shards the worker dim is split into: the mesh's
    shards. ``worker_axes`` must name the mesh's one axis."""
    if tuple(worker_axes) != (mesh.axis,):
        raise ValueError(f"worker axes {tuple(worker_axes)} are not the "
                         f"mesh's axis ({mesh.axis!r},)")
    return len(mesh.devices)


def pad_rows(a, pad: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad host array ``a``'s worker ``axis`` with ``pad`` inert rows."""
    a = np.asarray(a)
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)
