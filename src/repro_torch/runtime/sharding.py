"""The worker-stack layout of the sharded DFL engines — the part of
``repro.runtime.sharding`` the worker plan needs (its ``param_spec``,
``cache_spec`` and batch specs serve launch/train's ``(data, model)``
mesh and wait for ROADMAP.md queue 1 item 4).

The flat engines keep each worker's whole replica on its worker's shard:
only the leading worker dim splits, contiguously, ``rows = w_pad /
n_shards`` rows a shard.
"""
from __future__ import annotations

import numpy as np


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
