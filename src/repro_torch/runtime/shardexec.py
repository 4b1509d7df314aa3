"""Sharded execution of the flat ``[W, P]`` worker matrix (``mesh=`` or
``cfg.sharded``) — the port of ``repro.runtime.shardexec``.

The engines keep every worker's replica as one row of the flat matrix.
Past a few thousand workers that matrix outgrows one device — FedHP's
regime is fleets of thousands of edge devices. This module splits the
worker dim over the shards of a ``launch/mesh.WorkerMesh``, in one
process: shard s holds its ``[rows, P]`` block on its own device.

- local SGD and the join re-init blend run per block (the blend's fleet
  average is the sum of per-shard partial products, in shard order, on
  the first shard's device);
- gossip always takes the edge-list form, routed cross-shard by shard
  offset through the ``gossip_edges`` kernel: the engines call
  ``collectives.routed_gossip`` on the edge lists ``route`` places;
- compressed gossip encodes every shard's own rows (codec payloads are
  row-local), then routes every shard's delta, then updates each shard
  (``collectives.routed_compressed_gossip``);
- when W does not divide the shard count the fleet is padded with inert
  rows (zero params, tau 0, no edges, zero metric weight) that contribute
  nothing, and sliced off before anything reaches the host.

``WorkerShardPlan`` is the per-run handle ``core/engine.run_dfl`` and
``core/fused.run_dfl_fused`` build when a mesh is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import WorkerMesh, make_worker_mesh
from repro_torch.runtime.collectives import (RoutedEdges, per_device,
                                             route_edges)
from repro_torch.runtime.sharding import pad_rows


def default_worker_mesh(device=None) -> WorkerMesh:
    """The mesh ``cfg.sharded=True`` uses when no mesh is passed: one
    shard per visible card (``device`` None or ``"cuda"``), else one
    shard on ``device`` (``"cpu"``, ``"cuda:1"``) — a one-shard mesh
    still runs the whole sharded machinery, as the reference's does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return make_worker_mesh()
    return make_worker_mesh(devices=[dev])


class WorkerShardPlan:
    """Per-run sharding plan: the mesh's shards, the padding and the
    helpers that move rows between the host, the shards and the first
    shard's device.

    ``num_workers`` is the real fleet size W; every device-side block
    holds ``rows = w_pad / n_shards`` rows of the padded ``w_pad =
    ceil(W / n_shards) · n_shards``.
    """

    def __init__(self, mesh: WorkerMesh, num_workers: int):
        self.n_shards = len(mesh.devices)
        self.devices = mesh.devices
        self.first = self.devices[0]
        self.num_workers = num_workers
        self.w_pad = -(-num_workers // self.n_shards) * self.n_shards
        self.pad = self.w_pad - num_workers
        self.rows = self.w_pad // self.n_shards

    # -- layout helpers ----------------------------------------------------

    def pad_host(self, a, fill=0, axis: int = 0) -> np.ndarray:
        """Pad a host array's worker ``axis`` from W to w_pad."""
        return pad_rows(a, self.pad, axis=axis, fill=fill)

    def put_host(self, a, axis: int = 0, fill=0) -> list[torch.Tensor]:
        """A host array with a [W] worker ``axis``, padded and split into
        one [.., rows, ..] slice per shard, each uploaded to its device."""
        a = self.pad_host(a, fill, axis)
        return [torch.from_numpy(np.ascontiguousarray(part)).to(dev)
                for part, dev in zip(np.split(a, self.n_shards, axis=axis),
                                     self.devices)]

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t`` on every shard's device, one copy per distinct device."""
        return per_device(t, self.devices)

    def put_stacked(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """[W, P] (on any device) -> the list of [rows, P] blocks on the
        shards' devices, the padding rows zero."""
        blocks = []
        for s, dev in enumerate(self.devices):
            lo, hi = s * self.rows, min((s + 1) * self.rows,
                                        self.num_workers)
            block = torch.zeros(self.rows, flat.shape[1], dtype=flat.dtype,
                                device=dev)
            if hi > lo:
                block[:hi - lo] = flat[lo:hi].to(dev)
            blocks.append(block)
        return blocks

    def gather(self, parts) -> torch.Tensor:
        """Per-shard [rows, ...] parts -> [w_pad, ...] on the first
        shard's device."""
        return torch.cat([p.to(self.first, non_blocking=True)
                          for p in parts])

    def unpad(self, blocks) -> torch.Tensor:
        """The real W rows of the blocks, gathered onto the first shard's
        device as the unsharded run holds them."""
        return self.gather(blocks)[:self.num_workers]

    def psum(self, parts) -> torch.Tensor:
        """The sum of per-shard partials, in shard order, on the first
        shard's device."""
        total = parts[0].to(self.first, non_blocking=True)
        for p in parts[1:]:
            total = total + p.to(self.first, non_blocking=True)
        return total

    # -- sharded round ops -------------------------------------------------

    def local_train(self, adapter, blocks, bx, by, taus, lr,
                    tau_cap: int) -> list[torch.Tensor]:
        """``engine._local_train`` on each shard's block. ``bx``/``by``/
        ``taus`` are host arrays of the real W workers (padded here: tau 0
        makes the padding rows' steps exact no-ops); ``lr`` a float."""
        from repro_torch.core.engine import _local_train
        lrs = self.replicate(torch.tensor(lr, dtype=torch.float32))
        return [_local_train(adapter, b, x, y.long(), t, lr_s, tau_cap)
                for b, x, y, t, lr_s in zip(
                    blocks, self.put_host(bx), self.put_host(by),
                    self.put_host(taus), lrs)]

    def blend(self, blocks, keeps, rws) -> list[torch.Tensor]:
        """``engine._blend_joined`` with the fleet mean as the sum of the
        shards' partial products ``rw_s @ block_s``: rows in ``keeps[s]``
        (per-shard [rows] bool) adopt it."""
        mean = self.psum([rw @ b for rw, b in zip(rws, blocks)])
        return [torch.where(k[:, None], m[None, :], b)
                for b, k, m in zip(blocks, keeps, self.replicate(mean))]

    def reinit_joined(self, blocks, joined: np.ndarray,
                      donors: np.ndarray) -> list[torch.Tensor]:
        """``engine._reinit_joined``: joining workers (host [W] mask)
        adopt the average of the donors (host [W] mask)."""
        w = donors.astype(np.float32)
        w = w / max(w.sum(), 1.0)
        return self.blend(blocks, self.put_host(joined, fill=False),
                          self.put_host(w))

    def route(self, edge_lists) -> list[RoutedEdges]:
        """Each directed edge list (src, dst, w) routed over the shards
        (``collectives.route_edges``; the padding rows have no edges)."""
        return route_edges(edge_lists, self.w_pad, self.devices)
