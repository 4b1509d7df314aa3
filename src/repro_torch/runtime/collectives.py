"""Cross-shard gossip of the sharded DFL engines — the port of the
edge-list half of ``repro.runtime.collectives`` (``worker_shard_extent``,
``edge_shard_tables``, ``routed_mix_delta`` and the two sharded
edge-gossip functions).

The reference routes a directed edge list over a worker-sharded [W, P]
matrix with one ``lax.ppermute`` of each shard's [rows, P] block per
distinct shard offset delta = shard(dst) - shard(src) mod n_shards. In
the port's one-process mesh (``launch/mesh.WorkerMesh``) that exchange
is a block handoff: for offset delta, shard s receives shard
(s - delta) mod n_shards's block, copied to its own device (the block
itself when both live on one device). Each offset's edges into shard s
form a local CSR list (local source rows in the received block, local
destination rows in s's own), and the ``gossip_edges`` kernel mixes
them: the delta is sum_delta (gossip_edges(v, recv_delta, csr_delta) -
v), added in offset order as the reference's ``acc + segment_sum``.

The dense matching collectives (``matchings_as_pairs``, ``gossip_fn``,
``ring_allreduce_mean_fn``, ...) serve ``runtime/steps.py`` and wait
for ROADMAP.md queue 1 item 4.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core import topology as topo
from repro_torch.kernels import ops
from repro_torch.runtime.sharding import worker_shard_extent

__all__ = ["edge_shard_tables", "shard_csr", "routed_mix_delta",
           "RoutedEdges", "route_edges", "per_device",
           "routed_gossip", "routed_compressed_gossip",
           "gossip_edges_sharded_fn", "gossip_edges_compressed_sharded_fn",
           "worker_shard_extent"]


def edge_shard_tables(src, dst, w, num_workers: int, n_shards: int, *,
                      offsets: tuple[int, ...] | None = None,
                      width: int | None = None):
    """Group a directed edge list by shard-offset delta, host-side.

    Edges are grouped by ``delta = shard(dst) - shard(src) mod n_shards``
    (contiguous row sharding, ``rows = W / n_shards`` per shard); within
    a group they are bucketed by destination shard and zero-weight padded
    to a common width (padding slots land on local row 0 with weight 0).

    Returns ``(offsets, sl, dl, wl)``: the sorted tuple of distinct
    deltas, and ``[D, n_shards, width]`` tables of local source rows,
    local destination rows and edge weights. Pass ``offsets``/``width``
    to force a shape; a delta outside the forced ``offsets`` raises.
    Bit-equal to the reference's tables."""
    if num_workers % n_shards != 0:
        raise ValueError(f"W={num_workers} not divisible by "
                         f"worker-shard extent {n_shards}")
    rows = num_workers // n_shards
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    deltas = (dst // rows - src // rows) % n_shards
    present = sorted(set(deltas.tolist()))
    if offsets is None:
        offsets = tuple(int(d) for d in present)
    else:
        extra = set(present) - set(offsets)
        if extra:
            raise ValueError(f"edge deltas {sorted(extra)} not in the "
                             f"forced offsets {offsets}")
    need = 1
    for delta in offsets:
        sel = deltas == delta
        if sel.any():
            need = max(need, int(np.bincount(dst[sel] // rows,
                                             minlength=n_shards).max()))
    if width is None:
        width = need
    elif width < need:
        raise ValueError(f"forced width {width} < required {need}")
    sl = np.zeros((len(offsets), n_shards, width), np.int32)
    dl = np.zeros((len(offsets), n_shards, width), np.int32)
    wl = np.zeros((len(offsets), n_shards, width), np.float32)
    for gi, delta in enumerate(offsets):
        sel = deltas == delta
        es, ed, ew = src[sel], dst[sel], w[sel]
        dshard = ed // rows
        for k in range(n_shards):
            m = dshard == k
            c = int(m.sum())
            sl[gi, k, :c] = es[m] % rows
            dl[gi, k, :c] = ed[m] % rows
            wl[gi, k, :c] = ew[m]
    return offsets, sl, dl, wl


def shard_csr(sl, dl, wl, rows: int):
    """One (offset, destination shard) slot list of ``edge_shard_tables``
    -> the CSR form ``ops.gossip_edges`` walks (``topology.edges_to_csr``:
    row_ptr [rows + 1], col [E], w [E]), zero-weight slots dropped, each
    row's edges in table order; None when no edge is left."""
    keep = np.asarray(wl) != 0
    if not keep.any():
        return None
    return topo.edges_to_csr(np.asarray(sl)[keep], np.asarray(dl)[keep],
                             np.asarray(wl)[keep], rows)


def routed_mix_delta(v: torch.Tensor, recvs, csrs) -> torch.Tensor:
    """One shard's slice of ``compression.edge_mix_delta``: ``v`` is the
    shard's own [rows, P] block, ``recvs[i]`` the block it received for
    its i-th offset (``v`` itself at offset 0) and ``csrs[i]`` that
    offset's local CSR list -> sum_i (gossip_edges(v, recvs[i], *csrs[i])
    - v), added in offset order (zeros without an offset)."""
    acc = torch.zeros_like(v)
    for recv, csr in zip(recvs, csrs):
        acc = acc + (ops.gossip_edges(v, recv, *csr) - v)
    return acc


def per_device(t: torch.Tensor, devices) -> list[torch.Tensor]:
    """``t`` on each of ``devices``, copied once per distinct device
    (shards on one device share the copy)."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in devices:
        if dev not in copies:
            copies[dev] = t.to(dev)
        out.append(copies[dev])
    return out


class RoutedEdges:
    """One round's edge list routed over a mesh's shards: per shard, the
    (offset, local CSR on the shard's device) pairs of the offsets that
    carry edges into it, in offset order."""

    def __init__(self, devices, groups):
        self.devices = tuple(devices)
        self.groups = groups

    def launches(self) -> int:
        """The ``gossip_edges`` launches one ``mix_delta`` makes."""
        return sum(len(g) for g in self.groups)

    def mix_delta(self, vs) -> list[torch.Tensor]:
        """The sharded ``W v - v`` of the per-shard blocks ``vs``: every
        shard's routed delta, on its own device (every block must exist
        before the first is mixed)."""
        n = len(vs)
        out = []
        for s, (dev, group) in enumerate(zip(self.devices, self.groups)):
            recvs = [vs[(s - d) % n].to(dev, non_blocking=True)
                     for d, _ in group]
            out.append(routed_mix_delta(vs[s], recvs,
                                        [csr for _, csr in group]))
        return out


def route_edges(edge_lists, num_workers: int, devices) -> list[RoutedEdges]:
    """Route each directed edge list ``(src, dst, w)`` of ``edge_lists``
    over a mesh of ``devices`` (one per shard) at ``num_workers`` padded
    rows -> one ``RoutedEdges`` each. The CSR lists of all the lists are
    packed and uploaded once per distinct device."""
    n_shards = len(devices)
    rows = num_workers // n_shards
    tables = []
    for src, dst, w in edge_lists:
        offsets, sl, dl, wl = edge_shard_tables(src, dst, w, num_workers,
                                                n_shards)
        tables.append([[(delta, csr) for gi, delta in enumerate(offsets)
                        if (csr := shard_csr(sl[gi, s], dl[gi, s],
                                             wl[gi, s], rows)) is not None]
                       for s in range(n_shards)])
    uploads: dict[torch.device, list] = {}
    for per_shard in tables:
        for dev, group in zip(devices, per_shard):
            uploads.setdefault(dev, []).extend(csr for _, csr in group)
    placed = {dev: iter(_upload(csrs, dev)) for dev, csrs in uploads.items()}
    return [RoutedEdges(devices, [[(delta, next(placed[dev]))
                                   for delta, _ in group]
                                  for dev, group in zip(devices, per_shard)])
            for per_shard in tables]


def _upload(csrs, device) -> list[tuple]:
    """CSR lists (numpy) -> the same lists on ``device``, through one
    int32 and one f32 copy: views of two packed buffers."""
    if not csrs:
        return []
    ints = [a for rp, col, _ in csrs for a in (rp, col)]
    ibuf = torch.from_numpy(np.concatenate(ints)).to(device)
    fbuf = torch.from_numpy(np.concatenate([w for _, _, w in csrs]))
    isplit = ibuf.split([len(a) for a in ints])
    fsplit = fbuf.to(device).split([len(w) for _, _, w in csrs])
    return [(isplit[2 * i], isplit[2 * i + 1], fsplit[i])
            for i in range(len(csrs))]


def routed_gossip(blocks, routed: RoutedEdges) -> list[torch.Tensor]:
    """Sparse Eq. 5 on per-shard blocks: each block plus its routed
    ``W x - x``."""
    return [x + d for x, d in zip(blocks, routed.mix_delta(blocks))]


def routed_compressed_gossip(blocks, states, routed: RoutedEdges, *,
                             scores, gamma: float, kind: str, k: int,
                             error_feedback: bool):
    """Compressed sparse Eq. 5 on per-shard blocks: every shard's payload
    (``compression.compressed_payload`` on its own rows), then every
    shard's routed delta, then each shard's ``compressed_update`` ->
    (blocks, states). ``states``/``scores`` hold one entry a shard (None
    for a stateless codec, for a codec that draws no mask)."""
    sent = [compression.compressed_payload(
                x, e, error_feedback=error_feedback, kind=kind, k=k,
                scores=sc) for x, e, sc in zip(blocks, states, scores)]
    deltas = routed.mix_delta([pay for pay, _ in sent])
    mixed = [compression.compressed_update(
                 x, d, kind=kind, error_feedback=error_feedback,
                 gamma=gamma) for x, d in zip(blocks, deltas)]
    return mixed, [st for _, st in sent]


def gossip_edges_sharded_fn(mesh, worker_axes, src, dst, w,
                            num_workers: int):
    """Sparse edge-list gossip over a worker-sharded [W, P] stack, one
    [W / n_shards, P] block a shard of ``mesh``: returns f(blocks) ->
    mixed blocks, y_i = x_i + sum_{e: dst_e = i} w_e (x_{src_e} - x_i),
    each delta routed by shard offset (one ``gossip_edges`` launch per
    offset that carries edges into a shard). The mesh's shard count
    must divide W; ``worker_axes`` names the mesh's axis."""
    worker_shard_extent(mesh, worker_axes)
    devices = mesh.devices
    (routed,) = route_edges([(src, dst, w)], num_workers, devices)
    return functools.partial(routed_gossip, routed=routed)


def gossip_edges_compressed_sharded_fn(mesh, worker_axes, src, dst, w,
                                       num_workers: int, *,
                                       kind: str = "int8", k: int = 0,
                                       error_feedback: bool = True,
                                       seed: int = 0, gamma: float = 1.0):
    """Compressed edge-list gossip over a worker-sharded [W, P] stack:
    returns f(blocks, states, step) -> (mixed blocks, new states), the
    states following ``compression.state_init`` (None, or None per
    shard, for a stateless codec). Codec payloads are row-local — int8
    quantizes each row on the shared wire layout, top-k thresholds each
    row, rand-k draws the step's one shared mask (``randk_scores`` of
    ``seed``'s stream, uploaded once per distinct device) — so each shard
    encodes its own rows, and only the mixing delta crosses shards
    (``routed_compressed_gossip``).
    ``kind`` may carry its fraction (``"topk:0.05"``), resolved against
    P."""
    codec = compression.parse_mode(kind) if ":" in kind else None
    if codec is not None:
        kind = codec.kind
    worker_shard_extent(mesh, worker_axes)
    devices = mesh.devices
    (routed,) = route_edges([(src, dst, w)], num_workers, devices)
    skey = compression.sparsify_base_key(seed)

    def fn(blocks, states, step: int):
        p = blocks[0].shape[1]
        scores = (per_device(torch.from_numpy(
                      compression.randk_scores(skey, int(step), p)),
                      devices)
                  if kind == "randk" else [None] * len(blocks))
        return routed_compressed_gossip(
            blocks, [None] * len(blocks) if states is None else states,
            routed, scores=scores, gamma=gamma, kind=kind,
            k=codec.resolve_k(p) if codec is not None else k,
            error_feedback=error_feedback)

    return fn
