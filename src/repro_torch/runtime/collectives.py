"""Gossip collectives — the port of ``repro.runtime.collectives``: the
dense matching collectives of launch/train's round step and the
cross-shard edge gossip of the sharded DFL engines.

**Matching collectives** (``matchings_as_pairs``,
``matching_weight_tables``, ``gossip_fn``, ``gossip_compressed_fn``,
``ring_allreduce_mean_fn``). The reference edge-colours the round
topology into matchings and runs one ``lax.ppermute`` per matching over
the worker axes: worker i adds w_m[i] (x_partner − x_i) for each matching
m in turn, x the pre-gossip values. In the port the W workers' rows sit
in one [W, P] matrix on one device, and the whole sum is one
``gossip_mix`` launch laid out matching-major: u is the rows themselves
and w has K = M·W columns, worker i's weight for matching m at column
m·W + partner_m(i) (the kernel reads row k mod W for column k), so the
kernel adds the terms in the reference's matching order with its f32
rounding steps (a zero weight — another matching's columns, or an
unmatched worker — adds an exact zero): bit-equal to the reference's f32
arithmetic, without a partner permutation or a copy of the rows. On a
bf16 leaf the reference rounds each matching's term and sum to bf16,
which the kernel's bf16-rounded form does (a model of mixed leaf dtypes
runs both forms and takes each leaf's columns from its own). The
compressed gossip is the same launch with the decoded payload as u and
as the centre each term differs from, the accumulator starting at x
(the reference's ``a + w_m (ŷ_partner − ŷ_i)``), so it too rounds each
matching on a bf16 leaf. The
distances the reference measures are worker 0's to its partner in each
matching (its ``shard_map`` returns the first shard's value), one
``consensus_dist`` launch of row 0 against its partners' rows.
The functions take the flat [W, P] f32 matrix in the reference's leaf
order (``ModelAdapter``'s layout; the reference takes a tree of
worker-stacked leaves), with its leaves' column spans where they matter
(``leaf_spans``, and ``narrow_spans`` as ``ModelAdapter.narrow_spans``
gives them), and return f32; the mesh only sets the worker count. On a
model axis a worker's replica is a tuple of its slots' matrices
(``modelspec.SlotAdapter``): the gossip runs a slot at a time and the
distances add the slots' squared partials, as the reference's ``psum``
over the within-worker axes does.

**Sharded edge gossip** (``worker_shard_extent``, ``edge_shard_tables``,
``routed_mix_delta`` and the two sharded edge-gossip functions).

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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core import topology as topo
from repro_torch.kernels import ops
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import worker_shard_extent

__all__ = ["matchings_as_pairs", "matching_weight_tables",
           "matching_mix_weights", "gossip_fn", "gossip_compressed_fn",
           "ring_allreduce_mean_fn", "edge_shard_tables", "shard_csr", "routed_mix_delta",
           "RoutedEdges", "route_edges", "per_device",
           "routed_gossip", "routed_compressed_gossip",
           "gossip_edges_sharded_fn", "gossip_edges_compressed_sharded_fn",
           "worker_shard_extent"]


# ---------------------------------------------------------------------------
# dense matching collectives (launch/train's round step)
# ---------------------------------------------------------------------------

def matchings_as_pairs(adj: np.ndarray) -> list[list[tuple[int, int]]]:
    """Topology -> list of permutation pair-lists, one per matching of
    ``topology.matching_decomposition`` (each an involution, with
    identity pairs for unmatched workers so every destination is
    written): pairs[m][i] = (i, partner_m(i))."""
    n = adj.shape[0]
    matchings = topo.matching_decomposition(adj)
    perms = topo.matchings_to_perms(matchings, n)          # [M, N]
    return [[(int(i), int(row[i])) for i in range(n)] for row in perms]


def matching_weight_tables(adj: np.ndarray, mix: np.ndarray) -> np.ndarray:
    """[M, N] per-worker mixing weight for its partner in matching m (0
    where unmatched)."""
    n = adj.shape[0]
    matchings = topo.matching_decomposition(adj)
    w = np.zeros((len(matchings), n), np.float32)
    for m, match in enumerate(matchings):
        for (i, j) in match:
            w[m, i] = mix[i, j]
            w[m, j] = mix[j, i]
    return w


def matching_mix_weights(pairs, weight_table: np.ndarray) -> np.ndarray:
    """The ``gossip_mix`` weights of a matching-major mix, [W, M·W] f32:
    row i holds ``weight_table[m, i]`` at column m·W + partner_m(i)
    (column k weighting row k mod W), every other entry 0."""
    n = weight_table.shape[1]
    w = np.zeros((n, len(pairs) * n), np.float32)
    for m, perm in enumerate(pairs):
        for i, j in perm:
            w[i, m * n + j] = weight_table[m, i]
    return w


def _check_rows(x: torch.Tensor, num_workers: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] != num_workers:
        raise ValueError(f"expected the flat [{num_workers}, P] f32 matrix, "
                         f"got {tuple(x.shape)} {x.dtype}")


class _MixWeights:
    """A matching-major ``gossip_mix`` weight matrix, uploaded once per
    device; ``scale`` multiplies the table in f32 first (top-k's damping,
    the reference's ``gamma * w_m``)."""

    def __init__(self, pairs, weight_table, num_workers: int,
                 scale: float = 1.0):
        self.matchings = len(pairs)
        table = np.asarray(weight_table, np.float32).reshape(
            len(pairs), num_workers)
        self.host = torch.from_numpy(matching_mix_weights(
            pairs, np.float32(scale) * table))
        self.placed: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self.placed:
            self.placed[device] = self.host.to(device)
        return self.placed[device]


def matching_mix(rows: torch.Tensor, weights: _MixWeights,
                 narrow_spans=(), centre: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """rows [W, P] f32 -> rows_i + sum_m w_m[i] (u_partner - u_i), the
    matchings in order, u the ``centre`` (default the rows): one
    ``gossip_mix`` launch with u = c = the centre; the columns of
    ``narrow_spans`` (bf16 leaves) with each term and sum rounded to
    bf16 — one launch of the bf16-rounded form where they are every
    column, else both forms."""
    if weights.matchings == 0:
        return rows
    for _, _, dt in narrow_spans:
        if dt != torch.bfloat16:
            raise NotImplementedError(f"matching gossip on {dt} leaves: "
                                      "the reference's leaves are f32 or "
                                      "bf16")
    u = rows if centre is None else centre
    w = weights.on(rows.device)
    covered = sum(b - a for a, b, _ in narrow_spans)
    if covered == rows.shape[1]:
        return ops.gossip_mix(rows, u, w, centre=centre, round_bf16=True)
    out = ops.gossip_mix(rows, u, w, centre=centre)
    if narrow_spans:
        rounded = ops.gossip_mix(rows, u, w, centre=centre, round_bf16=True)
        for a, b, _ in narrow_spans:
            out[:, a:b] = rounded[:, a:b]
    return out


def worker0_distances(rows: torch.Tensor, pairs) -> torch.Tensor:
    """The reference's measured neighbour distances: ||x_0 - x_partner||
    for worker 0's partner in each matching (0 where it is unmatched),
    [M] f32, one ``consensus_dist`` launch."""
    if not pairs:
        return torch.zeros(0, dtype=torch.float32, device=rows.device)
    partners = torch.tensor([perm[0][1] for perm in pairs],
                            device=rows.device)
    return ops.consensus_dist(rows[0], rows.index_select(0, partners))


def slot_distances(slots, pairs) -> torch.Tensor:
    """Worker 0's distances over a model axis (``gossip_fn``'s, the
    reference's ``psum`` of each slot's squared partial over the
    within-worker axes): each slot's ``worker0_distances`` (one
    ``consensus_dist`` launch a slot) squared, added over the slots in
    order on slot 0's device, then the root. A leaf every slot holds
    whole counts once a slot, as in the reference. Squaring the kernel's
    root costs about 2 f32 ulps of each partial."""
    home = slots[0].device
    d2 = [worker0_distances(x, pairs).square().to(home) for x in slots]
    return torch.stack(d2).sum(dim=0).sqrt()


def gossip_fn(mesh, worker_axes: tuple[str, ...],
              pairs: list[list[tuple[int, int]]], weight_table: np.ndarray,
              *, measure_distances: bool = False, narrow_spans=()):
    """gossip(x) -> mixed, or (mixed, dists [M]) with
    ``measure_distances``: x the flat [W, P] f32 matrix, or a tuple of a
    model axis's slot matrices ([W, P_slot] each, ``SlotAdapter``'s
    layout), mixed a slot at a time (one ``gossip_mix`` launch a slot:
    the mix is elementwise, so it is the unsplit mix) with the distances
    summed over the slots (``slot_distances``); ``narrow_spans`` the
    bf16 leaves' columns (module doc; a slot's, on a model axis). The
    reference's ``param_specs`` argument is the slots' layout."""
    n = sharding.mesh_workers(mesh, worker_axes)
    weights = _MixWeights(pairs, weight_table, n)

    def gossip(x):
        if isinstance(x, (tuple, list)):
            for slot in x:
                _check_rows(slot, n)
            mixed = tuple(matching_mix(slot, weights, narrow_spans)
                          for slot in x)
            if measure_distances:
                return mixed, slot_distances(x, pairs)
            return mixed
        _check_rows(x, n)
        mixed = matching_mix(x, weights, narrow_spans)
        if measure_distances:
            return mixed, worker0_distances(x, pairs)
        return mixed

    return gossip


def gossip_compressed_fn(mesh, worker_axes: tuple[str, ...],
                         pairs: list[list[tuple[int, int]]],
                         weight_table: np.ndarray, *, mode: str = "int8",
                         seed: int = 0, gamma: float = 0.25,
                         leaf_spans=None, narrow_spans=()):
    """Compressed gossip with the core codecs, per leaf as the reference
    applies them: returns gossip(x, err, step) -> (mixed, new_err) on the
    flat [W, P] f32 matrix, its leaves the column spans ``leaf_spans``
    ((start, stop) in the reference's leaf order; default one leaf).

    - ``"int8"``: each leaf's z = x + e is quantized on its own wire tiles
      (one ``quantize_block`` and one ``dequantize_block`` launch a leaf),
      the residual e' = z - ŷ carries, and x' = x + sum_m w_m (ŷ_partner -
      ŷ_i);
    - ``"topk:<k>"``: x̂-tracking, k resolved per leaf, q = topk(x - x̂),
      x̂' = x̂ + q (the new err), x' = x + sum_m (gamma w_m) (x̂'_partner -
      x̂'_i);
    - ``"randk:<k>"``: each leaf ships the coordinates of its shared mask,
      drawn from ``sparsify_base_key(seed)`` folded with the leaf's index
      and ``step`` (``randk_scores``); err passes through unchanged.

    The mix is one matching-major ``gossip_mix`` launch from x with the
    payload as u and centre; on the columns of ``narrow_spans`` (bf16
    leaves) each matching's term and sum round to bf16, as the
    reference's do. ``err`` is a [W, P] f32 matrix, or None for zeros (a
    fresh residual, as the reference's train step passes every round).
    On a model axis x (and err) is a tuple of the slots' matrices, each
    coded on its own pieces (``leaf_spans`` a slot's): the reference
    codes a leaf shard at a time, so a tile follows the piece."""
    codec = compression.parse_mode(mode)
    if codec.kind == "none":
        raise ValueError("use gossip_fn for uncompressed exchange")
    if codec.kind == "leafmap":
        raise ValueError("gossip_compressed_fn takes a uniform codec")
    n = sharding.mesh_workers(mesh, worker_axes)
    weights = _MixWeights(pairs, weight_table, n,
                          gamma if codec.kind == "topk" else 1.0)
    skey = compression.sparsify_base_key(seed)

    def gossip(x, err, step: int = 0):
        if isinstance(x, (tuple, list)):       # a model axis: each slot's
            out = [gossip(slot, None if err is None else e, step)   # pieces
                   for slot, e in zip(x, err or [None] * len(x))]
            return tuple(y for y, _ in out), \
                None if err is None else tuple(e for _, e in out)
        _check_rows(x, n)
        if err is not None:
            _check_rows(err, n)
        payload = torch.empty_like(x)
        new_err = err if codec.kind == "randk" else torch.empty_like(x)
        for idx, (a, b) in enumerate(leaf_spans or [(0, x.shape[1])]):
            z = x[:, a:b]
            e = None if err is None else err[:, a:b]
            if codec.kind == "int8":
                z = (z if e is None else z + e).contiguous()
                q, scales = ops.quantize_block(z)
                payload[:, a:b] = ops.dequantize_block(q, scales, b - a)
                new_err[:, a:b] = z - payload[:, a:b]
            elif codec.kind == "topk":
                e = torch.zeros_like(z) if e is None else e
                q = compression.sparsify_rows((z - e).contiguous(), "topk",
                                              codec.resolve_k(b - a))
                new_err[:, a:b] = e + q
                payload[:, a:b] = new_err[:, a:b]
            else:
                scores = torch.from_numpy(compression.randk_scores(
                    compression._fold_in(skey, idx), int(step), b - a))
                payload[:, a:b] = compression.sparsify_rows(
                    z.contiguous(), "randk", codec.resolve_k(b - a),
                    scores=scores.to(x.device))
        return matching_mix(x, weights, narrow_spans, centre=payload), new_err

    return gossip


def ring_allreduce_mean_fn(mesh, worker_axes: tuple[str, ...]):
    """Dense baseline: every worker takes the fleet average (what a
    parameter-server / all-reduce system does) -> f(x) on the flat
    [W, P] f32 matrix."""
    n = sharding.mesh_workers(mesh, worker_axes)

    def allreduce(x):
        _check_rows(x, n)
        return x.mean(dim=0, keepdim=True).expand_as(x).contiguous()

    return allreduce


# ---------------------------------------------------------------------------
# sharded edge gossip (the sharded DFL engines)
# ---------------------------------------------------------------------------

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
