"""The fused engines — the port of ``repro.core.fused``'s single-lane
dense path: ``run_dfl_fused`` next to ``engine.run_dfl`` and
``run_adpsgd_fused`` next to ``engine.run_adpsgd``.

The host precomputes a segment of K rounds (cluster, strategy and batch
streams advanced in the reference engine's exact order) and ships its
control inputs to the device at once; the device then runs the K rounds
as a Python loop over device tensors with no host sync inside — each
round's metrics stay on the device and come to the host once, at the
segment's end (the reference lowers the same loop to one
``jax.lax.scan``).

- Static-plan strategies (D-PSGD ring, LD-SGD alternation, the base
  strategy) run in segments of up to ``MAX_FUSE_ROUNDS`` rounds and take
  no measurements.
- Adaptive strategies (FedHP, PENS) run in segments of
  ``cfg.replan_every`` rounds with the plan frozen per segment; the
  Alg. 1 measurements surface at the segment's end, where the strategy's
  ``observe`` is replayed round by round. ``replan_every=1`` replans
  every round exactly like the reference engine.
- Gossip (Eq. 5-6) runs on communicating rounds only. Uncompressed, it
  goes through the hand-written ``gossip_mix`` CUDA kernel
  (``kernels/ops.py``) on the flat ``[W, P]`` matrix as
  y_i = x_i + sum_j w_ij (x_j - x_i), one launch per round (the
  reference engine mixes as sum_j w_ij x_j; the two differ in the last
  ulp), or under ``cfg.gossip="sparse"`` through the ``gossip_edges``
  kernel over the round's CSR edge list (no [W, W] matrix is built).
  Under ``cfg.compress`` the codec's compensated update
  (``compression.compressed_gossip_ref``) runs instead: its round trip
  through the quantize/dequantize or sparsify kernels, one launch each
  per round, the mixing delta dense or through ``gossip_edges``, and
  its [W, P] state carried on the device across segments. The
  segment's codec is frozen with its plan; rand-k masks are drawn on
  the host and shipped with the segment.
- The Byzantine scenario axis (``core/robust.py``): attackers' rows are
  corrupted on the wire; trimmed/median rounds go through the
  ``robust_gossip`` kernel over the round's padded neighbour table
  (dense and sparse gossip alike), the attacked baseline through
  ``gossip_mix`` or ``gossip_edges`` over the lying wire. Metrics cover
  the honest alive workers.
- ``cfg.compress="leafmap:..."`` (a per-leaf codec map compiled against
  the adapter's leaf layout): each leaf segment's payload through its
  codec's kernels, one mixing delta on the combined payload, the top-k
  segments' step damped by ``sparse_gamma``.
- Churn masks (join blend, codec-state reset, alive-weighted metrics)
  are per-round device inputs.
- AD-PSGD: the host schedule (``engine.adpsgd_schedule``) fixes every
  event; a segment of ``ADPSGD_FUSE_ROUNDS`` rounds ships its batches at
  once and replays its events on the device, the uncompressed pairwise
  average through ``gossip_mix`` on one row with weight ½ — over a lying
  wire, or screened, both endpoints' rows in one launch, with the
  verdicts and the screening history on the device and the rejection
  counts shipped once per segment.

- ``seeds=[s_1, ..., s_S]`` runs S experiments as lanes of one batch,
  returning one ``History`` per lane: each lane takes its seed for the
  model init and its batch stream, and the lanes share the data split,
  the cluster draws, the (static) plans, the AD-PSGD event schedule and
  the rand-k key (all from ``cfg.seed``), so the lane whose seed is
  ``cfg.seed`` reproduces the unbatched run. Params and codec state are
  [S, W, P] on the device; the model passes take the S·W workers at
  once, the codec kernels take the lanes as rows, ``gossip_edges`` and
  ``robust_gossip`` the block-diagonal fleet (the round's edge list or
  neighbour table repeated with indices offset by lane·W, each row's
  sum in the same order), and ``gossip_mix`` its lane-strided form: one
  launch per round (per event) for all lanes.

- ``mesh=`` (or ``cfg.sharded``): the sharded twin,
  ``_scan_segment_sharded``, the [W, P] matrix split over a worker mesh's
  shards (``runtime/shardexec``), gossip over the round's edge list
  routed by shard offset through ``gossip_edges``.

CUDA graphs are not ported yet (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import FedHPConfig
from repro_torch.core import compression
from repro_torch.core import modelspec
from repro_torch.core import robust
from repro_torch.core.algorithms import Strategy
from repro_torch.core.compression import Codec
from repro_torch.core.engine import (AdpsgdSchedule, History, RoundRecord,
                                     _blend_joined,
                                     _cross_loss_matrix, _draw_batches,
                                     _fleet_metrics, _local_train, _measure,
                                     adpsgd_event, adpsgd_event_lying,
                                     adpsgd_join,
                                     adpsgd_setup, check_ported,
                                     codec_scores, edge_distances,
                                     eval_batches, holdout_set,
                                     initial_params, mixing_fn,
                                     resolve_device, round_batches,
                                     round_clock, round_codec, round_edges,
                                     round_topology, run_codec, shard_plan,
                                     sharded_start)
from repro_torch.data.synthetic import Dataset
from repro_torch.kernels import ops
from repro_torch.runtime import collectives
from repro_torch.simulation.cluster import SimCluster

# static-plan strategies would otherwise stage the whole horizon's batch
# tensors at once ([K, W, tau, B, D] f32); segments of 64 rounds bound
# that with no semantic difference (static plans are recomputed per round
# either way)
MAX_FUSE_ROUNDS = 64

# AD-PSGD stages one batch tensor PER EVENT ([K, N, tau, B, D] — an extra
# N factor over the synchronous engine), so its segments are shorter
ADPSGD_FUSE_ROUNDS = 32


# ---------------------------------------------------------------------------
# host code: segment precompute replaying the reference engine's streams
# ---------------------------------------------------------------------------

@dataclass
class _Segment:
    """Per-round control inputs + host-side record fields for K rounds."""
    bx: np.ndarray            # [K, S, W, T, B, D] f32 (S lanes)
    by: np.ndarray            # [K, S, W, T, B] i64
    taus: np.ndarray          # [K, W] i64
    lrs: np.ndarray           # [K] f32
    mixes: np.ndarray | None  # [K, W, W] f32 (identity without comm);
    #                           None when sparse
    edges: tuple | None       # sparse: the lanes' block-diagonal CSR
    #                           ([K, S·W+1], [K, S·E], [K, S·E])
    nbrs: np.ndarray | None   # robust: [K, S·W, D] i32 neighbour tables
    degs: np.ndarray | None   # robust: [K, S·W] i32 degrees
    ew: np.ndarray            # [K, W] f32  eval (accuracy/loss) weights
    cw: np.ndarray            # [K, W] f32  consensus weights
    keep: np.ndarray          # [K, W] bool join re-init mask
    rw: np.ndarray            # [K, W] f32  donor weights
    comm: np.ndarray          # [K] bool: the round gossips
    gates: np.ndarray | None  # [K, P] f32 rand-k mask draws (else None)
    codec: object             # the segment's frozen wire codec
    wire_ratio: list[float]   # [K] Eq. 10 comm divisor charged per round
    tau_cap: int
    alive: list[np.ndarray]
    meas: list[np.ndarray]     # the honest alive workers (the metrics')
    adjs: list[np.ndarray]
    mus: list[np.ndarray]
    betas: list[np.ndarray]
    round_time: list[float]
    waiting: list[float]
    mean_tau: list[float]
    num_links: list[int]
    cum_time: list[float]

    def __len__(self) -> int:
        return len(self.round_time)


def lane_csr(csr, lanes: int, n: int):
    """The block-diagonal fleet of ``lanes`` lanes as one CSR edge list:
    the round's (row_ptr [W + 1], col, w) repeated, lane l's rows and
    sources offset by l·W, each row's edges in the round's order (so a
    kernel's per-row sum is the single lane's, bit for bit)."""
    if lanes == 1:
        return csr
    row_ptr, col, w = csr
    e = int(row_ptr[n])
    lane = np.arange(lanes)[:, None]
    rp = np.append((row_ptr[:n][None] + lane * e).reshape(-1), lanes * e)
    return (rp.astype(np.int32),
            (col[:e][None] + lane * n).reshape(-1).astype(np.int32),
            np.tile(w[:e], lanes).astype(np.float32))


def lane_table(nbr: np.ndarray, deg: np.ndarray, lanes: int):
    """A neighbour table (nbr [W, D], deg [W]) over the block-diagonal
    fleet of ``lanes`` lanes: [S·W, D] with lane l's entries offset by
    l·W (the padding slots past deg are never read)."""
    n = nbr.shape[0]
    return (np.concatenate([nbr + l * n for l in range(lanes)]),
            np.tile(deg, lanes))


def _precompute_segment(h0: int, seg_len: int, cluster: SimCluster,
                        strategy: Strategy, cfg: FedHPConfig, rngs, data,
                        shards, mixing: str, clock: float,
                        time_budget: float | None, adaptive: bool,
                        codec0, p_model: int, skey,
                        scen: robust.Scenario, sparse: bool):
    """Advance cluster/strategy/batch RNG streams for rounds h0..h0+K-1 in
    the exact order ``run_dfl`` would, and pack the device inputs.

    ``rngs`` holds one batch stream per lane; every other input is the
    lanes' shared control plane. For an adaptive strategy the plan is
    frozen at the segment's first round; static strategies re-plan every
    round (observation-free, so this is exactly the reference behavior).
    The frozen plan also fixes the segment's wire codec (``plan.codec``,
    else ``codec0``, the parsed ``cfg.compress``; always ``codec0`` for a
    compiled leafmap), whose ``wire_ratio(p_model)`` divides the Eq. 10
    comm term as in the reference engine; rand-k rounds (and a leafmap's
    rand-k segments) draw their masks here, from ``skey``, on the host.

    Under ``sparse`` (``cfg.gossip="sparse"``, and always on the sharded
    path) each round's topology ships as a CSR edge list
    (``engine.round_edges``, stably sorted by destination) and
    no [W, W] matrix is built; a robust mode ships each round's padded
    neighbour table (``robust.neighbor_table``), padded to one D per
    segment rounded up to a power of two (one kernel instance). Both are
    repeated over the lanes as one block-diagonal fleet. The metric
    weights cover the honest alive workers (``scen.honest``)."""
    n = cfg.num_workers
    lanes = len(rngs)
    compress = codec0.kind != "none"
    robust_mode = scen.mode in ("trimmed", "median")
    drifting = hasattr(shards, "shards_at")
    per: list[dict] = []
    plan = None
    stop = False
    for t in range(seg_len):
        h = h0 + t
        alive = cluster.advance_round(h)
        joined = cluster.last_joined.copy()
        crashed = bool(cluster.last_crashed.any())
        mu = cluster.sample_mu()
        beta = cluster.sample_beta()
        if plan is None or not adaptive:
            plan = strategy.plan(h, alive=alive)
        rcodec = round_codec(plan, codec0)
        comm_ratio = rcodec.wire_ratio(p_model) if compress else 1.0
        adj = round_topology(plan, alive, beta)
        taus = np.where(alive, np.clip(plan.taus, 1, cfg.tau_max), 0)
        tau_cap = int(max(taus.max(), 1))
        sh = shards.shards_at(h) if drifting else shards
        batches = [_draw_batches(rng, data, sh, tau_cap, cfg.batch_size)
                   for rng in rngs]

        # --- clock (Eq. 10-11), the reference engine's formulas ---
        t_round, waiting = round_clock(adj, taus, mu, beta, plan, alive,
                                       crashed, cfg.crash_timeout,
                                       comm_ratio)
        clock += t_round

        # --- device-side control inputs ---
        comm = adj.sum() > 0
        mix = edges = nbr = deg = None
        if robust_mode:
            nbr, deg = robust.neighbor_table(adj)
        elif sparse:
            edges = lane_csr(
                round_edges(adj, mixing) if comm else
                (np.zeros(n + 1, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32)), lanes, n)
        else:
            mix = mixing_fn(mixing)(adj) if comm else np.eye(n)
        donors = alive & ~joined
        do_reinit = joined.any() and donors.any()
        keep = joined if do_reinit else np.zeros(n, bool)
        rw = donors / max(donors.sum(), 1.0) if do_reinit else np.zeros(n)
        meas = scen.honest(alive)
        if meas.any() and not meas.all():
            ew = meas / meas.sum()
        else:
            ew = np.full(n, 1.0 / n)
        cw = meas / meas.sum() if meas.any() else np.full(n, 1.0 / n)

        per.append(dict(alive=alive, meas=meas, adj=adj, mu=mu, beta=beta,
                        taus=taus, tau_cap=tau_cap, batches=batches,
                        mix=mix, edges=edges, nbr=nbr, deg=deg,
                        keep=keep, rw=rw, ew=ew, cw=cw,
                        gate=codec_scores(codec0, skey, h, p_model),
                        comm=comm, codec=rcodec,
                        wire_ratio=comm_ratio,
                        lr=cfg.lr * (cfg.lr_decay ** h),
                        t_round=t_round, waiting=waiting,
                        mean_tau=float(taus[alive].mean())
                        if alive.any() else 0.0,
                        num_links=int(adj.sum() // 2), cum=clock))
        if time_budget is not None and clock >= time_budget:
            stop = True
            break

    # the segment's tau extent, bucketed to the next power of two like
    # the reference (the masked step makes the extra iterations no-ops)
    cap = max(p["tau_cap"] for p in per)
    cap = 1 << (cap - 1).bit_length() if cap > 1 else 1

    def pad(b, tc):
        return np.pad(b, ((0, 0), (0, cap - tc)) + ((0, 0),) * (b.ndim - 2))

    def pad_to(a, size):
        # entries past a round's own are never read: past row_ptr[W] in
        # an edge list, past deg[i] in a neighbour table
        return np.pad(a, ((0, 0),) * (a.ndim - 1) + ((0, size - a.shape[-1]),))

    def pow2(v):
        return 1 << (v - 1).bit_length() if v > 1 else 1

    edges = nbrs = degs = None
    if sparse and not robust_mode:
        # one E per segment, bucketed to a power of two like tau_cap
        e_max = pow2(max(len(p["edges"][1]) for p in per))
        edges = (np.stack([p["edges"][0] for p in per]),
                 np.stack([pad_to(p["edges"][1], e_max) for p in per]),
                 np.stack([pad_to(p["edges"][2], e_max) for p in per]))
    if robust_mode:
        d_max = pow2(max(p["nbr"].shape[1] for p in per))
        tables = [lane_table(pad_to(p["nbr"], d_max), p["deg"], lanes)
                  for p in per]
        nbrs = np.stack([nb for nb, _ in tables])
        degs = np.stack([dg for _, dg in tables])

    seg = _Segment(
        bx=np.stack([np.stack([pad(b[0], p["tau_cap"])
                               for b in p["batches"]]) for p in per]),
        by=np.stack([np.stack([pad(b[1], p["tau_cap"])
                               for b in p["batches"]])
                     for p in per]).astype(np.int64),
        taus=np.stack([p["taus"] for p in per]).astype(np.int64),
        lrs=np.array([p["lr"] for p in per], np.float32),
        mixes=(np.stack([p["mix"] for p in per]).astype(np.float32)
               if per[0]["mix"] is not None else None),
        edges=edges, nbrs=nbrs, degs=degs,
        ew=np.stack([p["ew"] for p in per]).astype(np.float32),
        cw=np.stack([p["cw"] for p in per]).astype(np.float32),
        keep=np.stack([p["keep"] for p in per]),
        rw=np.stack([p["rw"] for p in per]).astype(np.float32),
        comm=np.array([p["comm"] for p in per]),
        gates=(np.stack([p["gate"] for p in per])
               if per[0]["gate"] is not None else None),
        codec=per[0]["codec"],
        wire_ratio=[p["wire_ratio"] for p in per],
        tau_cap=cap,
        alive=[p["alive"] for p in per], meas=[p["meas"] for p in per],
        adjs=[p["adj"] for p in per],
        mus=[p["mu"] for p in per], betas=[p["beta"] for p in per],
        round_time=[p["t_round"] for p in per],
        waiting=[p["waiting"] for p in per],
        mean_tau=[p["mean_tau"] for p in per],
        num_links=[p["num_links"] for p in per],
        cum_time=[p["cum"] for p in per])
    return seg, clock, stop


# ---------------------------------------------------------------------------
# device code: the K rounds of one segment
# ---------------------------------------------------------------------------

def _mix_lanes(x: torch.Tensor, u: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Eq. 5 on each lane through the ``gossip_mix`` kernel: x [S, B, L],
    u [S, K, L], one mixing matrix w [B, K] shared by the lanes. One lane
    launches the single form, more the lane-strided form (bit-equal)."""
    if x.shape[0] == 1:
        return ops.gossip_mix(x[0], u[0], w)[None]
    return ops.gossip_mix_lanes(x, u, w.expand(x.shape[0], *w.shape))


def _round_metrics(adapter, flat, tx, ty, ew, cw) -> dict:
    """Per lane, fleet accuracy/loss over the alive workers (weights
    ``ew``) and the consensus distance to the alive mean (weights
    ``cw``), on the device: flat [S, W, P] -> each metric [S]. The model
    evaluates the S·W workers in one pass."""
    lanes, n, p = flat.shape
    accs, tloss = _fleet_metrics(adapter, flat.reshape(lanes * n, p), tx,
                                 ty)
    accs, tloss = accs.view(lanes, n), tloss.view(lanes, n)
    out = dict(acc=[], loss=[], consensus=[])
    for s in range(lanes):
        dmean = cw @ flat[s]
        dists = torch.sqrt(torch.sum((flat[s] - dmean[None]) ** 2, dim=1))
        out["acc"].append(ew @ accs[s])
        out["loss"].append(ew @ tloss[s])
        out["consensus"].append(cw @ dists)
    return {k: torch.stack(v) for k, v in out.items()}


def _gossip_round(flat, err, seg: _Segment, t: int, dev_in: dict,
                  scen: robust.Scenario, *, k: int, ef: bool,
                  gamma: float):
    """One communicating round's gossip on the device, on S lanes ->
    (flat, err), flat [S, W, P] and err [S, W, P] or None:

    - a robust mode (trimmed/median, dense or sparse gossip alike): the
      ``robust_gossip`` kernel over the round's neighbour table (the
      lanes' block-diagonal one), the attackers' rows corrupted on the
      wire;
    - attackers without one (the attacked baseline): Eq. 5 over the lying
      wire through ``gossip_edges`` (sparse) or ``gossip_mix`` with the
      mix's diagonal zeroed (dense: x_i + sum_{j != i} W_ij (T_j - x_i)
      is W_ii x_i + sum_{j != i} W_ij T_j);
    - a codec (uniform or a leafmap): its compensated update on the
      lanes' rows, the mixing delta through ``gossip_edges(v, v) - v``
      (sparse) or each lane's dense product;
    - honest and uncompressed: ``gossip_edges`` (sparse) or
      ``gossip_mix`` (row b of the mixing matrix as the kernel's
      neighbour weights over all W rows)."""
    lanes, n, p = flat.shape
    rows = flat.reshape(lanes * n, p)
    edges = (tuple(a[t] for a in dev_in["edges"])
             if dev_in["edges"] is not None else None)
    if scen.active:
        transmitted = (robust.apply_attack(flat, dev_in["byz"], scen.scale,
                                           kind=scen.attack)
                       if scen.has_byz else flat)
        sent = transmitted.reshape(lanes * n, p)
        if scen.mode != "none":
            return ops.robust_gossip(rows, sent, dev_in["nbrs"][t],
                                     dev_in["degs"][t], b=scen.knob,
                                     mode=scen.mode).view(lanes, n, p), err
        if edges is not None:
            return ops.gossip_edges(rows, sent, *edges).view(lanes, n,
                                                             p), err
        return _mix_lanes(flat, transmitted,
                          dev_in["mixes"][t] * dev_in["off_diag"]), err
    codec = seg.codec
    if codec.kind != "none":
        if edges is not None:
            def delta(v):
                return ops.gossip_edges(v, v, *edges) - v
        else:
            mix = dev_in["mixes"][t]

            def delta(v):
                if lanes == 1:
                    return torch.matmul(mix, v) - v
                return torch.cat([torch.matmul(mix, vs) - vs
                                  for vs in v.view(lanes, n, p)])
        state = None if err is None else err.reshape(lanes * n, p)
        scores = dev_in["gates"][t] if dev_in["gates"] is not None else None
        if codec.kind == "leafmap":
            rows, state = compression.leafmap_gossip_ref(
                rows, state, None, codec, error_feedback=ef, scores=scores,
                gamma=gamma, mix_delta_fn=delta)
        else:
            rows, state = compression.compressed_gossip_ref(
                rows, state, None, error_feedback=ef, kind=codec.kind, k=k,
                scores=scores, gamma=gamma, mix_delta_fn=delta)
        return (rows.view(lanes, n, p),
                None if state is None else state.view(lanes, n, p))
    if edges is not None:
        return ops.gossip_edges(rows, rows, *edges).view(lanes, n, p), err
    return _mix_lanes(flat, flat, dev_in["mixes"][t]), err


def _scan_segment(adapter, flat, err, seg: _Segment, ex, ey, px, py, tx, ty,
                  *, measure: bool, needs_cross: bool, k: int, ef: bool,
                  gamma: float, scen: robust.Scenario):
    """Run the segment's rounds on ``flat``'s device with no host sync
    (the reference's ``lax.scan`` body as a Python loop); returns
    (flat', err', outs) where outs maps each metric to a host array with
    a leading [K] round axis ([K, S] for the per-lane metrics). ``flat``
    is the lanes' params [S, W, P], ``err`` the codec state [S, W, P]
    (None for stateless runs); ``k`` the segment codec's resolved keep
    count. The measurements (an adaptive strategy, one lane) read lane
    0."""
    dev = flat.device
    lanes, n, p = flat.shape
    bx = torch.as_tensor(seg.bx, device=dev)
    by = torch.as_tensor(seg.by, device=dev)
    taus, lrs, ew, cw, keep, rw = (
        torch.as_tensor(a, device=dev)
        for a in (seg.taus, seg.lrs, seg.ew, seg.cw, seg.keep, seg.rw))

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    off_diag = 1.0 - torch.eye(n, device=dev) \
        if scen.has_byz and seg.mixes is not None else None
    dev_in = dict(mixes=on_dev(seg.mixes), gates=on_dev(seg.gates),
                  nbrs=on_dev(seg.nbrs), degs=on_dev(seg.degs),
                  edges=(tuple(on_dev(a) for a in seg.edges)
                         if seg.edges is not None else None),
                  byz=on_dev(scen.byz), off_diag=off_diag)
    outs: dict[str, list] = {}

    def emit(**kw):
        for key, v in kw.items():
            outs.setdefault(key, []).append(v)

    for t in range(len(seg)):
        # --- join re-init (keep/donor weights precomputed host-side) and
        # the joined rows' codec state reset as in the reference engine;
        # the host knows the rounds nobody joins, where both are no-ops ---
        if seg.keep[t].any():
            flat = adapter.round_leaves(_blend_joined(flat, keep[t], rw[t]))
            if err is not None:
                err = compression.codec_state_after_join(
                    err, keep[t][:, None], flat, seg.codec, ef)
        prev = flat

        # --- local updating (Eq. 3), masked to tau_i, the S·W workers in
        # one pass ---
        flat = _local_train(adapter, flat.reshape(lanes * n, p),
                            bx[t].reshape(lanes * n, *bx.shape[3:]),
                            by[t].reshape(lanes * n, *by.shape[3:]),
                            taus[t].repeat(lanes), lrs[t],
                            seg.tau_cap).view(lanes, n, p)

        # --- gossip (Eq. 5-6) on communicating rounds only (the host
        # knows which), through the kernels ---
        if seg.comm[t]:
            flat, err = _gossip_round(flat, err, seg, t, dev_in, scen, k=k,
                                      ef=ef, gamma=gamma)
            flat = adapter.round_leaves(flat)

        emit(**_round_metrics(adapter, flat, tx, ty, ew[t], cw[t]))
        if measure:
            f0 = flat[0]
            losses, ls, sigs, upds = _measure(adapter, f0, prev[0], ex, ey,
                                              px, py)
            emit(losses=losses, ls=ls, sigs=sigs, upds=upds,
                 edge=edge_distances(f0))
            if needs_cross:
                emit(cross=_cross_loss_matrix(adapter, f0, ex[:, :64],
                                              ey[:, :64]))
    return flat, err, {key: torch.stack(v).cpu().numpy()
                       for key, v in outs.items()}


# ---------------------------------------------------------------------------
# device code: the sharded twin — the segment's rounds on a worker mesh
# ---------------------------------------------------------------------------

def _sharded_edge_tables(seg: _Segment, plan) -> list:
    """Each round's CSR edge list (``seg.edges``) routed over the plan's
    shards by shard offset (``runtime/collectives.route_edges``): one
    ``RoutedEdges`` a round, the segment's tables uploaded at once."""
    n = plan.num_workers
    row_ptr, col, w = seg.edges
    lists = []
    for t in range(len(seg)):
        e = int(row_ptr[t, n])
        lists.append((col[t, :e], np.repeat(np.arange(n), np.diff(
            row_ptr[t])), w[t, :e]))
    return plan.route(lists)


def _scan_segment_sharded(adapter, blocks, errs, seg: _Segment, plan,
                          evals, holds, *, measure: bool, k: int, ef: bool,
                          gamma: float):
    """``_scan_segment`` with the [W, P] matrix split over ``plan``'s
    shards (``runtime/shardexec``), one lane, no host sync: per round and
    shard the join blend (its fleet mean the sum of per-shard partial
    products), the local steps, the codec on the shard's own rows and the
    routed gossip delta (``gossip_edges`` once per offset that carries
    edges into the shard), and the fleet metrics as sums of per-shard
    partials on the first shard's device. ``blocks``/``errs`` hold one
    [rows, P] block a shard (``errs`` None for a stateless codec);
    ``evals``/``holds`` the eval stacks and holdout set on each shard's
    device. Measure mode gathers the rows once per round for the [W, W]
    edge distances. Returns (blocks', errs', outs) as ``_scan_segment``
    with one lane, the padding rows sliced off."""
    n = plan.num_workers
    routes = _sharded_edge_tables(seg, plan)
    bx = plan.put_host(seg.bx[:, 0], axis=1)
    by = plan.put_host(seg.by[:, 0], axis=1)
    taus, ew, cw, keep, rw = (plan.put_host(a, axis=1) for a in (
        seg.taus, seg.ew, seg.cw, seg.keep, seg.rw))
    lrs = plan.replicate(torch.from_numpy(seg.lrs))
    gates = (plan.replicate(torch.from_numpy(seg.gates))
             if seg.gates is not None else None)
    codec = seg.codec
    outs: dict[str, list] = {}

    def emit(**kw):
        for key, v in kw.items():
            outs.setdefault(key, []).append(v)

    for t in range(len(seg)):
        if seg.keep[t].any():
            blocks = [adapter.round_leaves(b) for b in plan.blend(
                blocks, [kp[t] for kp in keep], [r[t] for r in rw])]
            if errs is not None:
                errs = [compression.codec_state_after_join(
                            e, kp[t][:, None], b, codec, ef)
                        for e, kp, b in zip(errs, keep, blocks)]
        prev = blocks
        blocks = [_local_train(adapter, b, bx[s][t], by[s][t], taus[s][t],
                               lrs[s][t], seg.tau_cap)
                  for s, b in enumerate(blocks)]
        if seg.comm[t]:
            if codec.kind != "none":
                blocks, states = collectives.routed_compressed_gossip(
                    blocks, errs or [None] * len(blocks), routes[t],
                    scores=[None] * len(blocks) if gates is None
                    else [g[t] for g in gates],
                    gamma=gamma, kind=codec.kind, k=k, error_feedback=ef)
                errs = None if errs is None else states
            else:
                blocks = collectives.routed_gossip(blocks, routes[t])
            blocks = [adapter.round_leaves(b) for b in blocks]

        fleet = [_fleet_metrics(adapter, b, *hd)
                 for b, hd in zip(blocks, holds)]
        dmean = plan.replicate(plan.psum([c[t] @ b
                                          for c, b in zip(cw, blocks)]))
        dists = [torch.sqrt(torch.sum((b - m[None]) ** 2, dim=1))
                 for b, m in zip(blocks, dmean)]
        emit(acc=plan.psum([e[t] @ f[0] for e, f in zip(ew, fleet)])[None],
             loss=plan.psum([e[t] @ f[1] for e, f in zip(ew, fleet)])[None],
             consensus=plan.psum([c[t] @ d
                                  for c, d in zip(cw, dists)])[None])
        if measure:
            parts = [_measure(adapter, b, q, *ev)
                     for b, q, ev in zip(blocks, prev, evals)]
            losses, ls, sigs, upds = (plan.gather([p[i] for p in parts])[:n]
                                      for i in range(4))
            emit(losses=losses, ls=ls, sigs=sigs, upds=upds,
                 edge=edge_distances(plan.unpad(blocks)))
    return blocks, errs, {key: torch.stack(v).cpu().numpy()
                          for key, v in outs.items()}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def seed_lanes(cfg: FedHPConfig, seeds, init_params) -> list[int]:
    """The lanes' seeds: ``cfg.seed`` alone unbatched, else ``seeds``
    flattened — raising the reference's ``ValueError`` for
    ``init_params`` (one run's weights) with a batched axis."""
    if seeds is None:
        return [int(cfg.seed)]
    if init_params is not None:
        raise ValueError(
            "init_params resumes ONE run's stacked params; it does not "
            "compose with a batched seeds axis")
    return [int(s) for s in np.asarray(seeds).reshape(-1)]


def run_dfl_fused(data: Dataset, test_x, test_y, shards,
                  cluster: SimCluster, cfg: FedHPConfig, strategy: Strategy,
                  *, rounds: int | None = None, hidden: int = 64,
                  eval_subset: int = 512, mixing: str = "uniform",
                  time_budget: float | None = None, seeds=None,
                  adapter: modelspec.ModelAdapter | None = None,
                  init_params=None, mesh=None, device=None):
    """Drop-in fused replacement for ``engine.run_dfl``: one experiment
    from ``cfg.seed``, returning a ``History`` that matches the reference
    engine's — host fields exactly, device metrics to float tolerance.
    ``adapter`` and ``init_params`` as in ``engine.run_dfl``.

    With ``seeds`` (an array of S ints) returns ``list[History]``, one per
    lane, batched on the device (module docstring). Static-plan
    strategies only when S > 1: an adaptive plan is feedback from one
    lane's trajectory. ``device``: ``None`` means the GPU (raises without
    one); ``"cpu"`` runs the same loop with the kernels' plain
    versions.

    ``mesh`` (a ``launch/mesh.WorkerMesh``) or ``cfg.sharded`` runs the
    segments through ``_scan_segment_sharded``: the [W, P] matrix splits
    over the mesh's shards, gossip takes the edge-list form routed by
    shard offset, and the host control plane is the unsharded run's. One
    lane only (no batched ``seeds``); PENS and per-leaf codec maps are
    excluded, as ``engine.run_dfl``'s sharded path excludes them."""
    check_ported(cfg, mesh=mesh, seeds=seeds)
    plan = shard_plan(cfg, mesh, device)
    device = resolve_device(device) if plan is None else plan.first
    if plan is not None and strategy.name == "pens":
        raise ValueError(
            "pens needs the [W, W] cross-loss matrix every round; "
            "the sharded path excludes it (engine.run_dfl contract)")
    scen = robust.scenario(cfg, asynchronous=False)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    adaptive = getattr(strategy, "adaptive", False)
    seed_list = seed_lanes(cfg, seeds, init_params)
    if adapter is None:
        adapter = modelspec.adapter_for(cfg, data, hidden=hidden)
    if adaptive and len(seed_list) > 1:
        raise ValueError(
            f"strategy {strategy.name!r} adapts its plan to per-round "
            "measurements; a batched seeds axis would need one plan per "
            "seed. Batch static-plan strategies (dpsgd/ldsgd) or run "
            "seeds sequentially.")
    # per lane: its init and its batch stream, whose first draws are the
    # eval batches (only lane 0's are read: the measurements run on one
    # lane)
    rngs = [np.random.default_rng(s) for s in seed_list]
    ex, ey, px, py = [eval_batches(rng, data, shards, device)
                      for rng in rngs][0]
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)
    needs_cross = strategy.name == "pens"
    replan = max(int(cfg.replan_every), 1)
    # the codec state stays on the device across segments (None when the
    # codec carries none: uncompressed, rand-k, error feedback off)
    codec0 = run_codec(cfg, adapter)
    p_model = adapter.param_count
    skey = compression.sparsify_base_key(cfg.seed)
    if plan is not None:
        if codec0.kind == "leafmap":
            raise ValueError(
                "per-leaf codec maps are single-device only: their shared "
                "payload spans leaf segments, which would need per-segment "
                "routing tables on the sharded path")
        flat, err, (evals, holds) = sharded_start(
            plan, adapter, seed_list[0], init_params, codec0,
            cfg.error_feedback, ((ex, ey, px, py), (tx, ty)))
    else:
        flat = torch.stack([initial_params(adapter, n, s, init_params,
                                           device) for s in seed_list])
        err = compression.codec_state_init(flat, codec0, cfg.error_feedback)

    hists = [History() for _ in seed_list]
    clock = 0.0
    h = 0
    stop = False
    while h < rounds and not stop:
        seg_len = (min(replan, rounds - h) if adaptive
                   else min(rounds - h, MAX_FUSE_ROUNDS))
        seg, clock, stop = _precompute_segment(
            h, seg_len, cluster, strategy, cfg, rngs, data, shards, mixing,
            clock, time_budget, adaptive, codec0, p_model, skey, scen,
            sparse=cfg.gossip == "sparse" or plan is not None)
        if plan is not None:
            flat, err, outs = _scan_segment_sharded(
                adapter, flat, err, seg, plan, evals, holds,
                measure=adaptive, k=seg.codec.resolve_k(p_model),
                ef=cfg.error_feedback, gamma=cfg.sparse_gamma)
        else:
            flat, err, outs = _scan_segment(
                adapter, flat, err, seg, ex, ey, px, py, tx, ty,
                measure=adaptive, needs_cross=needs_cross,
                k=seg.codec.resolve_k(p_model), ef=cfg.error_feedback,
                gamma=cfg.sparse_gamma, scen=scen)
        for t in range(len(seg)):
            for s, hist in enumerate(hists):
                hist.records.append(RoundRecord(
                    round=h + t, round_time=seg.round_time[t],
                    waiting_time=seg.waiting[t],
                    accuracy=float(outs["acc"][t, s]),
                    loss=float(outs["loss"][t, s]),
                    mean_tau=seg.mean_tau[t], num_links=seg.num_links[t],
                    consensus=float(outs["consensus"][t, s]),
                    cumulative_time=seg.cum_time[t]))
            if adaptive:
                a = seg.meas[t]
                strategy.observe(
                    h + t, adj=seg.adjs[t], mu=seg.mus[t],
                    beta=seg.betas[t],
                    edge_dist=np.asarray(outs["edge"][t], np.float64),
                    update_norms=outs["upds"][t][a] if a.any() else [0.0],
                    smooth_l=float(np.median(outs["ls"][t][a])),
                    sigma=float(np.median(outs["sigs"][t][a])),
                    loss=float(np.mean(outs["losses"][t][a])),
                    cross_loss=np.asarray(outs["cross"][t], np.float64)
                    if needs_cross else None,
                    alive=seg.alive[t], wire_ratio=seg.wire_ratio[t])
        h += len(seg)
    if plan is not None:
        flat = plan.unpad(flat)[None]
    for s, hist in enumerate(hists):
        hist.final_params = adapter.unflatten(flat[s])
    return hists if seeds is not None else hists[0]


# ---------------------------------------------------------------------------
# fused event-driven AD-PSGD
# ---------------------------------------------------------------------------

def _adpsgd_segment(adapter, flat, snaps, err, histn, rounds, tx, ty, *,
                    codec: Codec, k: int, ef: bool, gamma: float, tau: int,
                    scen: robust.Scenario, **inp):
    """Replay a segment's rounds of AD-PSGD events on the device with no
    host sync, on S lanes that share every event: ``rounds`` are the
    schedule's ``AdpsgdRound``s and ``inp`` their device inputs —
    batches ``bx``/``by`` [K, N, S, tau, B, *feat], ``lrs`` [K], join
    masks ``keep`` and donor weights ``rw`` [K, W], metric weights
    ``ew``/``cw`` [K, W] and the events' rand-k mask draws ``gates``
    [K·N, P] (or None). The live rows, the snapshots, the codec state
    ([S, W, P]) and the screening history ``histn`` [S, W] are updated in
    place, row by row; screening verdicts stay on the device. Returns
    (flat, snaps, err, histn, per-round metrics as host arrays [K, S],
    with the rejections per round under ``"rejects"`` when
    screening)."""
    dev = flat.device
    lanes = flat.shape[0]
    half = torch.full((1, 1), 0.5, dtype=torch.float32, device=dev)
    half2 = torch.diag(torch.full((2,), 0.5, dtype=torch.float32,
                                  device=dev))

    def average(xi, xj):
        # the atomic pairwise average xi + ½ (xj - xi) of each lane's
        # rows [S, P]: one row a lane through the gossip kernel
        return _mix_lanes(xi[:, None], xj[:, None], half)[:, 0]

    def pair_mix(a, b):
        # both endpoints' rows [S, 2, P] in one launch: row r is a[:, r] +
        # ½ (b[:, r] - a[:, r]); the zero off-diagonal weights add exact
        # zeros
        return _mix_lanes(a, b, half2)

    outs: dict[str, list] = {}
    ev = 0
    for t, rnd in enumerate(rounds):
        if rnd.keep.any():
            flat, snaps, err, histn = adpsgd_join(
                adapter, flat, snaps, err, histn, inp["keep"][t],
                inp["rw"][t], codec.kind, ef)
        rejects = torch.zeros(lanes, dtype=torch.int32, device=dev)
        for e_k, e in enumerate(rnd.events):
            if scen.active:
                r = adpsgd_event_lying(adapter, flat, snaps, histn, e,
                                       inp["bx"][t, e_k], inp["by"][t, e_k],
                                       inp["lrs"][t], tau, pair_mix, scen)
                rejects = rejects if r is None else rejects + r
            else:
                adpsgd_event(adapter, flat, snaps, err, e, inp["bx"][t, e_k],
                             inp["by"][t, e_k], inp["lrs"][t], tau, average,
                             codec=codec, k=k, ef=ef, gamma=gamma,
                             scores=None if inp["gates"] is None
                             else inp["gates"][ev])
            ev += 1
        metrics = _round_metrics(adapter, flat, tx, ty, inp["ew"][t],
                                 inp["cw"][t])
        if scen.mode == "screen":
            metrics["rejects"] = rejects
        for key, v in metrics.items():
            outs.setdefault(key, []).append(v)
    return flat, snaps, err, histn, {key: torch.stack(v).cpu().numpy()
                                     for key, v in outs.items()}


def run_adpsgd_fused(data: Dataset, test_x, test_y, shards,
                     cluster: SimCluster, cfg: FedHPConfig, *,
                     rounds: int | None = None, hidden: int = 64,
                     eval_subset: int = 512,
                     time_budget: float | None = None, seeds=None,
                     schedule: AdpsgdSchedule | None = None,
                     adapter: modelspec.ModelAdapter | None = None,
                     init_params=None, device=None):
    """Drop-in fused replacement for ``engine.run_adpsgd``: the host
    precomputes the event schedule (``engine.adpsgd_schedule``) and each
    segment's per-event batches, and the device replays the events with
    the reference loop's per-event math — snapshot deltas, the atomic
    pairwise average through the ``gossip_mix`` kernel, or under
    ``cfg.compress`` the compensated exchange through the codec kernels
    (one quantize and one dequantize, or one sparsify, per event).
    Matches ``run_adpsgd`` record for record: host fields (staleness
    included) exactly, device metrics to float tolerance.

    With ``seeds`` (an array of S ints) returns ``list[History]``, one per
    lane: the lanes share the event schedule, the cluster draws and the
    rand-k key, each takes its init and batch stream from its seed, and
    every event runs once for all lanes (module docstring). ``device``:
    ``None`` means the GPU (raises without one); ``"cpu"`` runs the same
    loop with the kernels' plain versions."""
    device = resolve_device(device)
    check_ported(cfg, seeds=seeds, asynchronous=True)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    seed_list = seed_lanes(cfg, seeds, init_params)
    if adapter is None:
        adapter = modelspec.adapter_for(cfg, data, hidden=hidden)
    codec, scen, schedule = adpsgd_setup(cfg, cluster, adapter,
                                         rounds=rounds,
                                         time_budget=time_budget,
                                         schedule=schedule)
    tau = schedule.tau
    p_model = adapter.param_count
    k_abs = codec.resolve_k(p_model)
    skey = compression.sparsify_base_key(cfg.seed)
    rngs = [np.random.default_rng(s) for s in seed_list]   # batch streams
    flat = torch.stack([initial_params(adapter, n, s, init_params, device)
                        for s in seed_list])
    snaps = flat.clone()
    err = compression.state_init(flat, codec.kind, cfg.error_feedback)
    histn = torch.zeros(len(seed_list), n, device=device)   # delta-norm EMA
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)

    hists = [History() for _ in seed_list]
    if scen.mode == "screen":
        for hist in hists:
            hist.screen_rejects = []
    done = 0
    ev0 = 0             # global event index: the rand-k mask step
    while done < len(schedule.rounds):
        seg = schedule.rounds[done:done + ADPSGD_FUSE_ROUNDS]
        # per lane, its stream's draws in the reference loop's order
        batches = [[round_batches(rng, data, shards, done + t, r, tau,
                                  cfg.batch_size) for t, r in enumerate(seg)]
                   for rng in rngs]
        n_ev = sum(len(r.events) for r in seg)
        # metric weights over the honest alive workers
        meas = np.stack([scen.honest(r.alive) for r in seg])
        n_meas = meas.sum(1, keepdims=True)
        cw = np.where(n_meas > 0, meas / np.maximum(n_meas, 1), 1.0 / n)
        ew = np.where(n_meas < n, cw, 1.0 / n)
        inp = dict(
            # [K, N, S, ...]: an event's lanes side by side
            bx=np.stack([np.stack([b[t][0] for b in batches], axis=1)
                         for t in range(len(seg))]),
            by=np.stack([np.stack([b[t][1] for b in batches], axis=1)
                         for t in range(len(seg))]).astype(np.int64),
            lrs=np.array([r.lr for r in seg], np.float32),
            keep=np.stack([r.keep for r in seg]),
            rw=np.stack([r.donor_w for r in seg]).astype(np.float32),
            ew=ew.astype(np.float32), cw=cw.astype(np.float32),
            gates=np.stack([compression.randk_scores(skey, ev0 + e, p_model)
                            for e in range(n_ev)])
            if codec.kind == "randk" else None)
        flat, snaps, err, histn, outs = _adpsgd_segment(
            adapter, flat, snaps, err, histn, seg, tx, ty, codec=codec,
            k=k_abs, ef=cfg.error_feedback, gamma=cfg.sparse_gamma, tau=tau,
            scen=scen,
            **{key: None if v is None else torch.as_tensor(v, device=device)
               for key, v in inp.items()})
        for t, r in enumerate(seg):
            for s, hist in enumerate(hists):
                hist.records.append(RoundRecord(
                    round=done + t, round_time=0.0, waiting_time=0.0,
                    accuracy=float(outs["acc"][t, s]),
                    loss=float(outs["loss"][t, s]),
                    mean_tau=float(tau), num_links=schedule.num_links,
                    consensus=float(outs["consensus"][t, s]),
                    cumulative_time=r.clock, staleness=r.mean_staleness))
                if hist.screen_rejects is not None:
                    hist.screen_rejects.append(int(outs["rejects"][t, s]))
        done += len(seg)
        ev0 += n_ev
    for s, hist in enumerate(hists):
        hist.final_params = adapter.unflatten(flat[s])
    return hists if seeds is not None else hists[0]
