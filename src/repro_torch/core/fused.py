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
- Churn masks (join blend, codec-state reset, alive-weighted metrics)
  are per-round device inputs.
- AD-PSGD: the host schedule (``engine.adpsgd_schedule``) fixes every
  event; a segment of ``ADPSGD_FUSE_ROUNDS`` rounds ships its batches at
  once and replays its events on the device, the uncompressed pairwise
  average through ``gossip_mix`` on one row with weight ½ — over a lying
  wire, or screened, both endpoints' rows in one launch, with the
  verdicts and the screening history on the device and the rejection
  counts shipped once per segment.

The batched ``seeds=`` axis, CUDA graphs and the sharded twin are not
ported yet (ROADMAP.md queue 1).
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
                                     eval_batches, holdout_set,
                                     initial_params, mixing_fn,
                                     resolve_device, round_batches,
                                     round_clock, round_edges,
                                     round_topology)
from repro_torch.data.synthetic import Dataset
from repro_torch.kernels import ops
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
    bx: np.ndarray            # [K, W, T, B, D] f32
    by: np.ndarray            # [K, W, T, B] i32
    taus: np.ndarray          # [K, W] i64
    lrs: np.ndarray           # [K] f32
    mixes: np.ndarray | None  # [K, W, W] f32 (identity without comm);
    #                           None when sparse
    edges: tuple | None       # sparse: CSR ([K, W+1], [K, E], [K, E])
    nbrs: np.ndarray | None   # robust: [K, W, D] i32 neighbour tables
    degs: np.ndarray | None   # robust: [K, W] i32 degrees
    ew: np.ndarray            # [K, W] f32  eval (accuracy/loss) weights
    cw: np.ndarray            # [K, W] f32  consensus weights
    keep: np.ndarray          # [K, W] bool join re-init mask
    rw: np.ndarray            # [K, W] f32  donor weights
    comm: np.ndarray          # [K] bool: the round gossips
    gates: np.ndarray | None  # [K, P] f32 rand-k mask draws (else None)
    codec: Codec              # the segment's frozen wire codec
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


def _precompute_segment(h0: int, seg_len: int, cluster: SimCluster,
                        strategy: Strategy, cfg: FedHPConfig, rng, data,
                        shards, mixing: str, clock: float,
                        time_budget: float | None, adaptive: bool,
                        codec0: Codec, p_model: int, skey,
                        scen: robust.Scenario):
    """Advance cluster/strategy/batch RNG streams for rounds h0..h0+K-1 in
    the exact order ``run_dfl`` would, and pack the device inputs.

    For an adaptive strategy the plan is frozen at the segment's first
    round; static strategies re-plan every round (observation-free, so
    this is exactly the reference behavior). The frozen plan also fixes
    the segment's wire codec (``plan.codec``, else ``codec0``, the parsed
    ``cfg.compress``), whose ``wire_ratio(p_model)`` divides the Eq. 10
    comm term as in the reference engine; rand-k rounds draw their mask
    here, from ``skey``, on the host.

    Under ``cfg.gossip="sparse"`` each round's topology ships as a CSR
    edge list (``engine.round_edges``, stably sorted by destination) and
    no [W, W] matrix is built; a robust mode ships each round's padded
    neighbour table (``robust.neighbor_table``), padded to one D per
    segment rounded up to a power of two (one kernel instance). The
    metric weights cover the honest alive workers (``scen.honest``)."""
    n = cfg.num_workers
    compress = codec0.kind != "none"
    sparse = cfg.gossip == "sparse"
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
        rcodec = plan.codec if plan.codec is not None else codec0
        comm_ratio = rcodec.wire_ratio(p_model) if compress else 1.0
        adj = round_topology(plan, alive, beta)
        taus = np.where(alive, np.clip(plan.taus, 1, cfg.tau_max), 0)
        tau_cap = int(max(taus.max(), 1))
        sh = shards.shards_at(h) if drifting else shards
        bx, by = _draw_batches(rng, data, sh, tau_cap, cfg.batch_size)

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
            edges = (round_edges(adj, mixing) if comm else
                     (np.zeros(n + 1, np.int32), np.zeros(0, np.int32),
                      np.zeros(0, np.float32)))
        else:
            mix = mixing_fn(mixing)(adj) if comm else np.eye(n)
        gate = (compression.randk_scores(skey, h, p_model)
                if codec0.kind == "randk" else None)
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
                        taus=taus, tau_cap=tau_cap, bx=bx, by=by, mix=mix,
                        edges=edges, nbr=nbr, deg=deg,
                        keep=keep, rw=rw, ew=ew, cw=cw, gate=gate,
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
        nbrs = np.stack([pad_to(p["nbr"], d_max) for p in per])
        degs = np.stack([p["deg"] for p in per])

    seg = _Segment(
        bx=np.stack([pad(p["bx"], p["tau_cap"]) for p in per]),
        by=np.stack([pad(p["by"], p["tau_cap"]) for p in per]),
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
               if codec0.kind == "randk" else None),
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

def _round_metrics(adapter, flat, tx, ty, ew, cw) -> dict:
    """Fleet accuracy/loss over the alive workers (weights ``ew``) and the
    consensus distance to the alive mean (weights ``cw``), on the device."""
    accs, tloss = _fleet_metrics(adapter, flat, tx, ty)
    dmean = cw @ flat
    dists = torch.sqrt(torch.sum((flat - dmean[None]) ** 2, dim=1))
    return dict(acc=ew @ accs, loss=ew @ tloss, consensus=cw @ dists)


def _gossip_round(flat, err, seg: _Segment, t: int, dev_in: dict,
                  scen: robust.Scenario, *, k: int, ef: bool,
                  gamma: float):
    """One communicating round's gossip on the device -> (flat, err):

    - a robust mode (trimmed/median, dense or sparse gossip alike): the
      ``robust_gossip`` kernel over the round's neighbour table, the
      attackers' rows corrupted on the wire;
    - attackers without one (the attacked baseline): Eq. 5 over the lying
      wire through ``gossip_edges`` (sparse) or ``gossip_mix`` with the
      mix's diagonal zeroed (dense: x_i + sum_{j != i} W_ij (T_j - x_i)
      is W_ii x_i + sum_{j != i} W_ij T_j);
    - a codec: its compensated update, the mixing delta through
      ``gossip_edges(v) - v`` (sparse) or the dense product;
    - honest and uncompressed: ``gossip_edges`` (sparse) or
      ``gossip_mix`` (row b of the mixing matrix as the kernel's
      neighbour weights over all W rows)."""
    edges = (tuple(a[t] for a in dev_in["edges"])
             if dev_in["edges"] is not None else None)
    if scen.active:
        transmitted = (robust.apply_attack(flat, dev_in["byz"], scen.scale,
                                           kind=scen.attack)
                       if scen.has_byz else flat)
        if scen.mode != "none":
            return ops.robust_gossip(flat, transmitted, dev_in["nbrs"][t],
                                     dev_in["degs"][t], b=scen.knob,
                                     mode=scen.mode), err
        if edges is not None:
            return ops.gossip_edges(flat, transmitted, *edges), err
        return ops.gossip_mix(flat, transmitted,
                              dev_in["mixes"][t] * dev_in["off_diag"]), err
    kind = seg.codec.kind
    if kind != "none":
        delta = ((lambda v: ops.gossip_edges(v, v, *edges) - v)
                 if edges is not None else None)
        return compression.compressed_gossip_ref(
            flat, err, None if edges is not None else dev_in["mixes"][t],
            error_feedback=ef, kind=kind, k=k,
            scores=(dev_in["gates"][t] if dev_in["gates"] is not None
                    else None),
            gamma=gamma, mix_delta_fn=delta)
    if edges is not None:
        return ops.gossip_edges(flat, flat, *edges), err
    return ops.gossip_mix(flat, flat, dev_in["mixes"][t]), err


def _scan_segment(adapter, flat, err, seg: _Segment, ex, ey, px, py, tx, ty,
                  *, measure: bool, needs_cross: bool, k: int, ef: bool,
                  gamma: float, scen: robust.Scenario):
    """Run the segment's rounds on ``flat``'s device with no host sync
    (the reference's ``lax.scan`` body as a Python loop); returns
    (flat', err', outs) where outs maps each metric to a host array with
    a leading [K] round axis. ``err`` is the codec state [W, P] (None
    for stateless runs); ``k`` the segment codec's resolved keep
    count."""
    dev = flat.device
    kind = seg.codec.kind
    bx = torch.as_tensor(seg.bx, device=dev)
    by = torch.as_tensor(seg.by, device=dev).long()
    taus, lrs, ew, cw, keep, rw = (
        torch.as_tensor(a, device=dev)
        for a in (seg.taus, seg.lrs, seg.ew, seg.cw, seg.keep, seg.rw))

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    off_diag = 1.0 - torch.eye(flat.shape[0], device=dev) \
        if measure or (scen.has_byz and seg.mixes is not None) else None
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
        # --- join re-init (keep/donor weights precomputed host-side; an
        # all-False keep makes the blend an exact no-op), and the joined
        # rows' codec state reset as in the reference engine ---
        flat = _blend_joined(flat, keep[t], rw[t])
        if err is not None:
            err = compression.state_after_join(err, keep[t][:, None], flat,
                                               kind, ef)
        prev = flat

        # --- local updating (Eq. 3), masked to tau_i ---
        flat = _local_train(adapter, flat, bx[t], by[t], taus[t], lrs[t],
                            seg.tau_cap)

        # --- gossip (Eq. 5-6) on communicating rounds only (the host
        # knows which), through the kernels ---
        if seg.comm[t]:
            flat, err = _gossip_round(flat, err, seg, t, dev_in, scen, k=k,
                                      ef=ef, gamma=gamma)

        emit(**_round_metrics(adapter, flat, tx, ty, ew[t], cw[t]))
        if measure:
            losses, ls, sigs, upds = _measure(adapter, flat, prev, ex, ey,
                                              px, py)
            # consensus.pairwise_distances' f32 gram trick, including its
            # cancellation noise floor for near-identical models — that
            # floor feeds FedHP's tracker, so it is part of the behavior
            sq = torch.sum(flat * flat, dim=1)
            d2 = torch.clamp(sq[:, None] + sq[None, :]
                             - 2.0 * (flat @ flat.T), min=0.0)
            emit(losses=losses, ls=ls, sigs=sigs, upds=upds,
                 edge=torch.sqrt(d2 * off_diag))
            if needs_cross:
                emit(cross=_cross_loss_matrix(adapter, flat, ex[:, :64],
                                              ey[:, :64]))
    return flat, err, {key: torch.stack(v).cpu().numpy()
                       for key, v in outs.items()}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_dfl_fused(data: Dataset, test_x, test_y, shards,
                  cluster: SimCluster, cfg: FedHPConfig, strategy: Strategy,
                  *, rounds: int | None = None, hidden: int = 64,
                  eval_subset: int = 512, mixing: str = "uniform",
                  time_budget: float | None = None, seeds=None,
                  adapter: modelspec.ModelAdapter | None = None,
                  init_params=None, mesh=None, device=None) -> History:
    """Drop-in fused replacement for ``engine.run_dfl``: one experiment
    from ``cfg.seed``, returning a ``History`` that matches the reference
    engine's — host fields exactly, device metrics to float tolerance.
    ``adapter`` and ``init_params`` as in ``engine.run_dfl``.
    ``device``: ``None`` means the GPU (raises without one); ``"cpu"``
    runs the same loop with the kernel's plain version."""
    device = resolve_device(device)
    check_ported(cfg, mesh=mesh, seeds=seeds)
    scen = robust.scenario(cfg, asynchronous=False)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    adaptive = getattr(strategy, "adaptive", False)
    if adapter is None:
        adapter = modelspec.adapter_for(cfg, data, hidden=hidden)
    rng = np.random.default_rng(cfg.seed)
    flat = initial_params(adapter, n, cfg.seed, init_params, device)
    ex, ey, px, py = eval_batches(rng, data, shards, device)
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)
    needs_cross = strategy.name == "pens"
    replan = max(int(cfg.replan_every), 1)
    # the codec state stays on the device across segments (None when the
    # codec carries none: uncompressed, rand-k, error feedback off)
    codec0 = compression.parse_mode(cfg.compress)
    p_model = adapter.param_count
    skey = compression.sparsify_base_key(cfg.seed)
    err = compression.state_init(flat, codec0.kind, cfg.error_feedback)

    hist = History()
    clock = 0.0
    h = 0
    stop = False
    while h < rounds and not stop:
        seg_len = (min(replan, rounds - h) if adaptive
                   else min(rounds - h, MAX_FUSE_ROUNDS))
        seg, clock, stop = _precompute_segment(
            h, seg_len, cluster, strategy, cfg, rng, data, shards, mixing,
            clock, time_budget, adaptive, codec0, p_model, skey, scen)
        flat, err, outs = _scan_segment(
            adapter, flat, err, seg, ex, ey, px, py, tx, ty,
            measure=adaptive, needs_cross=needs_cross,
            k=seg.codec.resolve_k(p_model), ef=cfg.error_feedback,
            gamma=cfg.sparse_gamma, scen=scen)
        for t in range(len(seg)):
            hist.records.append(RoundRecord(
                round=h + t, round_time=seg.round_time[t],
                waiting_time=seg.waiting[t],
                accuracy=float(outs["acc"][t]),
                loss=float(outs["loss"][t]),
                mean_tau=seg.mean_tau[t], num_links=seg.num_links[t],
                consensus=float(outs["consensus"][t]),
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
    hist.final_params = adapter.unflatten(flat)
    return hist


# ---------------------------------------------------------------------------
# fused event-driven AD-PSGD
# ---------------------------------------------------------------------------

def _adpsgd_segment(adapter, flat, snaps, err, histn, rounds, tx, ty, *,
                    codec: Codec, k: int, ef: bool, gamma: float, tau: int,
                    scen: robust.Scenario, **inp):
    """Replay a segment's rounds of AD-PSGD events on the device with no
    host sync: ``rounds`` are the schedule's ``AdpsgdRound``s and ``inp``
    their device inputs — batches ``bx``/``by`` [K, N, tau, B, *feat],
    ``lrs`` [K], join masks ``keep`` and donor weights ``rw`` [K, W],
    metric weights ``ew``/``cw`` [K, W] and the events' rand-k mask draws
    ``gates`` [K·N, P] (or None). The live rows, the snapshots, the codec
    state and the screening history ``histn`` [W] are updated in place,
    row by row; screening verdicts stay on the device. Returns
    (flat, snaps, err, histn, per-round metrics as host arrays, with the
    rejections per round under ``"rejects"`` when screening)."""
    dev = flat.device
    half = torch.full((1, 1), 0.5, dtype=torch.float32, device=dev)
    half2 = torch.diag(torch.full((2,), 0.5, dtype=torch.float32,
                                  device=dev))

    def average(xi, xj):
        # the atomic pairwise average xi + ½ (xj - xi): one row through
        # the gossip kernel
        return ops.gossip_mix(xi[None], xj[None], half)[0]

    def pair_mix(a, b):
        # both endpoints' rows in one launch: row r is a[r] + ½ (b[r] -
        # a[r]); the zero off-diagonal weights add exact zeros
        return ops.gossip_mix(a, b, half2)

    outs: dict[str, list] = {}
    ev = 0
    for t, rnd in enumerate(rounds):
        if rnd.keep.any():
            flat, snaps, err, histn = adpsgd_join(
                flat, snaps, err, histn, inp["keep"][t], inp["rw"][t],
                codec.kind, ef)
        rejects = torch.zeros((), dtype=torch.int32, device=dev)
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
                     init_params=None, device=None) -> History:
    """Drop-in fused replacement for ``engine.run_adpsgd``: the host
    precomputes the event schedule (``engine.adpsgd_schedule``) and each
    segment's per-event batches, and the device replays the events with
    the reference loop's per-event math — snapshot deltas, the atomic
    pairwise average through the ``gossip_mix`` kernel, or under
    ``cfg.compress`` the compensated exchange through the codec kernels
    (one quantize and one dequantize, or one sparsify, per event).
    Matches ``run_adpsgd`` record for record: host fields (staleness
    included) exactly, device metrics to float tolerance. ``device``:
    ``None`` means the GPU (raises without one); ``"cpu"`` runs the same
    loop with the kernels' plain versions."""
    device = resolve_device(device)
    check_ported(cfg, seeds=seeds)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
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
    rng = np.random.default_rng(cfg.seed)       # batch-sampling stream
    flat = initial_params(adapter, n, cfg.seed, init_params, device)
    snaps = flat.clone()
    err = compression.state_init(flat, codec.kind, cfg.error_feedback)
    histn = torch.zeros(n, device=device)       # own-delta-norm EMA
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)

    hist = History()
    if scen.mode == "screen":
        hist.screen_rejects = []
    done = 0
    ev0 = 0             # global event index: the rand-k mask step
    while done < len(schedule.rounds):
        seg = schedule.rounds[done:done + ADPSGD_FUSE_ROUNDS]
        batches = [round_batches(rng, data, shards, done + t, r, tau,
                                 cfg.batch_size) for t, r in enumerate(seg)]
        n_ev = sum(len(r.events) for r in seg)
        # metric weights over the honest alive workers
        meas = np.stack([scen.honest(r.alive) for r in seg])
        n_meas = meas.sum(1, keepdims=True)
        cw = np.where(n_meas > 0, meas / np.maximum(n_meas, 1), 1.0 / n)
        ew = np.where(n_meas < n, cw, 1.0 / n)
        inp = dict(
            bx=np.stack([b[0] for b in batches]),
            by=np.stack([b[1] for b in batches]).astype(np.int64),
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
            hist.records.append(RoundRecord(
                round=done + t, round_time=0.0, waiting_time=0.0,
                accuracy=float(outs["acc"][t]), loss=float(outs["loss"][t]),
                mean_tau=float(tau), num_links=schedule.num_links,
                consensus=float(outs["consensus"][t]),
                cumulative_time=r.clock, staleness=r.mean_staleness))
            if hist.screen_rejects is not None:
                hist.screen_rejects.append(int(outs["rejects"][t]))
        done += len(seg)
        ev0 += n_ev
    hist.final_params = adapter.unflatten(flat)
    return hist
