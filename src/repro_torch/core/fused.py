"""The fused round engine (``run_dfl_fused``) — the port of
``repro.core.fused``'s dense, uncompressed, single-lane path: the fast
path next to ``engine.run_dfl``.

The host precomputes a segment of K rounds (cluster, strategy and batch
streams advanced in ``run_dfl``'s exact order) and ships its control
inputs to the device at once; the device then runs the K rounds as a
Python loop over device tensors with no host sync inside — each round's
metrics stay on the device and come to the host once, at the segment's
end (the reference lowers the same loop to one ``jax.lax.scan``).

- Static-plan strategies (D-PSGD ring, LD-SGD alternation, the base
  strategy) run in segments of up to ``MAX_FUSE_ROUNDS`` rounds and take
  no measurements.
- Adaptive strategies (FedHP, PENS) run in segments of
  ``cfg.replan_every`` rounds with the plan frozen per segment; the
  Alg. 1 measurements surface at the segment's end, where the strategy's
  ``observe`` is replayed round by round. ``replan_every=1`` replans
  every round exactly like the reference engine.
- Gossip (Eq. 5-6) runs through the hand-written ``gossip_mix`` CUDA
  kernel (``kernels/ops.py``) on the flat ``[W, P]`` matrix as
  y_i = x_i + sum_j w_ij (x_j - x_i), one launch per round; rounds
  without communication carry an identity mix, which the kernel maps to
  an exact no-op. (The reference engine mixes as sum_j w_ij x_j; the two
  differ in the last ulp.)
- Churn masks (join blend, alive-weighted metrics) are per-round device
  inputs.

The batched ``seeds=`` axis, CUDA graphs and the sharded twin are not
ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import FedHPConfig
from repro_torch.core import modelspec
from repro_torch.core.algorithms import Strategy
from repro_torch.core.engine import (History, RoundRecord, _blend_joined,
                                     _cross_loss_matrix, _draw_batches,
                                     _fleet_metrics, _local_train, _measure,
                                     check_ported, eval_batches,
                                     holdout_set, initial_params, mixing_fn,
                                     resolve_device, round_clock,
                                     round_topology)
from repro_torch.data.synthetic import Dataset
from repro_torch.kernels import ops
from repro_torch.simulation.cluster import SimCluster

# static-plan strategies would otherwise stage the whole horizon's batch
# tensors at once ([K, W, tau, B, D] f32); segments of 64 rounds bound
# that with no semantic difference (static plans are recomputed per round
# either way)
MAX_FUSE_ROUNDS = 64


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
    mixes: np.ndarray         # [K, W, W] f32 (identity without comm)
    ew: np.ndarray            # [K, W] f32  eval (accuracy/loss) weights
    cw: np.ndarray            # [K, W] f32  consensus weights
    keep: np.ndarray          # [K, W] bool join re-init mask
    rw: np.ndarray            # [K, W] f32  donor weights
    tau_cap: int
    alive: list[np.ndarray]
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
                        shards, mixfn, clock: float,
                        time_budget: float | None, adaptive: bool):
    """Advance cluster/strategy/batch RNG streams for rounds h0..h0+K-1 in
    the exact order ``run_dfl`` would, and pack the device inputs.

    For an adaptive strategy the plan is frozen at the segment's first
    round; static strategies re-plan every round (observation-free, so
    this is exactly the reference behavior)."""
    n = cfg.num_workers
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
        adj = round_topology(plan, alive, beta)
        taus = np.where(alive, np.clip(plan.taus, 1, cfg.tau_max), 0)
        tau_cap = int(max(taus.max(), 1))
        sh = shards.shards_at(h) if drifting else shards
        bx, by = _draw_batches(rng, data, sh, tau_cap, cfg.batch_size)

        # --- clock (Eq. 10-11), the reference engine's formulas ---
        t_round, waiting = round_clock(adj, taus, mu, beta, plan, alive,
                                       crashed, cfg.crash_timeout)
        clock += t_round

        # --- device-side control inputs ---
        mix = mixfn(adj) if adj.sum() > 0 else np.eye(n)
        donors = alive & ~joined
        do_reinit = joined.any() and donors.any()
        keep = joined if do_reinit else np.zeros(n, bool)
        rw = donors / max(donors.sum(), 1.0) if do_reinit else np.zeros(n)
        if alive.any() and not alive.all():
            ew = alive / alive.sum()
        else:
            ew = np.full(n, 1.0 / n)
        cw = alive / alive.sum() if alive.any() else np.full(n, 1.0 / n)

        per.append(dict(alive=alive, adj=adj, mu=mu, beta=beta, taus=taus,
                        tau_cap=tau_cap, bx=bx, by=by, mix=mix,
                        keep=keep, rw=rw, ew=ew, cw=cw,
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

    seg = _Segment(
        bx=np.stack([pad(p["bx"], p["tau_cap"]) for p in per]),
        by=np.stack([pad(p["by"], p["tau_cap"]) for p in per]),
        taus=np.stack([p["taus"] for p in per]).astype(np.int64),
        lrs=np.array([p["lr"] for p in per], np.float32),
        mixes=np.stack([p["mix"] for p in per]).astype(np.float32),
        ew=np.stack([p["ew"] for p in per]).astype(np.float32),
        cw=np.stack([p["cw"] for p in per]).astype(np.float32),
        keep=np.stack([p["keep"] for p in per]),
        rw=np.stack([p["rw"] for p in per]).astype(np.float32),
        tau_cap=cap,
        alive=[p["alive"] for p in per], adjs=[p["adj"] for p in per],
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

def _scan_segment(adapter, flat, seg: _Segment, ex, ey, px, py, tx, ty, *,
                  measure: bool, needs_cross: bool):
    """Run the segment's rounds on ``flat``'s device with no host sync
    (the reference's ``lax.scan`` body as a Python loop); returns
    (flat', outs) where outs maps each metric to a host array with a
    leading [K] round axis."""
    dev = flat.device
    bx = torch.as_tensor(seg.bx, device=dev)
    by = torch.as_tensor(seg.by, device=dev).long()
    taus, lrs, mixes, ew, cw, keep, rw = (
        torch.as_tensor(a, device=dev)
        for a in (seg.taus, seg.lrs, seg.mixes, seg.ew, seg.cw, seg.keep,
                  seg.rw))
    off_diag = 1.0 - torch.eye(flat.shape[0], device=dev)
    outs: dict[str, list] = {}

    def emit(**kw):
        for k, v in kw.items():
            outs.setdefault(k, []).append(v)

    for t in range(len(seg)):
        # --- join re-init (keep/donor weights precomputed host-side; an
        # all-False keep makes the blend an exact no-op) ---
        flat = _blend_joined(flat, keep[t], rw[t])
        prev = flat

        # --- local updating (Eq. 3), masked to tau_i ---
        flat = _local_train(adapter, flat, bx[t], by[t], taus[t], lrs[t],
                            seg.tau_cap)

        # --- gossip (Eq. 5-6): row b of the mixing matrix is the kernel's
        # neighbour weights over all W rows ---
        flat = ops.gossip_mix(flat, flat, mixes[t])

        # --- per-round metrics: fleet accuracy/loss over the alive
        # workers + consensus distance to the alive mean ---
        accs, tloss = _fleet_metrics(adapter, flat, tx, ty)
        dmean = cw[t] @ flat
        dists = torch.sqrt(torch.sum((flat - dmean[None]) ** 2, dim=1))
        emit(acc=ew[t] @ accs, loss=ew[t] @ tloss, consensus=cw[t] @ dists)

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
    return flat, {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}


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
    ``device``: ``None`` means the GPU (raises without one); ``"cpu"``
    runs the same loop with the kernel's plain version."""
    device = resolve_device(device)
    check_ported(cfg, mesh=mesh, seeds=seeds)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    adaptive = getattr(strategy, "adaptive", False)
    if adapter is None:
        adapter = modelspec.adapter_for(cfg, data, hidden=hidden)
    rng = np.random.default_rng(cfg.seed)
    flat = initial_params(adapter, n, cfg.seed, init_params, device)
    ex, ey, px, py = eval_batches(rng, data, shards, device)
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)
    mixfn = mixing_fn(mixing)
    needs_cross = strategy.name == "pens"
    replan = max(int(cfg.replan_every), 1)

    hist = History()
    clock = 0.0
    h = 0
    stop = False
    while h < rounds and not stop:
        seg_len = (min(replan, rounds - h) if adaptive
                   else min(rounds - h, MAX_FUSE_ROUNDS))
        seg, clock, stop = _precompute_segment(
            h, seg_len, cluster, strategy, cfg, rng, data, shards, mixfn,
            clock, time_budget, adaptive)
        flat, outs = _scan_segment(adapter, flat, seg, ex, ey, px, py, tx,
                                   ty, measure=adaptive,
                                   needs_cross=needs_cross)
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
                a = seg.alive[t]
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
                    alive=a, wire_ratio=1.0)
        h += len(seg)
    hist.final_params = adapter.unflatten(flat)
    return hist
