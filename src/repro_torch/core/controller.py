"""FedHP adaptive control algorithm (Sec. IV-B, Alg. 3). A numpy copy of
``repro.core.controller``, bit-exact against it.

Jointly determines per-worker local updating frequencies tau_i and the round
topology A^h: greedily remove the slowest links (search step sqrt(|E|),
halved on failure) subject to (a) connectivity and (b) the consensus-distance
budget (Eq. 42), assigning taus that equalize per-worker round time (Eq. 40)
with the pace set by the theory-optimal tau* (Remark 2).

Deviation noted in DESIGN.md: the greedy objective is the true round
completion time max_i t_i (the quantity Eq. 12 minimizes) rather than the
pace-setter's T_l; the two coincide up to the tau>=1 clamp. The paper's "LP"
has one free variable once the pace-setter is fixed, so the closed-form
equalization is exact.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import topology as topo
from repro_torch.core.compression import Codec
from repro_torch.core.consensus import ConsensusTracker


@dataclass
class ControlDecision:
    """One coordinator decision (Alg. 3 output): the round topology A^h,
    per-worker taus (Eq. 40 equalization around the pace-setter's
    theory-optimal tau*, Remark 2), the predicted round/waiting times
    (Eq. 10-11), the Eq. 36 consensus bound the topology was accepted
    under, and the wire ratio the Eq. 10 comm term was scaled by (1.0
    for a compression-blind solve)."""

    adj: np.ndarray
    taus: np.ndarray                  # (N,) int per-worker local frequencies
    round_time: float                 # max_i t_i (predicted)
    waiting_time: float               # Eq. (11) predicted average waiting
    tau_pace: int                     # tau of the pace-setting worker
    pace_worker: int
    consensus_bound: float            # Eq. (36) value for this topology
    wire_ratio: float = 1.0           # comm divisor the solve used
    matchings: list = field(default_factory=list)

    @property
    def num_links(self) -> int:
        """Undirected edge count of the decided topology."""
        return int(self.adj.sum() // 2)


def theory_tau_star(n: int, f1: float, smooth_l: float, rounds: int,
                    eta: float, sigma: float, tau_max: int,
                    comm_floor: int = 1) -> int:
    """Remark 2 / Alg. 3 line 2: tau* = sqrt(N f(xbar^1) / (L H eta^2 sigma^2)).

    Guarded: if any estimate is degenerate (early rounds) fall back to
    tau_max/2. ``comm_floor`` additionally lower-bounds tau so the pace
    setter's compute amortizes its per-round communication time (the L and
    sigma plug-in estimates are noisy — Alg. 1 lines 4-5 — and a tau below
    the floor makes every round communication-dominated, which Eq. 41's
    objective can never favor; implementation choice recorded in
    DESIGN.md §8).
    """
    lo = max(1, min(comm_floor, tau_max))
    denom = smooth_l * rounds * (eta ** 2) * (sigma ** 2)
    if denom <= 0 or f1 <= 0 or not math.isfinite(denom):
        return max(lo, tau_max // 2)
    tau = math.sqrt(n * f1 / denom)
    if not math.isfinite(tau):
        return max(lo, tau_max // 2)
    return int(min(max(tau, lo), tau_max))


def equalized_taus(adj: np.ndarray, mu: np.ndarray, beta: np.ndarray,
                   tau_star: int, tau_max: int,
                   alive: np.ndarray | None = None
                   ) -> tuple[np.ndarray, int]:
    """Eq. (40): assign taus so every worker's t_i matches the pace-setter.

    Pace-setter l = argmin_i (tau* mu_i + max_j beta_ij): the worker that can
    finish a tau*-step round fastest. Everyone else gets
    tau_i = floor((t_l - comm_i) / mu_i) clamped to [1, tau_max].
    Under churn the pace-setter and the equalization run over the surviving
    set only; departed workers get tau 0. Returns (taus, pace_worker).
    """
    n = adj.shape[0]
    alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
    comm = link_times(adj, beta)
    t_full = np.where(alive, tau_star * mu + comm, np.inf)
    pace = int(np.argmin(t_full))
    t_pace = float(t_full[pace])
    with np.errstate(divide="ignore", invalid="ignore"):
        taus = np.floor((t_pace - comm) / np.maximum(mu, 1e-12))
    taus = np.clip(taus, 1, tau_max).astype(np.int64)
    taus[pace] = tau_star
    taus[~alive] = 0
    return taus, pace


def link_times(adj: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Per-worker communication time: max_{j in N_i} beta_ij (Eq. 10)."""
    masked = np.where(adj > 0, beta, 0.0)
    return masked.max(axis=1)


def evaluate_topology(adj: np.ndarray, mu: np.ndarray, beta: np.ndarray,
                      tau_star: int, tau_max: int,
                      alive: np.ndarray | None = None) -> ControlDecision:
    """Score one candidate topology: equalize taus (Eq. 40), then predict
    its round time max_i t_i and average waiting time (Eq. 10-11) — the
    objective Alg. 3's greedy link removal minimizes."""
    n = adj.shape[0]
    alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
    taus, pace = equalized_taus(adj, mu, beta, tau_star, tau_max, alive)
    comm = link_times(adj, beta)
    t = np.where(alive, taus * mu + comm, 0.0)
    round_time = float(t[alive].max()) if alive.any() else 0.0
    waiting = float((round_time - t[alive]).mean()) if alive.any() else 0.0
    return ControlDecision(
        adj=adj, taus=taus, round_time=round_time, waiting_time=waiting,
        tau_pace=int(taus[pace]), pace_worker=pace, consensus_bound=0.0)


class AdaptiveController:
    """Coordinator-side Alg. 3 driver, stateful across rounds."""

    def __init__(self, base_adj: np.ndarray, tau_max: int = 50,
                 epsilon: float = float("inf")):
        topo.validate_topology(base_adj)
        if not topo.is_connected(base_adj):
            raise ValueError("base topology must be connected")
        self.base_adj = np.asarray(base_adj, dtype=np.int8)
        self.n = base_adj.shape[0]
        self.tau_max = int(tau_max)
        self.epsilon = float(epsilon)

    # -- Alg. 3 -------------------------------------------------------------
    def decide(self, mu: np.ndarray, beta: np.ndarray,
               tracker: ConsensusTracker, *, f1: float, smooth_l: float,
               sigma: float, eta: float, rounds: int,
               alive: np.ndarray | None = None,
               wire_ratio: float = 1.0) -> ControlDecision:
        """One coordinator decision (Alg. 3).

        mu: (N,) per-iteration computing times. beta: (N,N) link times.
        alive: optional bool mask; dead workers' links are stripped first
        (fault tolerance: vertex removal + topology repair).
        wire_ratio: the active codec's uncompressed/compressed wire-bits
        ratio — every Eq. 10 comm term in the solve (the comm floor under
        tau*, the Eq. 40 equalization and the greedy link-removal
        objective) uses the effective link times beta / wire_ratio, so
        the planned (tau, topology) trades the wire the engines actually
        pay: a cheaper wire lowers the comm floor (tau* stops being
        forced up to amortize links) and makes slow links cheaper to keep
        under the Eq. 42 consensus budget.
        """
        mu = np.asarray(mu, dtype=np.float64)
        beta = np.asarray(beta, dtype=np.float64)
        if wire_ratio != 1.0:
            beta = beta / max(float(wire_ratio), 1e-12)
        adj = np.array(self.base_adj, copy=True)
        mask = np.ones(self.n, bool) if alive is None \
            else np.asarray(alive, dtype=bool)
        if not mask.all():
            adj = prune_dead(adj, mask, cost=beta)
        live = np.nonzero(mask)[0]

        def live_connected(a: np.ndarray) -> bool:
            return topo.is_connected(a[np.ix_(live, live)])

        # comm floor: the pace setter should compute at least as long as it
        # communicates, else rounds are wire-bound regardless of topology
        link = beta[adj > 0]
        mu_live = mu[mask] if mask.any() else mu
        comm_floor = int(math.ceil(
            float(np.median(link)) / max(float(mu_live.min()), 1e-9))) \
            if link.size else 1
        tau_star = theory_tau_star(max(len(live), 1), f1, smooth_l, rounds,
                                   eta, sigma, self.tau_max,
                                   comm_floor=comm_floor)
        best = evaluate_topology(adj, mu, beta, tau_star, self.tau_max, mask)
        best.consensus_bound = tracker.average_consensus_bound(adj)

        s = self.n
        flag = True
        while True:
            num_links = int(best.adj.sum() // 2)
            if flag:
                s = max(1, int(math.isqrt(max(num_links, 1))))
            # select the s slowest links removable under Eq. (42)
            cand = self._removal_candidates(best.adj, beta, tracker, s)
            improved = False
            if cand:
                trial = np.array(best.adj, copy=True)
                for (i, j) in cand:
                    trial[i, j] = trial[j, i] = 0
                    if not live_connected(trial):
                        trial[i, j] = trial[j, i] = 1
                        continue
                    if not tracker.satisfies_budget(trial):
                        trial[i, j] = trial[j, i] = 1
                        continue
                d = evaluate_topology(trial, mu, beta, tau_star,
                                      self.tau_max, mask)
                if d.round_time < best.round_time and \
                        d.waiting_time <= self.epsilon:
                    d.consensus_bound = tracker.average_consensus_bound(d.adj)
                    best = d
                    improved = True
            if improved:
                flag = True
            else:
                if s == 1:
                    break
                s = max(1, s // 2)
                flag = False

        best.matchings = topo.matching_decomposition(best.adj)
        best.wire_ratio = float(wire_ratio)
        return best

    def _removal_candidates(self, adj: np.ndarray, beta: np.ndarray,
                            tracker: ConsensusTracker,
                            s: int) -> list[tuple[int, int]]:
        """Alg. 3 line 9: s slowest links whose individual removal keeps the
        consensus-distance budget (the joint check happens during removal).

        Fully vectorized over the edge list: removing one edge (i, j) adds
        exactly dist[i, j] + dist[j, i] (present-masked) to the Eq. 36 sum,
        so every candidate's budget check is the base bound plus that delta —
        no per-candidate O(n^2) trial matrices (was the dominant planner cost
        at large W)."""
        iu, ju = np.nonzero(np.triu(adj, k=1))
        if iu.size == 0:
            return []
        order = np.argsort(-beta[iu, ju], kind="stable")  # ties: row-major
        iu, ju = iu[order], ju[order]
        mask = np.outer(tracker.present, tracker.present)
        m = max(int(tracker.present.sum()), 1)
        base = tracker.average_consensus_bound(adj)
        delta = (tracker.dist[iu, ju] * mask[iu, ju]
                 + tracker.dist[ju, iu] * mask[ju, iu]) / (m * m)
        ok = np.nonzero(base + delta <= tracker.d_max + 1e-12)[0][:s]
        return [(int(iu[t]), int(ju[t])) for t in ok]


class SparsityScheduler:
    """The replan-cadence compression feedback path (beyond-paper,
    ChocoSGD x DySTop-flavored): as the fleet's consensus distance
    shrinks, each gossip payload carries less information per coordinate,
    so the sparse codec's keep count k is tightened — halved whenever the
    tracked consensus distance has halved since the last tightening,
    never below ``floor_frac`` of the initial spec. Tightening on a
    halving ladder (instead of scaling k continuously) bounds the jit
    specializations a changing k costs the engines at
    ~log2(1/floor_frac), and the factor-2 hysteresis keeps the decision
    robust to the ~1e-5 cross-engine float drift in the measured
    distances — both engines must replay identical codec sequences for
    the differential harness to hold.

    Driven by ``algorithms.FedHPStrategy`` at ``cfg.replan_every``
    cadence (``cfg.tighten_k``); the tightened codec rides to the engines
    in ``RoundPlan.codec``.
    """

    def __init__(self, codec: Codec, floor_frac: float = 0.125):
        if not codec.is_sparse:
            raise ValueError(f"k-tightening needs a sparse codec, "
                             f"got {codec.mode!r}")
        self.codec = codec
        self.floor_frac = float(floor_frac)
        self._k0 = codec.k
        self._d_ref: float | None = None

    def step(self, d_now: float) -> Codec:
        """Feed the current tracked consensus distance; returns the codec
        to plan and gossip with (possibly one halving tighter)."""
        if not (math.isfinite(d_now) and d_now > 0.0):
            return self.codec
        if self._d_ref is None:
            self._d_ref = float(d_now)
            return self.codec
        k_floor = self._k0 * self.floor_frac
        if self._k0 >= 1.0:
            # an absolute keep count must stay absolute: halving across
            # 1.0 would silently reinterpret k as a fraction of P and
            # EXPAND the payload instead of tightening it
            k_floor = max(k_floor, 1.0)
        if d_now < 0.5 * self._d_ref and self.codec.k > k_floor:
            self.codec = self.codec.with_k(max(self.codec.k / 2.0, k_floor))
            self._d_ref = float(d_now)
        return self.codec


def prune_dead(adj: np.ndarray, alive: np.ndarray,
               cost: np.ndarray | None = None) -> np.ndarray:
    """Vertex removal for churned-out workers + cheapest-reconnect repair:
    if the prune disconnects the survivors, the minimum-cost (link-time)
    cross-component edges are added back until the alive subgraph is one
    component (``topology.repair_connectivity``)."""
    return topo.repair_connectivity(adj, np.asarray(alive, bool), cost)
