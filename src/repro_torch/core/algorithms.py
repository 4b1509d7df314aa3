"""DFL algorithm strategies: FedHP (ours, Alg. 1-3) and the paper's
synchronous baselines — D-PSGD, LD-SGD, PENS (AD-PSGD is event-driven and
has no strategy). A numpy copy of ``repro.core.algorithms``, whose plans
it reproduces bit for bit from the same observations.

A strategy decides, per round, the topology A^h and per-worker local
updating frequencies tau_i^h, using only the measurements reported at the
end of round h-1 (the coordinator's information set, Alg. 2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import FedHPConfig
from repro_torch.core import compression, topology as topo
from repro_torch.core.compression import Codec
from repro_torch.core.consensus import ConsensusTracker
from repro_torch.core.controller import (AdaptiveController,
                                         SparsityScheduler)


@dataclass
class RoundPlan:
    """One round's coordinator output: topology, per-worker taus, any
    per-worker overhead, and (adaptive compression only) the wire codec
    the round must gossip and be billed under — ``None`` means the
    engine uses ``cfg.compress`` unchanged. The codec may only refine
    the configured codec's k (same kind); both engines read it through
    the same plan replay, which keeps their wire charges bit-identical."""

    adj: np.ndarray
    taus: np.ndarray
    extra_time: np.ndarray | None = None    # per-worker overhead (e.g. PENS)
    codec: Codec | None = None              # tightened wire codec (FedHP)


class Strategy:
    """Base: fixed base topology, fixed tau (what D-PSGD does on a ring)."""

    name = "base"
    # adaptive strategies plan from the previous round's measurements, so
    # the fused engine must surface observations between scan segments;
    # static (observation-free) strategies fuse the whole horizon
    adaptive = False

    def __init__(self, cfg: FedHPConfig, base_adj: np.ndarray):
        self.cfg = cfg
        self.base_adj = np.asarray(base_adj, dtype=np.int8)
        self.n = base_adj.shape[0]
        self.alive = np.ones(self.n, bool)

    def _membership(self, alive: np.ndarray | None) -> np.ndarray:
        """Record the round's alive set (churn is applied at round start,
        before planning) and return it as a bool mask."""
        if alive is not None:
            self.alive = np.asarray(alive, bool)
        return self.alive

    def _restrict(self, adj: np.ndarray) -> np.ndarray:
        """Drop departed workers' links; cheapest-reconnect the survivors
        if the departure disconnected the round topology."""
        if self.alive.all():
            return adj
        return topo.repair_connectivity(adj, self.alive)

    def plan(self, h: int, alive: np.ndarray | None = None) -> RoundPlan:
        """Fixed plan: the base topology (churn-restricted) at tau_init."""
        self._membership(alive)
        taus = np.full(self.n, self.cfg.tau_init, np.int64)
        taus[~self.alive] = 0
        return RoundPlan(self._restrict(self.base_adj.copy()), taus)

    def observe(self, h: int, *, adj, mu, beta, edge_dist, update_norms,
                smooth_l, sigma, loss, cross_loss=None, alive=None,
                wire_ratio: float = 1.0) -> None:
        """Ingest the round's measurements. ``wire_ratio`` is the
        uncompressed/compressed wire-bits ratio the engine actually
        charged this round (1.0 uncompressed) — the feedback the
        compression-aware planner learns the effective link times from."""
        if alive is not None:
            self.alive = np.asarray(alive, bool)


class DPSGDStrategy(Strategy):
    """D-PSGD [12]: synchronous, ring topology, identical tau."""

    name = "dpsgd"

    def __init__(self, cfg: FedHPConfig, base_adj: np.ndarray):
        super().__init__(cfg, base_adj)
        self.ring = topo.ring_topology(self.n)

    def plan(self, h: int, alive: np.ndarray | None = None) -> RoundPlan:
        """Fixed ring at tau_init every round (churn-restricted)."""
        self._membership(alive)
        taus = np.full(self.n, self.cfg.tau_init, np.int64)
        taus[~self.alive] = 0
        return RoundPlan(self._restrict(self.ring.copy()), taus)


class LDSGDStrategy(Strategy):
    """LD-SGD [21]: alternates I1 communication-free local rounds with I2
    gossip rounds (communication-efficient decentralized SGD)."""

    name = "ldsgd"

    def plan(self, h: int, alive: np.ndarray | None = None) -> RoundPlan:
        """I1 communication-free local rounds, then I2 ring-gossip rounds."""
        self._membership(alive)
        i1, i2 = self.cfg.ldsgd_i1, self.cfg.ldsgd_i2
        period = max(i1 + i2, 1)
        taus = np.full(self.n, self.cfg.tau_init, np.int64)
        taus[~self.alive] = 0
        if (h % period) < i1:                        # local-only round
            return RoundPlan(np.zeros_like(self.base_adj), taus)
        return RoundPlan(self._restrict(topo.ring_topology(self.n)), taus)


class PENSStrategy(Strategy):
    """PENS [22]: performance-based neighbor selection. Each round a worker
    samples `pens_sample` random peers, evaluates their models on its local
    data, and gossips with the `pens_top_m` lowest-loss (most similar
    distribution) peers. Selection costs extra compute+comm time — the
    overhead the paper measures in Fig. 7."""

    name = "pens"
    adaptive = True

    def __init__(self, cfg: FedHPConfig, base_adj: np.ndarray):
        super().__init__(cfg, base_adj)
        self.rng = np.random.default_rng(cfg.seed + 17)
        self._cross = None                      # [N,N] loss of model j on data i
        self._mu = np.full(self.n, 0.1)
        self._beta = np.full((self.n, self.n), 1.0)

    def plan(self, h: int, alive: np.ndarray | None = None) -> RoundPlan:
        """Sample pens_sample peers, keep the pens_top_m lowest-loss ones
        (round 0: random), charging the selection overhead as extra_time."""
        live = self._membership(alive)
        taus = np.full(self.n, self.cfg.tau_init, np.int64)
        taus[~live] = 0
        m, s = self.cfg.pens_top_m, self.cfg.pens_sample
        adj = np.zeros((self.n, self.n), np.int8)
        samples = np.zeros(self.n)
        pool = np.nonzero(live)[0]
        for i in pool:
            if len(pool) < 2:       # lone survivor: nothing to sample
                break
            cand = self.rng.choice([j for j in pool if j != i],
                                   size=min(s, len(pool) - 1), replace=False)
            samples[i] = len(cand)
            if self._cross is None:             # round 0: random top_m
                pick = cand[:m]
            else:
                pick = cand[np.argsort(self._cross[i, cand])[:m]]
            adj[i, pick] = 1
        adj = np.maximum(adj, adj.T)            # symmetrize
        np.fill_diagonal(adj, 0)
        adj = self._restrict(adj)               # keep gossip well-defined
        sub = adj[np.ix_(pool, pool)]
        if len(pool) > 1 and not topo.is_connected(sub):
            adj = np.maximum(adj, topo.repair_connectivity(
                topo.ring_topology(self.n), live))
        # selection overhead: receive + evaluate `s` candidate models
        extra = samples * (self._mu * 2.0) + \
            samples * np.median(self._beta[self._beta > 0]) \
            if (self._beta > 0).any() else samples * self._mu * 2.0
        return RoundPlan(adj, taus, extra_time=extra)

    def observe(self, h, *, adj, mu, beta, edge_dist, update_norms,
                smooth_l, sigma, loss, cross_loss=None, alive=None,
                wire_ratio: float = 1.0):
        """PENS feedback: the cross-loss matrix for neighbor selection
        plus the mu/beta estimates its selection overhead is priced by."""
        super().observe(h, adj=adj, mu=mu, beta=beta, edge_dist=edge_dist,
                        update_norms=update_norms, smooth_l=smooth_l,
                        sigma=sigma, loss=loss, alive=alive,
                        wire_ratio=wire_ratio)
        if cross_loss is not None:
            self._cross = cross_loss
        self._mu, self._beta = mu, beta


class FedHPStrategy(Strategy):
    """The paper's adaptive control (Alg. 1-3): joint tau + topology."""

    name = "fedhp"
    adaptive = True

    def __init__(self, cfg: FedHPConfig, base_adj: np.ndarray):
        super().__init__(cfg, base_adj)
        self.controller = AdaptiveController(base_adj, tau_max=cfg.tau_max,
                                             epsilon=cfg.epsilon)
        self.tracker = ConsensusTracker(self.n, beta1=cfg.beta1,
                                        beta2=cfg.beta2)
        self._mu = None
        self._beta = None
        self._f1 = None                         # f(xbar^1), fixed at round 1
        self._L = 1.0
        self._sigma = 1.0
        self.last_decision = None
        # compression awareness: the codec the run gossips under, the
        # replan-cadence k-tightening scheduler (sparse codecs only), and
        # the wire ratio learned from the engine's observe() feedback —
        # the Eq. 10 comm divisor the next decide() solves against
        codec = compression.parse_mode(cfg.compress)
        self.codec = codec if codec.kind != "none" else None
        self.k_scheduler = (SparsityScheduler(codec, cfg.sparse_k_floor)
                            if codec.is_sparse and cfg.tighten_k else None)
        self._wire_ratio = 1.0

    def _plan_codec(self, h: int) -> Codec | None:
        """The codec round h gossips and is billed under: the configured
        one, tightened at ``replan_every`` cadence when the feedback path
        is on (both engines replay plan() at those rounds, so the codec
        sequence — and with it the wire charge — stays bit-identical)."""
        if self.k_scheduler is None:
            return self.codec
        if h % max(self.cfg.replan_every, 1) == 0:
            return self.k_scheduler.step(self.tracker.mean_distance())
        return self.k_scheduler.codec

    def plan(self, h: int, alive: np.ndarray | None = None) -> RoundPlan:
        """One Alg. 3 decision (joint tau + topology) against the learned
        wire ratio, carrying the (possibly tightened) codec in the plan."""
        live = self._membership(alive)
        # membership can change between observe() and plan() (churn is
        # applied at round start): reconcile the tracker before deciding
        self.tracker.sync_membership(live)
        codec = self._plan_codec(h)
        if self._mu is None:                    # round 0: no measurements yet
            taus = np.full(self.n, self.cfg.tau_init, np.int64)
            taus[~live] = 0
            return RoundPlan(self._restrict(self.base_adj.copy()), taus,
                             codec=codec)
        wire = self._wire_ratio if self.cfg.planner_wire_aware else 1.0
        d = self.controller.decide(
            self._mu, self._beta, self.tracker, f1=self._f1,
            smooth_l=self._L, sigma=self._sigma, eta=self.cfg.lr,
            rounds=self.cfg.rounds, alive=live, wire_ratio=wire)
        self.last_decision = d
        return RoundPlan(d.adj, d.taus, codec=codec)

    def observe(self, h, *, adj, mu, beta, edge_dist, update_norms,
                smooth_l, sigma, loss, cross_loss=None, alive=None,
                wire_ratio: float = 1.0):
        """Alg. 1 feedback plus the engine's actual wire ratio — the
        planner learns the comm divisor it solves the next round with
        rather than assuming one (one-round lag, identical in both
        engines)."""
        super().observe(h, adj=adj, mu=mu, beta=beta, edge_dist=edge_dist,
                        update_norms=update_norms, smooth_l=smooth_l,
                        sigma=sigma, loss=loss, alive=alive,
                        wire_ratio=wire_ratio)
        self._mu, self._beta = np.asarray(mu), np.asarray(beta)
        self._wire_ratio = float(wire_ratio)
        if self._f1 is None:
            self._f1 = float(loss)
        self._L = max(float(smooth_l), 1e-6)
        self._sigma = max(float(sigma), 1e-6)
        self.tracker.update(adj, edge_dist, float(np.mean(update_norms)))


STRATEGIES = {
    "base": Strategy,
    "fedhp": FedHPStrategy,
    "dpsgd": DPSGDStrategy,
    "ldsgd": LDSGDStrategy,
    "pens": PENSStrategy,
}


def make_strategy(cfg: FedHPConfig, base_adj: np.ndarray) -> Strategy:
    """Instantiate the strategy ``cfg.algorithm`` names over ``base_adj``."""
    if cfg.algorithm == "adpsgd":
        raise ValueError("AD-PSGD is asynchronous; use engine.run_adpsgd")
    return STRATEGIES[cfg.algorithm](cfg, base_adj)
