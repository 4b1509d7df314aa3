"""Heterogeneous edge-cluster model (paper Sec. V-C1) + dynamic membership.
A numpy copy of ``repro.simulation.cluster``: the same seed gives the same
draws in the same order (``advance_round``, ``sample_mu``,
``sample_beta``), which is what keeps both packages' clocks equal.

- Computing: each worker draws per-round per-iteration computing time from a
  Gaussian whose (mean, std) comes from a commercial-device profile
  (laptop / Jetson TX2 / Xavier NX / RPi-class), randomly assigned —
  "tenfold difference in computing capabilities".
- Communication: per-worker bandwidth fluctuates in [1, 10] Mb/s; link time
  beta_ij = model_bits / min(bw_i, bw_j) (the slower endpoint gates the
  P2P transfer).
- Churn: a declarative, seeded ``ChurnSchedule`` of join / leave / crash /
  straggler-spike events drives dynamic membership — the scenario axis the
  paper's fixed worker set never exercises (DySTop-style dynamics). The
  legacy ``fail_at``/``recover_at`` hooks remain as a thin special case.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# (mean, std) seconds per local iteration — relative scales from the paper's
# cited commercial devices; a ~10x spread between fastest and slowest.
DEVICE_PROFILES: dict[str, tuple[float, float]] = {
    "workstation": (0.05, 0.005),
    "laptop": (0.10, 0.01),
    "xavier_nx": (0.20, 0.03),
    "jetson_tx2": (0.35, 0.05),
    "rpi4": (0.55, 0.10),
}

BW_LOW_MBPS = 1.0
BW_HIGH_MBPS = 10.0

CHURN_KINDS = ("leave", "crash", "join", "straggle")


@dataclass(frozen=True)
class ChurnEvent:
    """One membership/performance event at the start of round ``round``.

    kind:
      leave    — graceful departure (worker announces and drops out)
      crash    — abrupt failure (survivors also pay a detection timeout)
      join     — (re-)admission; the engine re-initializes the model row
      straggle — compute slows by ``factor`` for ``duration`` rounds

    ``group`` carries a correlated-failure payload: when non-empty the
    event applies to every worker in it at once (a rack/region outage
    from ``generate_correlated``) and ``worker`` is just the group's
    representative. Single-worker events leave it empty.
    """
    round: int
    kind: str
    worker: int
    factor: float = 4.0
    duration: int = 5
    group: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in CHURN_KINDS:
            raise ValueError(f"unknown churn kind {self.kind!r}")

    @property
    def workers(self) -> tuple[int, ...]:
        """Every worker the event applies to: the correlated ``group``
        when present, else the single ``worker``."""
        return self.group if self.group else (self.worker,)


def _alive_replay(events: list[ChurnEvent], num_workers: int):
    """Closure over a schedule-in-progress: ``alive_at(r)`` replays the
    membership events scheduled so far up to round ``r`` — the ground
    truth the generators' ``min_alive`` guards hold against (a rejoin
    only restores its workers from its `back` round on). Group events
    apply to every member."""
    def alive_at(r: int) -> np.ndarray:
        a = np.ones(num_workers, bool)
        for e in sorted(events, key=lambda e: e.round):
            if e.round > r:
                break
            if e.kind in ("leave", "crash"):
                a[list(e.workers)] = False
            elif e.kind == "join":
                a[list(e.workers)] = True
        return a
    return alive_at


@dataclass(frozen=True)
class ChurnSchedule:
    """Declarative, immutable event list; index by round via events_at()."""

    events: tuple[ChurnEvent, ...] = ()

    def events_at(self, h: int) -> list[ChurnEvent]:
        """Every event scheduled for the start of round ``h``."""
        return [e for e in self.events if e.round == h]

    @property
    def departure_rounds(self) -> list[int]:
        """Sorted rounds at which any leave/crash event fires."""
        return sorted(e.round for e in self.events
                      if e.kind in ("leave", "crash"))

    @classmethod
    def generate(cls, num_workers: int, rounds: int, *, rate: float,
                 seed: int = 0, kinds: tuple[str, ...] = CHURN_KINDS,
                 min_alive: int = 2, rejoin_p: float = 0.5,
                 straggle_factor: float = 4.0,
                 straggle_duration: int = 5) -> "ChurnSchedule":
        """Seeded generator: ~``rate`` of the fleet departs over the run
        (split between leave and crash), departed workers rejoin with
        probability ``rejoin_p``, and an equal number of straggler spikes
        hits random survivors. Never schedules a departure that would take
        the alive set below ``min_alive``.
        """
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0,1], got {rate}")
        rng = np.random.default_rng(seed)
        n_depart = int(round(rate * num_workers))
        events: list[ChurnEvent] = []
        # spread departures over the middle of the run so there is a
        # before/after on both sides
        lo, hi = max(1, rounds // 10), max(2, rounds - rounds // 10)
        depart_rounds = np.sort(rng.integers(lo, hi, n_depart))
        alive_at = _alive_replay(events, num_workers)
        # sample each departure's kind from the allowed subset — a fixed
        # leave/crash coin that `continue`d on disallowed kinds silently
        # halved the delivered rate for kinds=("crash",) and dropped the
        # paired rejoin with it
        dep_kinds = tuple(k for k in ("leave", "crash") if k in kinds)

        for r in depart_rounds if dep_kinds else ():
            a = alive_at(int(r))
            # the departure must keep min_alive from round r until the
            # departed worker's own rejoin (if any) — check the minimum
            # alive count over the remaining rounds after removing w
            if a.sum() <= min_alive:
                continue
            w = int(rng.choice(np.nonzero(a)[0]))
            kind = str(rng.choice(dep_kinds))
            events.append(ChurnEvent(int(r), kind, w))
            if any(alive_at(rr).sum() < min_alive
                   for rr in range(int(r), rounds)):
                events.pop()                       # would starve the fleet
                continue
            if "join" in kinds and rng.random() < rejoin_p:
                back = int(rng.integers(r + 2, max(r + 3, rounds)))
                if back < rounds:
                    events.append(ChurnEvent(back, "join", w))
        if "straggle" in kinds:
            for _ in range(n_depart):
                r = int(rng.integers(lo, hi))
                # spikes must hit survivors: draw from the alive set at
                # the spike round (a spike on a departed worker is a
                # silent no-op that under-delivers the scenario)
                a = alive_at(r)
                if not a.any():
                    continue
                w = int(rng.choice(np.nonzero(a)[0]))
                events.append(ChurnEvent(r, "straggle", w,
                                         factor=straggle_factor,
                                         duration=straggle_duration))
        events.sort(key=lambda e: (e.round, e.worker))
        return cls(tuple(events))

    @classmethod
    def generate_correlated(cls, num_workers: int, rounds: int, *,
                            racks: int, outages: int, seed: int = 0,
                            min_alive: int = 2, rejoin_p: float = 0.5,
                            outage_len: int = 5,
                            kind: str = "crash") -> "ChurnSchedule":
        """Seeded correlated-failure generator: ``outages`` rack/region
        outage events, each taking out one whole rack (the same
        contiguous ``topology.rack_assignment`` blocks the ``geo:<racks>``
        topology uses, so an outage removes exactly one dense
        neighborhood). Each outage is a single grouped ``kind`` event;
        with probability ``rejoin_p`` the rack comes back as a grouped
        join after ``outage_len`` rounds. Racks are trimmed (and outages
        skipped) as needed so the alive count never drops below
        ``min_alive``.
        """
        from repro_torch.core.topology import rack_assignment
        if kind not in ("leave", "crash"):
            raise ValueError(f"outage kind must be leave|crash, got {kind!r}")
        rng = np.random.default_rng(seed)
        assign = rack_assignment(num_workers, racks)
        events: list[ChurnEvent] = []
        lo, hi = max(1, rounds // 10), max(2, rounds - rounds // 10)
        alive_at = _alive_replay(events, num_workers)
        for r in np.sort(rng.integers(lo, hi, outages)):
            rack = int(rng.integers(0, racks))
            a = alive_at(int(r))
            members = np.nonzero((assign == rack) & a)[0]
            # trim the group so the fleet keeps min_alive survivors
            take = min(members.size, int(a.sum()) - min_alive)
            if take <= 0:
                continue
            group = tuple(int(w) for w in members[:take])
            events.append(ChurnEvent(int(r), kind, group[0], group=group))
            if any(alive_at(rr).sum() < min_alive
                   for rr in range(int(r), rounds)):
                events.pop()                       # would starve the fleet
                continue
            back = int(r) + max(outage_len, 1)
            if rng.random() < rejoin_p and back < rounds:
                events.append(ChurnEvent(back, "join", group[0],
                                         group=group))
        events.sort(key=lambda e: (e.round, e.worker))
        return cls(tuple(events))


@dataclass
class SimCluster:
    """The simulated heterogeneous fleet: seeded per-round compute/link
    time draws (device profiles + fluctuating bandwidth) plus dynamic
    membership — ``advance_round`` replays the ``ChurnSchedule`` (and the
    legacy ``fail_at``/``recover_at`` hooks) into the alive mask the
    engines consume.

    ``model_bits`` is the uncompressed per-transfer payload in bits —
    32 x the model's TRUE parameter count, taken from the run's
    ``ModelAdapter.model_bits`` (core/modelspec.py) by
    ``experiment.setup_experiment``; Eq. 10 comm times (``sample_beta``)
    follow whatever model actually trains, not a hard-coded constant."""

    num_workers: int
    model_bits: float                    # per-transfer payload (bits)
    seed: int = 0
    heterogeneous: bool = True
    fail_at: dict[int, list[int]] = field(default_factory=dict)
    # round -> worker ids that die at that round
    recover_at: dict[int, list[int]] = field(default_factory=dict)
    churn: ChurnSchedule | None = None

    def __post_init__(self):
        if self.churn is not None:
            for e in self.churn.events:
                for w in e.workers:
                    if not 0 <= w < self.num_workers:
                        raise ValueError(
                            f"churn event {e} targets worker {w}; "
                            f"cluster has {self.num_workers} workers")
        rng = np.random.default_rng(self.seed)
        profiles = list(DEVICE_PROFILES.values())
        if self.heterogeneous:
            pick = rng.integers(0, len(profiles), self.num_workers)
        else:
            pick = np.full(self.num_workers, 1)          # all "laptop"
        self.mu_mean = np.array([profiles[i][0] for i in pick])
        self.mu_std = np.array([profiles[i][1] for i in pick])
        self._rng = rng
        self.alive = np.ones(self.num_workers, bool)
        # churn bookkeeping, refreshed by advance_round
        self._straggle_factor = np.ones(self.num_workers)
        self._straggle_until = np.full(self.num_workers, -1)
        self.last_joined = np.zeros(self.num_workers, bool)
        self.last_crashed = np.zeros(self.num_workers, bool)

    # -- per-round draws ----------------------------------------------------
    def sample_mu(self) -> np.ndarray:
        """(N,) per-iteration computing time for this round (straggler
        spikes multiply the base draw)."""
        mu = self._rng.normal(self.mu_mean, self.mu_std)
        return np.maximum(mu, 1e-3) * self._straggle_factor

    def sample_bandwidth(self) -> np.ndarray:
        """(N,) worker uplink bandwidth in bit/s, fluctuating 1-10 Mb/s."""
        mbps = self._rng.uniform(BW_LOW_MBPS, BW_HIGH_MBPS, self.num_workers)
        return mbps * 1e6

    def sample_beta(self) -> np.ndarray:
        """(N,N) pairwise link time (s) for one model transfer."""
        bw = self.sample_bandwidth()
        pair_bw = np.minimum(bw[:, None], bw[None, :])
        beta = self.model_bits / pair_bw
        np.fill_diagonal(beta, 0.0)
        return beta

    # -- membership ---------------------------------------------------------
    def advance_round(self, h: int) -> np.ndarray:
        """Apply round-h churn + legacy failures/recoveries; returns the
        alive mask. ``last_joined``/``last_crashed`` flag this round's
        admissions and abrupt failures for the engine."""
        self.last_joined[:] = False
        self.last_crashed[:] = False
        expired = self._straggle_until <= h
        self._straggle_factor[expired] = 1.0
        for w in self.fail_at.get(h, []):
            self.alive[w] = False
        for w in self.recover_at.get(h, []):
            if not self.alive[w]:
                self.alive[w] = True
                self.last_joined[w] = True
        if self.churn is not None:
            for ev in self.churn.events_at(h):
                # grouped events (correlated rack outages) apply the same
                # transition to every member in one round
                for w in ev.workers:
                    if ev.kind in ("leave", "crash") and self.alive[w]:
                        self.alive[w] = False
                        if ev.kind == "crash":
                            self.last_crashed[w] = True
                    elif ev.kind == "join" and not self.alive[w]:
                        self.alive[w] = True
                        self.last_joined[w] = True
                    elif ev.kind == "straggle":
                        # active for rounds h .. h+duration-1 (exactly
                        # duration rounds)
                        self._straggle_factor[w] = max(ev.factor, 1.0)
                        self._straggle_until[w] = h + max(ev.duration, 1)
        return self.alive.copy()
