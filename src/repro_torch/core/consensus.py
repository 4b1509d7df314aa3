"""Consensus-distance machinery (Sec. II-C, IV-A; Eq. 7-9, 34-39, 43).
A numpy copy of ``repro.core.consensus``, bit-exact against it.

The coordinator only ever sees distances measured along topology edges
(worker i can compute ||x_i - x_j|| only for j in N_i). Unmeasured pairs are
estimated via the triangle-inequality shortest path (Floyd-Warshall,
Eq. 37-38) and EMA-smoothed (Eq. 39). The consensus budget D_max follows the
EMA of the mean local-update norm (Eq. 43, after Kong et al. [35]).
"""
from __future__ import annotations

import numpy as np

_INF = np.float64(np.inf)


def measured_distance_matrix(adj: np.ndarray,
                             pair_dist: np.ndarray) -> np.ndarray:
    """Mask a full pairwise-distance matrix down to topology edges.

    In the real system workers report only edge distances; simulation
    computes the full matrix and this mask models the coordinator's view.
    """
    d = np.where(adj > 0, pair_dist, _INF)
    np.fill_diagonal(d, 0.0)
    return d


# Beyond this worker count the exact O(N^3) Floyd-Warshall is replaced by a
# bounded-hop min-plus relaxation over the measured edge list (O(hops * E * N)).
FW_DENSE_MAX = 512


def _bounded_hop_estimate(d: np.ndarray, hops: int) -> np.ndarray:
    """Min-plus relaxation restricted to the measured edges.

    Each hop applies d[:, j] <- min(d[:, j], d[:, i] + w_ij) simultaneously
    over every measured (undirected, so both orientations) edge, so after
    ``hops`` passes d[i, j] is the exact shortest path among paths of at most
    ``hops + 1`` edges — longer detours are ignored, which upper-bounds the
    true shortest path exactly like the triangle inequality does (Eq. 37).
    Cost per hop is O(E * N) with one reduceat, no N x N x N blowup.
    """
    n = d.shape[0]
    fin = np.isfinite(d)
    np.fill_diagonal(fin, False)
    ii, jj = np.nonzero(fin)
    if ii.size == 0:
        return d
    order = np.argsort(jj, kind="stable")
    ii, jj = ii[order], jj[order]
    w = d[ii, jj]
    starts = np.flatnonzero(np.r_[True, jj[1:] != jj[:-1]])
    dest = jj[starts]
    for _ in range(hops):
        cand = d[:, ii] + w[None, :]                       # [N, 2E]
        mins = np.minimum.reduceat(cand, starts, axis=1)   # [N, U]
        before = d[:, dest]
        after = np.minimum(before, mins)
        if np.array_equal(before, after):
            break
        d[:, dest] = after
    return d


def floyd_warshall_estimate(edge_dist: np.ndarray, *,
                            max_dense: int = FW_DENSE_MAX,
                            hops: int = 3) -> np.ndarray:
    """Eq. (37)-(38): estimate unmeasured pair distances as the shortest
    path over measured edges.

    For n <= ``max_dense`` this is the exact vectorized Floyd-Warshall
    (O(N^3) — fine to a few hundred workers). Beyond the threshold it
    switches to ``_bounded_hop_estimate``: ``hops`` rounds of min-plus
    relaxation along the measured edge list, O(hops * E * N) total. Paths
    longer than hops+1 edges stay at their previous estimate (the caller
    falls back to the prior EMA for non-finite entries), which matters
    little in practice: the planner keeps topologies low-diameter, and
    Eq. 39 re-smooths every round.
    """
    d = np.array(edge_dist, dtype=np.float64)
    n = d.shape[0]
    if n <= max_dense:
        for p in range(n):
            # d_ij <- min(d_ij, d_ip + d_pj)
            cand = d[:, p:p + 1] + d[p:p + 1, :]
            np.minimum(d, cand, out=d)
        return d
    return _bounded_hop_estimate(d, hops)


class ConsensusTracker:
    """Coordinator-side consensus-distance state across rounds."""

    def __init__(self, num_workers: int, beta1: float = 0.5,
                 beta2: float = 0.1):
        self.n = num_workers
        self.beta1 = float(beta1)   # Eq. (39) EMA for estimated distances
        self.beta2 = float(beta2)   # Eq. (43) EMA for D_max
        self.dist = np.zeros((num_workers, num_workers))
        self.d_max = 0.0
        self._rounds = 0
        # dynamic membership: rows/cols of absent workers are dropped so the
        # Floyd-Warshall estimate never routes through (or budgets for) a
        # worker that has churned out
        self.present = np.ones(num_workers, bool)

    def sync_membership(self, alive: np.ndarray) -> None:
        """Reconcile tracker state with the round's alive set.

        Departed workers' rows/columns are zeroed (no stale estimates carry
        over, and Eq. 36 stops charging their pairs). Newly joined workers
        start from the mean surviving pair distance — a pessimistic fresh
        prior that keeps the budget check meaningful until their first
        measured edges arrive.
        """
        alive = np.asarray(alive, bool)
        departed = self.present & ~alive
        joined = alive & ~self.present
        if departed.any():
            self.dist[departed, :] = 0.0
            self.dist[:, departed] = 0.0
        if joined.any():
            stay = np.nonzero(alive & self.present)[0]
            if len(stay) > 1:
                sub = self.dist[np.ix_(stay, stay)]
                fill = float(sub.sum() / max(len(stay) * (len(stay) - 1), 1))
            else:
                fill = 0.0
            for w in np.nonzero(joined)[0]:
                self.dist[w, alive] = fill
                self.dist[alive, w] = fill
                self.dist[w, w] = 0.0
        self.present = alive.copy()

    def update(self, adj: np.ndarray, edge_dist: np.ndarray,
               mean_update_norm: float) -> np.ndarray:
        """Ingest round-h measurements; return the smoothed full estimate.

        adj: (N,N) round topology. edge_dist: (N,N) with entries valid only
        where adj==1 (others ignored). mean_update_norm: (1/N) sum ||g_i||.
        """
        masked = measured_distance_matrix(adj, edge_dist)
        est = floyd_warshall_estimate(masked)
        # Disconnected pairs (shouldn't happen: topology is connected) ->
        # fall back to previous value.
        est = np.where(np.isfinite(est), est, self.dist)
        if self._rounds == 0:
            smoothed = est
        else:
            # Eq. (39): EMA only where unmeasured; measured edges are exact.
            smoothed = np.where(
                adj > 0, est,
                (1 - self.beta1) * self.dist + self.beta1 * est)
        np.fill_diagonal(smoothed, 0.0)
        self.dist = smoothed
        # Eq. (43): D_max^h = (1-beta2) D_max^{h-1} + beta2 * mean ||g||
        if self._rounds == 0:
            self.d_max = float(mean_update_norm)
        else:
            self.d_max = ((1 - self.beta2) * self.d_max
                          + self.beta2 * float(mean_update_norm))
        self._rounds += 1
        return self.dist

    def mean_distance(self) -> float:
        """Mean estimated pairwise distance over present off-diagonal
        pairs — the scalar consensus signal the compression feedback path
        (``controller.SparsityScheduler``) tightens k against."""
        mask = np.outer(self.present, self.present)
        np.fill_diagonal(mask, False)
        m = int(mask.sum())
        return float((self.dist * mask).sum() / m) if m else 0.0

    def average_consensus_bound(self, adj: np.ndarray) -> float:
        """Eq. (36): E D^{h+1} <= (1/N^2) sum_ij (1 - a_ij) D_ij, summed and
        normalized over the present worker set only."""
        off = (1 - adj) * self.dist
        np.fill_diagonal(off, 0.0)
        mask = np.outer(self.present, self.present)
        m = max(int(self.present.sum()), 1)
        return float((off * mask).sum() / (m * m))

    def satisfies_budget(self, adj: np.ndarray) -> bool:
        """First constraint of Eq. (42)."""
        return self.average_consensus_bound(adj) <= self.d_max + 1e-12


def consensus_distance_to_mean(stacked_models: np.ndarray) -> np.ndarray:
    """Eq. (8): D_i = ||xbar - x_i|| for (N, P) stacked flat models.

    Only available in simulation / tests (no PS in production, per paper)."""
    mean = stacked_models.mean(axis=0, keepdims=True)
    return np.linalg.norm(stacked_models - mean, axis=1)


def pairwise_distances(stacked_models: np.ndarray) -> np.ndarray:
    """Eq. (7): full pairwise L2 matrix for (N, P) stacked flat models."""
    sq = (stacked_models ** 2).sum(axis=1)
    g = stacked_models @ stacked_models.T
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * g, 0.0)
    np.fill_diagonal(d2, 0.0)
    return np.sqrt(d2)
