"""Byzantine attack models and robust gossip aggregation — the port of
``repro.core.robust``.

Threat model (lie on the wire): workers in ``cfg.byzantine`` train their
local row honestly but transmit a corrupted copy at every gossip
exchange — sign-flipped (``"signflip[:scale]"`` sends ``-scale * x``) or
norm-blown (``"largenorm[:scale]"`` sends ``scale * x``). The
countermeasure is on the aggregating side: instead of the weighted Eq. 5
mix, each worker robust-averages the multiset ``{x_i} ∪ {T_j : j ∈
N(i)}`` of its own row and the transmitted neighbour rows,
coordinate-wise:

- ``"trimmed:<b>"`` drops the b largest and b smallest values per
  coordinate and averages the rest (b a fraction of the closed
  neighbourhood when < 1, an absolute count otherwise; clamped to
  (cnt - 1) // 2);
- ``"median"`` takes the coordinate-wise median.

Two device forms mirror the two gossip representations: the gathered
dense form (``robust_gossip_dense``: a padded neighbour table, sort,
window) and, for the trimmed mean over edge lists, the peeling form
``trimmed_mean_edges`` (each step removes one extreme per side per
coordinate, ties broken by the lowest edge id). The attacked baseline
(plain Eq. 5 over the lying wire) has a dense and an edge-list form too.

AD-PSGD's pairwise exchange has no window to trim over, so the
asynchronous engines take ``"screen:<z>"``: each endpoint z-tests the
incoming payload against the EMA of its own update norms
(``screen_fold`` / ``screen_accept``) and keeps its row on rejection.

Everything here is plain PyTorch, as the reference's module is plain
jnp: the fused engine's hand-written kernels (``kernels/ops.py``:
``robust_gossip``, ``gossip_edges``, ``gossip_mix``) replace these forms
on its path. The edge-list sums go slot by slot over the CSR form
(``kernels/ref.csr_slots``) rather than through ``index_add_``, whose
CUDA atomics add in an order that changes from run to run: each row's
edges are added in list order, the order the reference's
``segment_sum`` adds them in on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.topology import edges_to_csr
from repro_torch.kernels.ref import csr_slots, resolve_trim
from repro_torch.kernels.ref import robust_gossip_ref as robust_gossip_dense

__all__ = ["SCREEN_EMA_ALPHA", "Scenario", "apply_attack", "attack_row",
           "byzantine_mask", "gossip_byz_dense", "gossip_byz_edges",
           "neighbor_table", "parse_attack", "parse_robust",
           "resolve_trim", "robust_gossip_dense", "scenario",
           "screen_accept", "screen_fold", "segment_mix_delta",
           "trimmed_mean_edges"]

# EMA smoothing of each worker's own-delta-norm history (screening)
SCREEN_EMA_ALPHA = 0.25


def parse_attack(spec: str) -> tuple[str, float]:
    """``"signflip[:scale]"`` / ``"largenorm[:scale]"`` -> (kind, scale);
    default scales 1.0 and 10.0."""
    head, _, tail = spec.partition(":")
    if head == "signflip":
        return "signflip", float(tail) if tail else 1.0
    if head == "largenorm":
        return "largenorm", float(tail) if tail else 10.0
    raise ValueError(f"unknown byzantine attack {spec!r}")


def parse_robust(spec: str) -> tuple[str, float]:
    """``"none"`` | ``"trimmed:<b>"`` | ``"median"`` | ``"screen:<z>"``
    -> (mode, b): the trim knob for ``trimmed`` (0 for none/median), the
    z-threshold for ``screen`` (> 0)."""
    if spec == "none":
        return "none", 0.0
    if spec == "median":
        return "median", 0.0
    if spec.startswith("trimmed:"):
        b = float(spec.split(":", 1)[1])
        if b < 0:
            raise ValueError(f"trim count must be >= 0, got {b}")
        return "trimmed", b
    if spec.startswith("screen:"):
        z = float(spec.split(":", 1)[1])
        if z <= 0:
            raise ValueError(f"screen threshold must be > 0, got {z}")
        return "screen", z
    raise ValueError(f"unknown robust mode {spec!r}")


def byzantine_mask(byzantine: tuple[int, ...], n: int) -> np.ndarray:
    """``cfg.byzantine`` -> boolean [N] mask (validated against N)."""
    m = np.zeros(n, bool)
    for w in byzantine:
        if not 0 <= w < n:
            raise ValueError(f"byzantine worker {w} outside fleet of {n}")
        m[w] = True
    return m


@dataclass(frozen=True)
class Scenario:
    """A run's parsed Byzantine scenario: the attackers (``byz`` [W]
    bool), the attack (kind, scale) and the robust mode with its knob
    (trim b or screen z)."""

    byz: np.ndarray
    attack: str
    scale: float
    mode: str
    knob: float

    @property
    def has_byz(self) -> bool:
        return bool(self.byz.any())

    @property
    def active(self) -> bool:
        """Gossip leaves the honest weighted mix (attackers or a robust
        mode)."""
        return self.has_byz or self.mode != "none"

    def honest(self, alive: np.ndarray) -> np.ndarray:
        """The workers the metrics describe: the honest alive ones (all
        alive ones if the fleet is honest, or if no honest worker is
        alive)."""
        meas = alive & ~self.byz
        return meas if self.has_byz and meas.any() else alive


def scenario(cfg, *, asynchronous: bool) -> Scenario:
    """Parse ``cfg``'s scenario axis and raise, as the reference engines
    do, ``ValueError`` for what does not compose: a ``screen:`` mode on a
    synchronous engine, trimmed/median on AD-PSGD, and attackers or a
    robust mode under ``cfg.compress``."""
    byz = byzantine_mask(cfg.byzantine, cfg.num_workers)
    mode, knob = parse_robust(cfg.robust)
    if mode == "screen" and not asynchronous:
        raise ValueError(
            "cfg.robust='screen:<z>' is the AD-PSGD accept/reject rule; "
            "synchronous engines use 'trimmed:<b>' / 'median'")
    if mode in ("trimmed", "median") and asynchronous:
        raise ValueError(
            "trimmed/median robust gossip is synchronous-engine only "
            "(a 2-sample pairwise exchange has no trim window); AD-PSGD "
            "takes cfg.robust='screen:<z>'")
    if (byz.any() or mode != "none") and cfg.compress != "none":
        raise ValueError(
            "cfg.byzantine / cfg.robust do not compose with cfg.compress")
    kind, scale = (parse_attack(cfg.byzantine_attack) if byz.any()
                   else ("signflip", 1.0))
    return Scenario(byz, kind, scale, mode, knob)


def _corrupt(x: torch.Tensor, scale: float, kind: str) -> torch.Tensor:
    if kind == "signflip":
        return -scale * x
    if kind == "largenorm":
        return scale * x
    raise ValueError(f"unknown byzantine attack kind {kind!r}")


def apply_attack(flat: torch.Tensor, byz: torch.Tensor, scale: float, *,
                 kind: str) -> torch.Tensor:
    """The transmitted copy of the [W, P] matrix: byzantine rows (``byz``
    [W] bool) replaced by the attack's corruption, honest rows as they
    are."""
    return torch.where(byz[:, None], _corrupt(flat, scale, kind), flat)


def attack_row(row: torch.Tensor, is_byz: bool, scale: float, *,
               kind: str) -> torch.Tensor:
    """One row's transmitted copy for the pairwise AD-PSGD exchange,
    corrupted iff ``is_byz`` (known on the host from the schedule)."""
    return _corrupt(row, scale, kind) if is_byz else row


# ---------------------------------------------------------------------------
# plain (non-robust) mixing, honest or over a lying wire
# ---------------------------------------------------------------------------

def segment_mix_delta(x: torch.Tensor, t: torch.Tensor, csr) -> torch.Tensor:
    """The reference's ``segment_sum`` of per-edge deltas, deterministic:
    row d gets sum_e w_e (t[src_e] - x[d]) over its incoming edges of the
    CSR list ``csr`` = (row_ptr, col, w), summed from zero in list
    order. With t = x it is the sparse mixing delta ``W x - x``."""
    acc = torch.zeros_like(x)
    for wj, cj in csr_slots(*csr):
        acc = acc + wj[:, None] * (t[cj] - x)
    return acc


def gossip_byz_dense(flat: torch.Tensor, transmitted: torch.Tensor,
                     mix: torch.Tensor) -> torch.Tensor:
    """Eq. 5 when the wire lies: y_i = W_ii x_i + sum_{j != i} W_ij T_j —
    each worker mixes the transmitted neighbour rows with its own honest
    row."""
    mixed = torch.matmul(mix, transmitted)
    return mixed + torch.diagonal(mix)[:, None] * (flat - transmitted)


def gossip_byz_edges(flat: torch.Tensor, transmitted: torch.Tensor,
                     csr) -> torch.Tensor:
    """Edge-list twin of ``gossip_byz_dense``: y[d] = x[d] + sum_e w_e
    (T[src_e] - x[d])."""
    return flat + segment_mix_delta(flat, transmitted, csr)


# ---------------------------------------------------------------------------
# robust aggregation
# ---------------------------------------------------------------------------

def neighbor_table(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side padded neighbour table of a dense adjacency: (nbr
    [W, D_max] int32, deg [W] int32), row i listing N(i) ascending, then
    zeros. D_max is at least 1."""
    n = adj.shape[0]
    deg = np.asarray(adj).sum(axis=1).astype(np.int32)
    d_max = max(int(deg.max()) if n else 0, 1)
    nbr = np.zeros((n, d_max), np.int32)
    for i in range(n):
        js = np.nonzero(adj[i])[0]
        nbr[i, :js.size] = js
    return nbr, deg


def _segment_extreme(vals: torch.Tensor, seg: torch.Tensor, n: int,
                     reduce: str, fill) -> torch.Tensor:
    """Per-(segment, coordinate) max or min of ``vals`` [M, P] segmented
    by ``seg`` [M] — exact, so the order of the reduction is moot."""
    out = torch.full((n, vals.shape[1]), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(vals), vals, reduce,
                              include_self=False)


def trimmed_mean_edges(flat: torch.Tensor, transmitted: torch.Tensor,
                       src: np.ndarray, dst: np.ndarray, *, b: float,
                       num_workers: int, b_max: int) -> torch.Tensor:
    """The trimmed mean over a directed edge list without a dense
    neighbour block. The closed neighbourhood is an extended list — the
    transmitted source rows segmented by destination, then one honest
    self entry per worker — and ``b_max`` peeling steps each remove, per
    (segment, coordinate), one entry attaining the current max and one
    attaining the min (the lowest edge id among ties); workers whose own
    trim b_i is below the step stop peeling. The survivors' sum (in
    list order, see ``segment_mix_delta``) over cnt - 2 b_i is the
    mean; workers with no incoming edge keep their row."""
    w = num_workers
    dev = flat.device
    vals = torch.cat([transmitted[torch.as_tensor(src, device=dev).long()],
                      flat])                                   # [E + W, P]
    seg_np = np.concatenate([np.asarray(dst), np.arange(w)]).astype(np.int64)
    seg = torch.as_tensor(seg_np, device=dev)
    m = vals.shape[0]
    deg = torch.as_tensor(np.bincount(np.asarray(dst, np.int64),
                                      minlength=w), device=dev)
    cnt = deg + 1
    bi = resolve_trim(b, cnt)
    keep = torch.ones_like(vals, dtype=torch.bool)
    eid = torch.arange(m, device=dev)[:, None]
    for step in range(b_max):
        active = (step < bi)[seg][:, None]
        for sense in (1.0, -1.0):
            sv = torch.where(keep, sense * vals, -float("inf"))
            ext = _segment_extreme(sv, seg, w, "amax", -float("inf"))
            attain = keep & (sense * vals == ext[seg]) & active
            cand = torch.where(attain, eid, m)
            winner = _segment_extreme(cand, seg, w, "amin", m)
            keep = keep & ~(attain & (eid == winner[seg]))
    # the survivors summed per segment through a CSR of the extended list
    csr = edges_to_csr(np.arange(m), seg_np, np.ones(m), w)
    kept = torch.where(keep, vals, 0.0)
    total = segment_mix_delta(torch.zeros_like(flat), kept,
                              [torch.as_tensor(a, device=dev) for a in csr])
    y = total / (cnt - 2 * bi).to(torch.float32)[:, None]
    return torch.where((deg > 0)[:, None], y, flat)


# ---------------------------------------------------------------------------
# AD-PSGD accept/reject screening ("screen:<z>")
# ---------------------------------------------------------------------------

def screen_fold(h: torch.Tensor, nd_own: torch.Tensor) -> torch.Tensor:
    """Fold one own-delta norm into the scalar EMA history ``h``; an
    unseeded history (h == 0) takes the first norm as it is."""
    a = SCREEN_EMA_ALPHA
    return torch.where(h > 0, (1.0 - a) * h + a * nd_own, nd_own)


def screen_accept(x_self: torch.Tensor, t_peer: torch.Tensor,
                  h: torch.Tensor, z: float) -> torch.Tensor:
    """Accept/reject verdict (0-d bool tensor, on the device) for one
    incoming payload: with a seeded history (h > 0) the z-test
    ||t_peer - x_self|| <= z h, before it the cosine fallback
    <t_peer, x_self> >= 0."""
    nd = torch.linalg.vector_norm(t_peer - x_self)
    cos_ok = torch.dot(t_peer, x_self) >= 0
    return torch.where(h > 0, nd <= h * z, cos_ok)
