"""The reference engines — the port of ``repro.core.engine``'s dense,
single-device path.

``run_dfl``: per round the strategy plans (A^h, tau^h); the workers run
tau_i local SGD steps (the whole fleet at once, masked to tau_i — masked
steps still run and change nothing); the simulated clock charges
t_i = tau_i mu_i + max_j beta_ij (Eq. 10; a compressed link's beta
divided by the codec's wire ratio); gossip mixes with the uniform matrix
(Eq. 5-6) as ``x <- mix @ x`` — or over the round's directed edge list
under ``cfg.gossip="sparse"`` — or under ``cfg.compress`` through the
codec's compensated update (``compression.compressed_gossip_ref``), or
under the Byzantine scenario axis (``cfg.byzantine`` / ``cfg.robust``)
over the lying wire, plainly or robustly (``core/robust.py``);
measurements (consensus distances, update norms, the L/sigma estimates
of Alg. 1 lines 4-5) feed back to the strategy. One Python iteration per
round, with host syncs for the measurements: the semantic ground truth
``fused.run_dfl_fused`` is held against.

``run_adpsgd``: the event-driven AD-PSGD baseline [23]. Its control
plane (heap of finish times, partners, churn at round boundaries,
staleness) is the pure host function ``adpsgd_schedule``; the engine
replays the events one by one — the ground truth of
``fused.run_adpsgd_fused``. Attackers lie on its pairwise wire too, and
``cfg.robust="screen:<z>"`` screens each incoming payload.

Parameters live as ONE flat ``[W, P]`` f32 tensor in the reference's leaf
layout (``modelspec``); the model sees leaf views of it. Every entry
point takes ``device``: ``None`` means the GPU and raises without one;
only an explicit ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import FedHPConfig
from repro_torch.core import compression
from repro_torch.core import modelspec
from repro_torch.core import robust
from repro_torch.core import topology as topo
from repro_torch.core.algorithms import Strategy
from repro_torch.core.consensus import pairwise_distances
from repro_torch.data.synthetic import Dataset
from repro_torch.simulation.cluster import SimCluster


@dataclass
class RoundRecord:
    """One round of ``History``: the host-side record both engines must
    reproduce bit-identically (times, taus, links) next to the device
    metrics (accuracy, loss, consensus) that match to float tolerance.
    ``staleness`` is AD-PSGD's per-round mean staleness; the synchronous
    engines record 0.0."""

    round: int
    round_time: float
    waiting_time: float
    accuracy: float
    loss: float
    mean_tau: float
    num_links: int
    consensus: float
    cumulative_time: float
    staleness: float = 0.0


@dataclass
class History:
    """Per-round trajectory of one run — the common result type of the
    engines. ``final_params`` is the last worker-stacked parameter dict
    ``{name: [W, ...]}`` (not a per-round field, so ``as_arrays``
    ignores it). ``screen_rejects`` is set only by screened AD-PSGD runs
    (``cfg.robust="screen:<z>"``): per round, the rejected pairwise
    payloads (up to two per event, each endpoint screens its own)."""

    records: list[RoundRecord] = field(default_factory=list)
    final_params: object = None
    screen_rejects: list[int] | None = None

    def completion_time(self, target_acc: float) -> float | None:
        """Paper metric: total time until the average model reaches
        `target_acc` (None if never)."""
        for r in self.records:
            if r.accuracy >= target_acc:
                return r.cumulative_time
        return None

    @property
    def final_accuracy(self) -> float:
        """Fleet-average test accuracy at the last recorded round."""
        return self.records[-1].accuracy if self.records else 0.0

    @property
    def avg_waiting(self) -> float:
        """Mean per-round waiting time (Eq. 11; the Fig. 7 metric)."""
        return float(np.mean([r.waiting_time for r in self.records])) \
            if self.records else 0.0

    def as_arrays(self) -> dict[str, np.ndarray]:
        """Column-major view of the records, one array per field."""
        keys = tuple(f.name for f in dataclasses.fields(RoundRecord))
        return {k: np.array([getattr(r, k) for r in self.records])
                for k in keys}


# ---------------------------------------------------------------------------
# device and scope of the port
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device a run executes on: ``None`` means the GPU, and raises
    when there is none — nothing falls back to the CPU on its own. On the
    GPU, f32 matrix products stay in full f32 (TF32 off, stated here
    rather than left to the library default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def check_ported(cfg: FedHPConfig, *, mesh=None, seeds=None) -> None:
    """Raise ``NotImplementedError`` for a feature the port does not run
    yet, naming the ROADMAP.md item (queue 1) that brings it — after the
    ``ValueError`` the reference raises for the Byzantine scenario axis
    on the sharded path, which does not compose with it."""
    sharded = cfg.sharded or mesh is not None
    if sharded and (cfg.byzantine or cfg.robust != "none"):
        raise ValueError(
            "the sharded path does not compose with cfg.byzantine / "
            "cfg.robust (data-dependent sorts are single-device-only)")
    todo = []
    if str(cfg.compress).startswith("leafmap:"):
        todo.append("compress='leafmap:...' (item 8, registry models)")
    if sharded:
        todo.append("sharded execution / mesh= (item 9)")
    if seeds is not None:
        todo.append("seeds= batching (item 4, the batched seeds axis)")
    if str(cfg.model).partition(":")[0] not in ("mlp", ""):
        todo.append(f"model={cfg.model!r} (item 8, registry models)")
    if todo:
        raise NotImplementedError(
            "not ported to repro_torch yet (ROADMAP.md queue 1): "
            + "; ".join(todo))


# ---------------------------------------------------------------------------
# fleet math on the flat [W, P] parameter matrix
# ---------------------------------------------------------------------------

def initial_params(adapter: modelspec.ModelAdapter, num_workers: int,
                   seed: int, init_params, device) -> torch.Tensor:
    """The run's starting [W, P] matrix: ``init_params`` (a worker-stacked
    dict ``{name: [W, ...]}``, e.g. from ``convert.params_from_jax``) or
    ``adapter.init`` from a generator seeded with ``seed``, broadcast to
    every worker."""
    if init_params is None:
        p0 = adapter.init(torch.Generator().manual_seed(seed))
        init_params = {k: v.expand(num_workers, *v.shape)
                       for k, v in p0.items()}
    flat = adapter.flatten({k: torch.as_tensor(v)
                            for k, v in init_params.items()})
    if flat.shape[0] != num_workers:
        raise ValueError(f"init_params hold {flat.shape[0]} workers, "
                         f"cfg.num_workers is {num_workers}")
    return flat.to(device)


def _loss_and_grad(adapter, flat, x, y):
    """Per-worker losses [W] and their gradients [W, P]: autograd on the
    SUM of the W independent per-worker losses gives each worker's own
    gradient exactly."""
    with torch.enable_grad():
        p = flat.detach().requires_grad_(True)
        losses = adapter.loss(adapter.views(p), x, y)
        (g,) = torch.autograd.grad(losses.sum(), p)
    return losses.detach(), g


def _local_train(adapter, flat, bx, by, taus, lr, tau_cap: int):
    """tau-masked local SGD (Eq. 3) for the fleet. flat: [W, P]; bx:
    [W, T, B, D]; by: [W, T, B] int64; taus: [W] on the device; lr: 0-d
    f32. Step k updates worker i only while k < tau_i — the mask
    multiplies the gradient, so masked steps run and are exact no-ops."""
    for k in range(tau_cap):
        mask = (taus > k).to(torch.float32)
        _, g = _loss_and_grad(adapter, flat, bx[:, k], by[:, k])
        flat = flat - (lr * mask)[:, None] * g
    return flat


def _gossip(flat, mix):
    """x_i <- sum_j mix_ij x_j (Eq. 5 in matrix form)."""
    return torch.matmul(mix, flat)


def round_edges(adj: np.ndarray, mixing: str):
    """The round's directed edge list in CSR form (``topology.
    edges_to_csr``) with the per-edge mixing weights, bit-identical to
    the dense matrix's off-diagonals: (row_ptr, col, w) as numpy."""
    e = topo.edges_from_adj(adj)
    src, dst, w = topo.directed_edges(
        e, topo.edge_mixing_weights(e, adj.shape[0], mixing))
    return topo.edges_to_csr(src, dst, w, adj.shape[0])


def _on(arrays, device):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _gossip_scenario(flat, adj, scen, byz, *, sparse: bool, mixing: str):
    """One round of gossip under the Byzantine scenario axis: byzantine
    rows (``byz``, [W] bool on the device) lie on the wire; the robust
    modes aggregate each closed neighbourhood coordinate-wise instead of
    the weighted mix — trimmed over edge lists by peeling
    (``robust.trimmed_mean_edges``), trimmed dense and median through the
    gathered table — and without one the attacked baseline mixes the
    lying wire, dense or over edges."""
    n = flat.shape[0]
    transmitted = (robust.apply_attack(flat, byz, scen.scale,
                                       kind=scen.attack)
                   if scen.has_byz else flat)
    if scen.mode == "trimmed" and sparse:
        e = topo.edges_from_adj(adj)
        src, dst, _ = topo.directed_edges(e, np.zeros(e.shape[0]))
        cnt = adj.sum(1) + 1
        # the peeling depth, in f64 on the host as the reference has it
        bi = np.minimum(np.floor(scen.knob * cnt) if scen.knob < 1
                        else np.full(n, scen.knob), (cnt - 1) // 2)
        return robust.trimmed_mean_edges(flat, transmitted, src, dst,
                                         b=scen.knob, num_workers=n,
                                         b_max=max(int(bi.max()), 0))
    if scen.mode in ("trimmed", "median"):
        nbr, deg = _on(robust.neighbor_table(adj), flat.device)
        return robust.robust_gossip_dense(flat, transmitted, nbr, deg,
                                          b=scen.knob, mode=scen.mode)
    if sparse:
        return robust.gossip_byz_edges(flat, transmitted,
                                       _on(round_edges(adj, mixing),
                                           flat.device))
    mix = torch.as_tensor(mixing_fn(mixing)(adj), dtype=torch.float32,
                          device=flat.device)
    return robust.gossip_byz_dense(flat, transmitted, mix)


def _blend_joined(flat, keep, w):
    """Rows in ``keep`` adopt the w-weighted average of the fleet; an
    all-False keep leaves the matrix untouched exactly. Shared with the
    fused engine, which precomputes keep/w host-side."""
    return torch.where(keep[:, None], (w @ flat)[None, :], flat)


def _reinit_joined(flat, joined, donors):
    """Joining workers adopt the average of the incumbent alive models
    (a fresh worker starting from x^0 mid-run would wreck consensus)."""
    w = donors.to(torch.float32)
    w = w / torch.clamp(w.sum(), min=1.0)
    return _blend_joined(flat, joined, w)


def _shared(x, num_workers: int):
    """One batch every worker sees: [*batch, ...] -> [W, *batch, ...]
    (a stride-0 view)."""
    return x.expand(num_workers, *x.shape)


def _measure(adapter, flat, prev, ex, ey, px, py):
    """Per-worker Alg. 1 measurements -> (loss, L_i, sigma_i, update norm),
    each [W]. NOTE every worker is evaluated on the FULL [W, 256] eval
    stack (and [W, 32] probe), not on its own rows — the reference's
    semantics, which FedHP's decisions were tuned against."""
    n = flat.shape[0]
    ex, ey, px, py = (_shared(t, n) for t in (ex, ey, px, py))
    loss_p, g_p = _loss_and_grad(adapter, flat, ex, ey)
    _, g_q = _loss_and_grad(adapter, prev, ex, ey)
    _, g_s = _loss_and_grad(adapter, flat, px, py)
    num = torch.sqrt(torch.sum(torch.square(g_p - g_q), dim=1))
    den = torch.sqrt(torch.sum(torch.square(flat - prev), dim=1))
    smooth_l = num / torch.clamp(den, min=1e-8)
    sigma = torch.sqrt(torch.sum(torch.square(g_s - g_p), dim=1))
    return loss_p, smooth_l, sigma, den


def _cross_loss_matrix(adapter, flat, xs, ys):
    """[N, N] loss of worker j's model on worker i's local sample batch
    (xs [N, S, D], ys [N, S]) -> [data_i, model_j]."""
    n, g = flat.shape[0], xs.shape[0]
    rep = flat.repeat_interleave(g, dim=0)          # row j*g + i: model j
    losses = adapter.loss(adapter.views(rep), xs.repeat(n, 1, 1),
                          ys.repeat(n, 1))
    return losses.view(n, g).T


def _fleet_metrics(adapter, flat, tx, ty):
    """Per-worker test accuracy and loss, [W] each."""
    views = adapter.views(flat)
    n = flat.shape[0]
    x, y = _shared(tx, n), _shared(ty, n)
    return adapter.accuracy(views, x, y), adapter.loss(views, x, y)


def _mean_accuracy(adapter, flat, tx, ty,
                   alive: np.ndarray | None = None) -> tuple[float, float]:
    """Fleet-average test accuracy/loss over the alive workers (departed
    workers' frozen models are not part of the deployment)."""
    accs, losses = _fleet_metrics(adapter, flat, tx, ty)
    if alive is not None and not alive.all() and alive.any():
        w = torch.as_tensor(alive, dtype=torch.float32, device=flat.device)
        w = w / w.sum()
        return float(torch.dot(w, accs)), float(torch.dot(w, losses))
    return float(accs.mean()), float(losses.mean())


def eval_batches(rng, data: Dataset, shards, device):
    """The fixed per-worker eval (256) and probe (32) batches of the
    Alg. 1 estimates, drawn from ``rng`` before round 0 exactly like the
    reference (features and labels come from two separate draws)."""
    ex = np.stack([data.x[s[rng.integers(0, len(s), 256)]] for s in shards])
    ey = np.stack([data.y[s[rng.integers(0, len(s), 256)]] for s in shards])
    ex = torch.as_tensor(ex, device=device)
    ey = torch.as_tensor(ey, device=device).long()
    return ex, ey, ex[:, :32], ey[:, :32]


def holdout_set(test_x, test_y, eval_subset: int, device):
    """The fleet-accuracy test split on ``device`` (labels int64)."""
    tx = torch.as_tensor(test_x[:eval_subset], device=device)
    ty = torch.as_tensor(test_y[:eval_subset], device=device).long()
    return tx, ty


# ---------------------------------------------------------------------------
# Synchronous engine
# ---------------------------------------------------------------------------

def _draw_batches(rng, data: Dataset, shards, taus_cap: int, batch: int):
    """[W, tau_max, B, *feat] index draws from each worker's shard."""
    n = len(shards)
    bx = np.zeros((n, taus_cap, batch) + data.x.shape[1:], data.x.dtype)
    by = np.zeros((n, taus_cap, batch), np.int32)
    for w, shard in enumerate(shards):
        ix = rng.integers(0, len(shard), (taus_cap, batch))
        sel = shard[ix]
        bx[w] = data.x[sel]
        by[w] = data.y[sel]
    return bx, by


def mixing_fn(mixing: str):
    """The Eq. 6 mixing-matrix builder a ``mixing`` name selects."""
    if mixing == "uniform":
        return topo.mixing_matrix_uniform
    if mixing == "metropolis":
        return topo.mixing_matrix_metropolis
    raise ValueError(f"unknown mixing {mixing!r}")


def round_topology(plan, alive: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """The plan's adjacency with departed workers cut out; if the
    strategy intended communication (plan.adj has links) but departures
    disconnected the survivors, cheapest-reconnect them (link-time
    cost). LD-SGD's all-zero local-only plans legitimately skip."""
    adj = plan.adj.copy()
    adj[~alive, :] = 0
    adj[:, ~alive] = 0
    if not alive.all() and alive.sum() > 1 and plan.adj.sum() > 0:
        adj = topo.repair_connectivity(adj, alive, cost=beta)
    return adj


def round_clock(adj, taus, mu, beta, plan, alive, crashed: bool,
                crash_timeout: float,
                wire_ratio: float = 1.0) -> tuple[float, float]:
    """Eq. 10-11: the round time max_i t_i (plus the failure-detection
    timeout after a crash) and the mean waiting time of the alive. A
    compressed link's comm time is beta / the codec's ``wire_ratio``."""
    comm = np.where(adj.sum(1) > 0,
                    np.where(adj > 0, beta, 0.0).max(1), 0.0)
    t_i = taus * mu + comm / wire_ratio
    if plan.extra_time is not None:
        t_i = t_i + plan.extra_time * alive
    t_round = float(t_i[alive].max()) if alive.any() else 0.0
    if crashed:
        t_round += crash_timeout
    waiting = float((t_round - t_i[alive]).mean()) if alive.any() else 0.0
    return t_round, waiting


def randk_gate(codec, skey, step: int, p_model: int, device):
    """The rand-k mask draw of ``step`` as a [P] tensor on ``device``
    (None for the other codecs)."""
    if codec.kind != "randk":
        return None
    return torch.from_numpy(
        compression.randk_scores(skey, step, p_model)).to(device)


def run_dfl(data: Dataset, test_x, test_y, shards, cluster: SimCluster,
            cfg: FedHPConfig, strategy: Strategy, *, rounds: int | None = None,
            hidden: int = 64, eval_subset: int = 512,
            mixing: str = "uniform",
            time_budget: float | None = None,
            adapter: modelspec.ModelAdapter | None = None,
            init_params=None, mesh=None, device=None) -> History:
    """time_budget: stop once the simulated clock passes it — the paper's
    equal-wall-time comparison (completion time is the metric, Fig. 3).

    ``init_params`` starts from a worker-stacked dict ``{name: [W, ...]}``
    (e.g. the reference's init through ``convert.params_from_jax``)
    instead of broadcasting ``adapter.init``. ``device``: ``None`` means
    the GPU (raises without one); ``"cpu"`` runs on the CPU."""
    device = resolve_device(device)
    check_ported(cfg, mesh=mesh)
    scen = robust.scenario(cfg, asynchronous=False)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    rng = np.random.default_rng(cfg.seed)
    if adapter is None:
        adapter = modelspec.adapter_for(cfg, data, hidden=hidden)
    flat = initial_params(adapter, n, cfg.seed, init_params, device)
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)
    ex, ey, px, py = eval_batches(rng, data, shards, device)
    mixfn = mixing_fn(mixing)
    needs_cross = strategy.name == "pens"
    # time-varying non-IID drift: a DriftingPartition swaps shard lists
    # on its schedule; static lists pass through untouched
    drifting = hasattr(shards, "shards_at")
    # wire codec: its [W, P] state (int8 residual / top-k public copy) and
    # the rand-k mask stream; the strategy may tighten a sparse codec's k
    # per round through plan.codec
    codec0 = compression.parse_mode(cfg.compress)
    compress = codec0.kind != "none"
    p_model = adapter.param_count
    skey = compression.sparsify_base_key(cfg.seed)
    err = compression.state_init(flat, codec0.kind, cfg.error_feedback)
    sparse = cfg.gossip == "sparse"
    byz = torch.as_tensor(scen.byz, device=device)

    hist = History()
    clock = 0.0
    for h in range(rounds):
        alive = cluster.advance_round(h)
        joined = cluster.last_joined
        if joined.any():
            donors = alive & ~joined
            if donors.any():
                keep = torch.as_tensor(joined, device=device)
                flat = _reinit_joined(flat, keep,
                                      torch.as_tensor(donors, device=device))
                if err is not None:
                    err = compression.state_after_join(
                        err, keep[:, None], flat, codec0.kind,
                        cfg.error_feedback)
        mu = cluster.sample_mu()
        beta = cluster.sample_beta()

        plan = strategy.plan(h, alive=alive)
        rcodec = plan.codec if plan.codec is not None else codec0
        comm_ratio = rcodec.wire_ratio(p_model) if compress else 1.0
        adj = round_topology(plan, alive, beta)
        taus = np.where(alive, np.clip(plan.taus, 1, cfg.tau_max), 0)
        lr = cfg.lr * (cfg.lr_decay ** h)

        # --- local updating (Eq. 3), masked to tau_i ---
        tau_cap = int(max(taus.max(), 1))
        bx, by = _draw_batches(rng, data,
                               shards.shards_at(h) if drifting else shards,
                               tau_cap, cfg.batch_size)
        prev = flat
        flat = _local_train(
            adapter, flat, torch.as_tensor(bx, device=device),
            torch.as_tensor(by, device=device).long(),
            torch.as_tensor(taus, device=device),
            torch.tensor(lr, dtype=torch.float32, device=device), tau_cap)

        # --- clock (Eq. 10-11) ---
        t_round, waiting = round_clock(adj, taus, mu, beta, plan, alive,
                                       cluster.last_crashed.any(),
                                       cfg.crash_timeout, comm_ratio)
        clock += t_round

        # --- gossip aggregation (Eq. 5-6): the Byzantine scenario axis,
        # or dense / over the round's edge list, optionally compressed ---
        if adj.sum() > 0 and scen.active:
            flat = _gossip_scenario(flat, adj, scen, byz, sparse=sparse,
                                    mixing=mixing)
        elif adj.sum() > 0 and sparse:
            csr = _on(round_edges(adj, mixing), device)
            if compress:
                flat, err = compression.compressed_gossip_ref(
                    flat, err, None, error_feedback=cfg.error_feedback,
                    kind=rcodec.kind, k=rcodec.resolve_k(p_model),
                    scores=randk_gate(rcodec, skey, h, p_model, device),
                    gamma=cfg.sparse_gamma, edges=csr)
            else:
                flat = flat + compression.edge_mix_delta(flat, csr)
        elif adj.sum() > 0:
            mix = torch.as_tensor(mixfn(adj), dtype=torch.float32,
                                  device=device)
            if compress:
                flat, err = compression.compressed_gossip_ref(
                    flat, err, mix, error_feedback=cfg.error_feedback,
                    kind=rcodec.kind, k=rcodec.resolve_k(p_model),
                    scores=randk_gate(rcodec, skey, h, p_model, device),
                    gamma=cfg.sparse_gamma)
            else:
                flat = _gossip(flat, mix)

        # --- measurements (Alg. 1 lines 4-5, 9-10), over the honest
        # alive workers (byzantine rows are adversaries, not clients) ---
        meas = scen.honest(alive)
        losses, ls, sigs, upds = (
            v.cpu().numpy() for v in _measure(adapter, flat, prev, ex, ey,
                                              px, py))
        flat_np = flat.cpu().numpy()
        cross = None
        if needs_cross:
            cross = _cross_loss_matrix(adapter, flat, ex[:, :64],
                                       ey[:, :64]).cpu().numpy()
        strategy.observe(
            h, adj=adj, mu=mu, beta=beta,
            edge_dist=pairwise_distances(flat_np),
            update_norms=upds[meas] if meas.any() else [0.0],
            smooth_l=float(np.median(ls[meas])),
            sigma=float(np.median(sigs[meas])),
            loss=float(np.mean(losses[meas])),
            cross_loss=cross, alive=alive, wire_ratio=comm_ratio)

        mean_acc, mean_loss = _mean_accuracy(adapter, flat, tx, ty, meas)
        fa = flat_np[meas] if meas.any() else flat_np
        d_bar = float(np.linalg.norm(fa - fa.mean(0), axis=1).mean())
        hist.records.append(RoundRecord(
            round=h, round_time=t_round, waiting_time=waiting,
            accuracy=mean_acc, loss=mean_loss,
            mean_tau=float(taus[alive].mean()) if alive.any() else 0.0,
            num_links=int(adj.sum() // 2), consensus=d_bar,
            cumulative_time=clock))
        if time_budget is not None and clock >= time_budget:
            break
    hist.final_params = adapter.unflatten(flat)
    return hist


# ---------------------------------------------------------------------------
# Asynchronous engine (AD-PSGD baseline): event schedule + event loop
# ---------------------------------------------------------------------------

# partner selection / event ordering draws come from a stream derived from
# (seed, _ADPSGD_STREAM), independent of the batch-sampling stream
_ADPSGD_STREAM = 0xAD


@dataclass(frozen=True)
class AdpsgdEvent:
    """One processed AD-PSGD completion event (AD-PSGD [23], Alg. 1).

    ``worker`` finished tau local steps computed from its snapshot and
    atomically pairwise-averages with ``partner`` at simulated ``time``.
    ``staleness`` counts how many pairwise averages hit the worker's live
    row since its snapshot was taken; ``inflight_bound`` is the number of
    other workers' events processed in that window (staleness never
    exceeds it)."""

    worker: int
    partner: int
    time: float
    staleness: int
    inflight_bound: int


@dataclass(frozen=True)
class AdpsgdRound:
    """N consecutive events plus the host state their record needs.

    ``keep``/``donor_w`` describe the join re-initialization applied
    BEFORE this round's events (all-False/zero when nobody joined);
    ``alive`` is the membership in force DURING the events; ``clock`` is
    the simulated time of the round's last event (the record's
    ``cumulative_time``); ``lr`` the decayed learning rate in force."""

    events: tuple[AdpsgdEvent, ...]
    lr: float
    alive: np.ndarray
    clock: float
    keep: np.ndarray
    donor_w: np.ndarray

    @property
    def mean_staleness(self) -> float:
        """Mean staleness over the round's events (the record field)."""
        return float(np.mean([e.staleness for e in self.events]))


@dataclass(frozen=True)
class AdpsgdSchedule:
    """The complete host-side control plane of one AD-PSGD run: what the
    event loop does, minus the device math. Both engines consume it, which
    makes their host-side records bit-identical."""

    rounds: tuple[AdpsgdRound, ...]
    tau: int
    num_links: int
    num_workers: int

    @property
    def events(self) -> list[AdpsgdEvent]:
        """All processed events, flattened in completion order."""
        return [e for r in self.rounds for e in r.events]


def adpsgd_schedule(cluster: SimCluster, cfg: FedHPConfig, *,
                    rounds: int | None = None,
                    time_budget: float | None = None,
                    p_model: int | None = None) -> AdpsgdSchedule:
    """Precompute the AD-PSGD event schedule (pure host function, a copy
    of ``repro.core.engine.adpsgd_schedule``).

    A heap of per-worker finish times ``t + tau mu_i + beta_ij`` (Eq. 10
    per event; compressed runs charge ``beta / wire_ratio``),
    random-neighbor partner selection over the alive ring, churn applied
    at round boundaries (every N processed events), and per-worker
    staleness counters. Events of departed workers are dropped; joiners
    are re-admitted with a fresh event. Consumes the cluster's RNG once
    per event (mu, beta draws) plus once per join. ``p_model`` is the
    model's true parameter count for the codec's wire ratio (default:
    ``cluster.model_bits / 32``)."""
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    rng = np.random.default_rng((cfg.seed, _ADPSGD_STREAM))
    ring = topo.ring_topology(n)
    neighbors = [np.nonzero(ring[i])[0] for i in range(n)]
    tau = cfg.tau_init
    codec = compression.parse_mode(cfg.compress)
    robust.scenario(cfg, asynchronous=True)      # the reference's rejects
    comm_ratio = codec.wire_ratio(
        p_model if p_model is not None
        else int(cluster.model_bits // compression.FP32_BITS))

    mu0 = cluster.sample_mu()
    q = [(tau * mu0[i], i) for i in range(n)]
    heapq.heapify(q)
    alive = cluster.advance_round(0)
    lr = cfg.lr
    stale = np.zeros(n, np.int64)     # averages absorbed since snapshot
    last_ev = np.full(n, -1)          # processed-event index of last event
    out: list[AdpsgdRound] = []
    cur: list[AdpsgdEvent] = []
    keep = np.zeros(n, bool)
    donor_w = np.zeros(n)
    events = 0
    clock = 0.0
    while len(out) < rounds and q:
        t_now, i = heapq.heappop(q)
        clock = t_now
        if not alive[i]:
            continue                  # churned out: event dies with it
        cand = [j for j in neighbors[i] if alive[j]]
        if not cand:                  # ring neighbors churned out: any peer
            cand = [j for j in np.nonzero(alive)[0] if j != i]
        j = int(rng.choice(cand)) if cand else int(i)
        bound = int(events - last_ev[i] - 1) if last_ev[i] >= 0 else events
        cur.append(AdpsgdEvent(int(i), j, float(clock), int(stale[i]),
                               bound))
        stale[i] = 0
        if j != i:
            stale[j] += 1             # j's in-flight delta is now staler
        last_ev[i] = events
        mu = cluster.sample_mu()[i]
        beta = cluster.sample_beta()[i, j] / comm_ratio
        heapq.heappush(q, (t_now + tau * mu + beta, i))
        events += 1
        if events % n == 0:
            out.append(AdpsgdRound(tuple(cur), lr, alive.copy(),
                                   float(clock), keep, donor_w))
            lr *= cfg.lr_decay
            cur = []
            keep = np.zeros(n, bool)
            donor_w = np.zeros(n)
            if time_budget is not None and clock >= time_budget:
                break
            # churn for the NEXT round advances after this round's record,
            # matching run_dfl's round-start semantics
            alive = cluster.advance_round(len(out))
            joined = cluster.last_joined
            donors = alive & ~joined
            if joined.any() and donors.any():
                keep = joined.copy()
                donor_w = donors / donors.sum()
                # re-init == fresh snapshot: counters reset AND the
                # in-flight window restarts at the join boundary
                stale[joined] = 0
                last_ev[joined] = events - 1
                mu_now = cluster.sample_mu()
                for w in np.nonzero(joined)[0]:
                    heapq.heappush(q, (clock + tau * mu_now[w], int(w)))
    return AdpsgdSchedule(tuple(out), tau, int(ring.sum() // 2), n)


def _adpsgd_delta(adapter, snap, bx, by, lr, tau: int) -> torch.Tensor:
    """tau local SGD steps (Eq. 3) of one worker from its SNAPSHOT row
    ``snap`` [P]; returns the delta [P]. AD-PSGD's defining staleness: the
    delta is applied to whatever the live row has become meanwhile."""
    row = snap[None]
    out = _local_train(adapter, row, bx[None], by[None],
                       torch.full((1,), tau, device=row.device), lr, tau)
    return (out - row)[0]


def _pair_average(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """The reference's atomic pairwise average ½ (x_i + x_j) (Eq. 5 on
    one edge with the mix [[.5, .5], [.5, .5]])."""
    return 0.5 * (xi + xj)


def adpsgd_join(flat, snaps, err, histn, keep, donor_w, kind: str,
                ef: bool):
    """The join re-initialisation before a round's events: rows in
    ``keep`` ([W] bool) adopt the ``donor_w``-weighted average of the
    fleet, a fresh snapshot, a reset codec state and a fresh screening
    history -> (flat, snaps, err, histn)."""
    flat = _blend_joined(flat, keep, donor_w)
    snaps = torch.where(keep[:, None], flat, snaps)
    if err is not None:
        err = compression.state_after_join(err, keep[:, None], flat, kind,
                                           ef)
    histn = torch.where(keep, torch.zeros((), device=histn.device), histn)
    return flat, snaps, err, histn


def adpsgd_event_lying(adapter, flat, snaps, histn, ev: AdpsgdEvent, bx, by,
                       lr, tau: int, pair_mix, scen):
    """One AD-PSGD event over a lying wire, in place on ``flat``,
    ``snaps`` and the screening history ``histn`` [W]: byzantine
    endpoints transmit a corrupted copy of their row (no wire on a
    self-event), each endpoint mixes its row with the payload it
    receives — ``pair_mix(a, b)`` [2, P] takes row r to the average of
    a[r] and b[r] — and under ``screen:<z>`` worker i first folds its
    fresh delta norm into its history, then each endpoint keeps its own
    row if the payload fails its z-test. Returns the event's rejections
    (a 0-d tensor on the device; None when nothing is screened)."""
    i, j = ev.worker, ev.partner
    delta = _adpsgd_delta(adapter, snaps[i], bx, by, lr, tau)
    xi, xj = flat[i] + delta, flat[j].clone()
    wire = i != j
    ti = robust.attack_row(xi, wire and scen.byz[i], scen.scale,
                           kind=scen.attack)
    tj = robust.attack_row(xj, wire and scen.byz[j], scen.scale,
                           kind=scen.attack)
    row_i, row_j = pair_mix(torch.stack([xi, ti]), torch.stack([tj, xj]))
    rejects = None
    if scen.mode == "screen":
        h_i = robust.screen_fold(histn[i], torch.linalg.vector_norm(delta))
        histn[i] = h_i
        if wire:
            acc_i = robust.screen_accept(xi, tj, h_i, scen.knob)
            acc_j = robust.screen_accept(xj, ti, histn[j], scen.knob)
            row_i = torch.where(acc_i, row_i, xi)
            row_j = torch.where(acc_j, row_j, xj)
            rejects = (~acc_i).to(torch.int32) + (~acc_j).to(torch.int32)
    flat[i], flat[j] = row_i, row_j
    snaps[i] = flat[i]
    return rejects


def adpsgd_event(adapter, flat, snaps, err, ev: AdpsgdEvent, bx, by, lr,
                 tau: int, average, *, codec, k: int, ef: bool,
                 gamma: float, scores=None) -> None:
    """One AD-PSGD event, in place on the live rows ``flat``, the
    snapshots ``snaps`` and the codec state ``err`` (all [W, P]): worker
    i's tau-step delta from its snapshot lands on its live row, then i
    and its partner j exchange — ``average(x_i, x_j)`` uncompressed, the
    codec's compensated pairwise update (``scores``: the event's rand-k
    draw) otherwise — and i takes a fresh snapshot. A self-event
    (i == j) writes j's row last, as the reference does."""
    i, j = ev.worker, ev.partner
    delta = _adpsgd_delta(adapter, snaps[i], bx, by, lr, tau)
    xi, xj = flat[i] + delta, flat[j].clone()
    if codec.kind == "none":
        xi = xj = average(xi, xj)
    else:
        xi, xj, ei, ej = compression.compressed_pair_ref(
            xi, xj, None if err is None else err[i],
            None if err is None else err[j], error_feedback=ef,
            kind=codec.kind, k=k, gamma=gamma, scores=scores)
        if err is not None:
            err[i], err[j] = ei, ej
    flat[i], flat[j] = xi, xj
    snaps[i] = flat[i]


def adpsgd_setup(cfg: FedHPConfig, cluster: SimCluster, adapter, *, rounds,
                 time_budget, schedule):
    """The shared preamble of both AD-PSGD engines -> (codec, scenario,
    schedule): the parsed ``cfg.compress``, the Byzantine scenario axis
    and the event schedule (generated unless an explicit ``schedule``
    replays one verbatim)."""
    scen = robust.scenario(cfg, asynchronous=True)
    codec = compression.parse_mode(cfg.compress)
    if schedule is None:
        return codec, scen, adpsgd_schedule(cluster, cfg, rounds=rounds,
                                            time_budget=time_budget,
                                            p_model=adapter.param_count)
    if time_budget is not None:
        raise ValueError(
            "time_budget only applies while GENERATING a schedule; an "
            "explicit schedule= replays verbatim (apply the budget in "
            "adpsgd_schedule instead)")
    return codec, scen, schedule


def round_batches(rng, data: Dataset, shards, rnd_idx: int,
                  rnd: AdpsgdRound, tau: int, batch: int):
    """The batches of one AD-PSGD round's events, in event order, drawn
    from each event worker's shard: ([N, tau, B, *feat], [N, tau, B])."""
    round_shards = (shards.shards_at(rnd_idx) if hasattr(shards, "shards_at")
                    else shards)
    bx = np.zeros((len(rnd.events), tau, batch) + data.x.shape[1:],
                  data.x.dtype)
    by = np.zeros((len(rnd.events), tau, batch), np.int32)
    for k, e in enumerate(rnd.events):
        shard = round_shards[e.worker]
        ix = rng.integers(0, len(shard), (tau, batch))
        bx[k] = data.x[shard[ix]]
        by[k] = data.y[shard[ix]]
    return bx, by


def run_adpsgd(data: Dataset, test_x, test_y, shards, cluster: SimCluster,
               cfg: FedHPConfig, *, rounds: int | None = None,
               hidden: int = 64, eval_subset: int = 512,
               time_budget: float | None = None,
               schedule: AdpsgdSchedule | None = None,
               adapter: modelspec.ModelAdapter | None = None,
               init_params=None, device=None) -> History:
    """Event-driven AD-PSGD [23]: random pairwise averaging on completion.

    One "round" = N worker-finish events, at which point metrics are
    sampled (comparable x-axes with ``run_dfl``). The control plane comes
    from ``adpsgd_schedule`` (an explicit ``schedule`` replays a custom
    event sequence verbatim); this loop runs the device math event by
    event, with a host sync per round for the metrics — the ground truth
    ``fused.run_adpsgd_fused`` is held against. ``cfg.compress`` ("int8"
    / "topk:<k>" / "randk:<k>") switches the pairwise exchange to the
    codec's compensated update (``compression.compressed_pair_ref``).
    ``cfg.byzantine`` workers lie on the pairwise wire and
    ``cfg.robust="screen:<z>"`` screens each incoming payload
    (``adpsgd_event_lying``), with the rejections per round in
    ``History.screen_rejects``; the metrics cover the honest workers.

    ``init_params`` and ``device`` as in ``run_dfl``. The live rows, the
    snapshots and the codec state are [W, P] tensors updated in place,
    row by row (the reference scatters into fresh arrays)."""
    device = resolve_device(device)
    check_ported(cfg)
    rounds = rounds or cfg.rounds
    n = cfg.num_workers
    if adapter is None:
        adapter = modelspec.adapter_for(cfg, data, hidden=hidden)
    codec, scen, schedule = adpsgd_setup(cfg, cluster, adapter,
                                         rounds=rounds,
                                         time_budget=time_budget,
                                         schedule=schedule)
    rng = np.random.default_rng(cfg.seed)       # batch-sampling stream
    flat = initial_params(adapter, n, cfg.seed, init_params, device)
    tx, ty = holdout_set(test_x, test_y, eval_subset, device)
    tau = schedule.tau
    p_model = adapter.param_count
    err = compression.state_init(flat, codec.kind, cfg.error_feedback)
    k_abs = codec.resolve_k(p_model)
    skey = compression.sparsify_base_key(cfg.seed)
    ev_idx = 0          # global event counter: the rand-k mask step
    snaps = flat.clone()    # per-worker snapshot its computation started at
    histn = torch.zeros(n, device=device)       # own-delta-norm EMA

    hist = History()
    if scen.mode == "screen":
        hist.screen_rejects = []
    for rnd_idx, rnd in enumerate(schedule.rounds):
        if rnd.keep.any():
            flat, snaps, err, histn = adpsgd_join(
                flat, snaps, err, histn,
                torch.as_tensor(rnd.keep, device=device),
                torch.as_tensor(rnd.donor_w, dtype=torch.float32,
                                device=device),
                codec.kind, cfg.error_feedback)
        bx, by = round_batches(rng, data, shards, rnd_idx, rnd, tau,
                               cfg.batch_size)
        bx = torch.as_tensor(bx, device=device)
        by = torch.as_tensor(by, device=device).long()
        lr = torch.tensor(rnd.lr, dtype=torch.float32, device=device)
        rejects = 0
        for e_k, ev in enumerate(rnd.events):
            if scen.active:
                r = adpsgd_event_lying(adapter, flat, snaps, histn, ev,
                                       bx[e_k], by[e_k], lr, tau,
                                       _pair_average, scen)
                rejects = rejects if r is None else rejects + r
            else:
                adpsgd_event(adapter, flat, snaps, err, ev, bx[e_k],
                             by[e_k], lr, tau, _pair_average, codec=codec,
                             k=k_abs, ef=cfg.error_feedback,
                             gamma=cfg.sparse_gamma,
                             scores=randk_gate(codec, skey, ev_idx, p_model,
                                               device))
            ev_idx += 1
        meas = scen.honest(rnd.alive)
        mean_acc, mean_loss = _mean_accuracy(adapter, flat, tx, ty, meas)
        flat_np = flat.cpu().numpy()
        fa = flat_np[meas] if meas.any() else flat_np
        d_bar = float(np.linalg.norm(fa - fa.mean(0), axis=1).mean())
        hist.records.append(RoundRecord(
            round=len(hist.records), round_time=0.0,
            waiting_time=0.0,          # async: no synchronization barrier
            accuracy=mean_acc, loss=mean_loss, mean_tau=float(tau),
            num_links=schedule.num_links, consensus=d_bar,
            cumulative_time=rnd.clock, staleness=rnd.mean_staleness))
        if hist.screen_rejects is not None:
            hist.screen_rejects.append(int(rejects))
    hist.final_params = adapter.unflatten(flat)
    return hist
