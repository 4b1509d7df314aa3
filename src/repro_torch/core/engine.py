"""The synchronous reference round engine (``run_dfl``) — the port of
``repro.core.engine``'s dense, uncompressed path.

Per round the strategy plans (A^h, tau^h); the workers run tau_i local
SGD steps (the whole fleet at once, masked to tau_i — masked steps still
run and change nothing); the simulated clock charges
t_i = tau_i mu_i + max_j beta_ij (Eq. 10); gossip mixes with the uniform
matrix (Eq. 5-6) as ``x <- mix @ x``; measurements (consensus distances,
update norms, the L/sigma estimates of Alg. 1 lines 4-5) feed back to the
strategy. One Python iteration per round, with host syncs for the
measurements: the semantic ground truth ``fused.run_dfl_fused`` is held
against.

Parameters live as ONE flat ``[W, P]`` f32 tensor in the reference's leaf
layout (``modelspec``); the model sees leaf views of it. Every entry
point takes ``device``: ``None`` means the GPU and raises without one;
only an explicit ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import FedHPConfig
from repro_torch.core import modelspec
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
    ignores it)."""

    records: list[RoundRecord] = field(default_factory=list)
    final_params: object = None

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
    yet, naming the ROADMAP.md item (queue 1) that brings it."""
    todo = []
    if cfg.compress != "none":
        todo.append(f"compress={cfg.compress!r} (item 5, wire codecs)")
    if cfg.gossip == "sparse":
        todo.append("gossip='sparse' (item 6, sparse edge-list gossip)")
    if cfg.sharded or mesh is not None:
        todo.append("sharded execution / mesh= (item 9)")
    if cfg.byzantine or cfg.robust != "none":
        todo.append("byzantine / robust gossip (item 7, scenario axis)")
    if seeds is not None:
        todo.append("seeds= batching (item 4, the batched seeds axis)")
    if str(cfg.model).partition(":")[0] not in ("mlp", ""):
        todo.append(f"model={cfg.model!r} (item 8, registry models)")
    if cfg.algorithm == "adpsgd":
        todo.append("algorithm='adpsgd' (item 3, AD-PSGD)")
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
                crash_timeout: float) -> tuple[float, float]:
    """Eq. 10-11: the round time max_i t_i (plus the failure-detection
    timeout after a crash) and the mean waiting time of the alive."""
    comm = np.where(adj.sum(1) > 0,
                    np.where(adj > 0, beta, 0.0).max(1), 0.0)
    t_i = taus * mu + comm
    if plan.extra_time is not None:
        t_i = t_i + plan.extra_time * alive
    t_round = float(t_i[alive].max()) if alive.any() else 0.0
    if crashed:
        t_round += crash_timeout
    waiting = float((t_round - t_i[alive]).mean()) if alive.any() else 0.0
    return t_round, waiting


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

    hist = History()
    clock = 0.0
    for h in range(rounds):
        alive = cluster.advance_round(h)
        joined = cluster.last_joined
        if joined.any():
            donors = alive & ~joined
            if donors.any():
                flat = _reinit_joined(flat,
                                      torch.as_tensor(joined, device=device),
                                      torch.as_tensor(donors, device=device))
        mu = cluster.sample_mu()
        beta = cluster.sample_beta()

        plan = strategy.plan(h, alive=alive)
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
                                       cfg.crash_timeout)
        clock += t_round

        # --- gossip aggregation (Eq. 5-6) ---
        if adj.sum() > 0:
            mix = torch.as_tensor(mixfn(adj), dtype=torch.float32,
                                  device=device)
            flat = _gossip(flat, mix)

        # --- measurements (Alg. 1 lines 4-5, 9-10) ---
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
            update_norms=upds[alive] if alive.any() else [0.0],
            smooth_l=float(np.median(ls[alive])),
            sigma=float(np.median(sigs[alive])),
            loss=float(np.mean(losses[alive])),
            cross_loss=cross, alive=alive, wire_ratio=1.0)

        mean_acc, mean_loss = _mean_accuracy(adapter, flat, tx, ty, alive)
        fa = flat_np[alive] if alive.any() else flat_np
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
