"""Shared helpers of the PyTorch port's differential tests: the same seeds,
configs and JAX-initialised weights through the reference JAX package
(``repro``) and the port (``repro_torch``), everything on the CPU.

Inputs cross between the two packages as numpy arrays only.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import shutil
import tempfile
from dataclasses import replace

import jax
import numpy as np
import torch
from jax.experimental.compilation_cache import compilation_cache

from repro.configs.base import FedHPConfig as JaxConfig
from repro.core import engine as jax_engine
from repro.core import experiment as jax_experiment
from repro.core import modelspec as jax_modelspec
from repro.core.algorithms import make_strategy as jax_make_strategy
from repro.core.topology import make_base_topology as jax_base_topology
from repro.simulation.cluster import ChurnEvent as JaxChurnEvent
from repro.simulation.cluster import ChurnSchedule as JaxChurnSchedule
from repro_torch.configs.base import FedHPConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import engine, experiment, fused
from repro_torch.core.algorithms import RoundPlan, make_strategy
from repro_torch.core.topology import make_base_topology
from repro_torch.simulation.cluster import ChurnEvent, ChurnSchedule

# the driver runs one test file per xdist worker: keep each on one core
torch.set_num_threads(1)

# W = 8 workers; spread 3.0 keeps the MLP from saturating at accuracy 1.0
# within a few rounds (at the default spread the comparison would be
# between two constant trajectories)
CFG_KW = dict(num_workers=8, rounds=8, tau_init=5, tau_max=20, lr=0.1,
              batch_size=32, seed=3)
DATA_KW = dict(non_iid_p=0.4, spread=3.0)
ROUNDS = 8

# joins, a graceful leave, a crash and a straggler spike inside the run
# (the reference's tests/test_fused_equivalence.py schedule)
CHURN_EVENTS = ((2, "leave", 1, {}), (3, "crash", 6, {}),
                (4, "straggle", 2, dict(factor=5.0, duration=3)),
                (6, "join", 1, {}))


def jax_churn(churn):
    """``churn``: True for ``CHURN_EVENTS``, or a tuple of events."""
    events = CHURN_EVENTS if churn is True else churn
    return JaxChurnSchedule(tuple(JaxChurnEvent(r, k, w, **kw)
                                  for r, k, w, kw in events)) \
        if events else None


def torch_churn(churn):
    """``churn``: True for ``CHURN_EVENTS``, or a tuple of events."""
    events = CHURN_EVENTS if churn is True else churn
    return ChurnSchedule(tuple(ChurnEvent(r, k, w, **kw)
                               for r, k, w, kw in events)) \
        if events else None


def jax_init(seed: int, num_workers: int, dim: int = 32, hidden: int = 64,
             num_classes: int = 10, model: str = "mlp") -> dict:
    """The reference's ``adapter.init(PRNGKey(seed))`` for the model
    ``model`` names, broadcast to a worker-stacked numpy pytree (nested
    dicts for a registry model) — the weights both packages start
    from. Computed once a process for each argument set (a registry
    model's eager init takes seconds, and a parity case asks for it
    three times): fresh containers around the same read-only arrays."""
    return jax.tree.map(lambda v: v, _jax_init_once(
        seed, num_workers, dim, hidden, num_classes, model))


@functools.lru_cache(maxsize=None)
def _jax_init_once(seed: int, num_workers: int, dim: int, hidden: int,
                   num_classes: int, model: str) -> dict:
    adapter = jax_modelspec.get_adapter(model, dim=dim, hidden=hidden,
                                        num_classes=num_classes)
    p0 = adapter.init(jax.random.PRNGKey(seed))
    return jax.tree.map(
        lambda v: np.broadcast_to(np.asarray(v), (num_workers,) + v.shape),
        p0)


class RecordingStrategy:
    """Wraps a reference strategy and keeps a copy of every plan it
    makes, for replay into the port (``ReplayStrategy``)."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.adaptive = inner.adaptive
        self.plans: dict[int, tuple] = {}

    def plan(self, h, alive=None):
        p = self.inner.plan(h, alive=alive)
        self.plans[h] = (p.adj.copy(), p.taus.copy(),
                         None if p.extra_time is None
                         else np.array(p.extra_time))
        return p

    def observe(self, h, **kw):
        self.inner.observe(h, **kw)


class ReplayStrategy:
    """Feeds the reference run's recorded plans to a port engine, round by
    round; ignores the port's observations."""

    def __init__(self, recorded: RecordingStrategy):
        self.name = recorded.name
        self.adaptive = recorded.adaptive
        self.plans = recorded.plans

    def plan(self, h, alive=None):
        adj, taus, extra = self.plans[h]
        return RoundPlan(adj.copy(), taus.copy(), extra_time=extra)

    def observe(self, h, **kw):
        pass


_XLA_CACHE: list[str] = []


@contextlib.contextmanager
def xla_cache():
    """Within: XLA's compiled executables cached on disk, in a directory of
    this process's own (removed at exit), whatever their compile time.
    Each reference engine run jits fresh closures, so a test file's later
    runs of one model recompile the same programs: the cache skips XLA's
    compile for them (the tracing stays). Outside, the process's cache
    settings are as they were."""
    if not _XLA_CACHE:
        _XLA_CACHE.append(tempfile.mkdtemp(prefix="xla-cache-"))
        atexit.register(shutil.rmtree, _XLA_CACHE[0], True)
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    was = {k: getattr(jax.config, k) for k in keys}
    jax.config.update(keys[0], _XLA_CACHE[0])
    jax.config.update(keys[1], 0.0)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in was.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


def run_reference(algo: str, churn: bool, rounds: int = ROUNDS, *,
                  mixing: str = "uniform", **cfg_kw):
    """The reference ``engine.run_dfl`` from the JAX init; returns
    (History, RecordingStrategy). ``cfg_kw`` adds config fields (e.g. a
    codec) to ``CFG_KW`` or overrides them."""
    cfg = JaxConfig(**{**CFG_KW, **cfg_kw}, algorithm=algo)
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, churn=jax_churn(churn), rounds=rounds, **DATA_KW)
    strategy = RecordingStrategy(jax_make_strategy(
        cfg, jax_base_topology(cfg.num_workers, cfg.base_topology,
                               cfg.seed)))
    with xla_cache():
        hist = jax_engine.run_dfl(
            train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
            mixing=mixing, init_params=jax_init(cfg.seed, cfg.num_workers,
                                                model=cfg.model))
    return hist, strategy


def run_port(algo: str, churn: bool, engine_name: str, *,
             rounds: int = ROUNDS, replay: RecordingStrategy | None = None,
             mixing: str = "uniform", mesh=None, **cfg_kw):
    """The port's ``run_dfl`` or ``run_dfl_fused`` on the CPU from the same
    JAX init — with its own strategy, or replaying ``replay``'s plans;
    sharded over ``mesh`` (a CPU ``WorkerMesh``) when one is given."""
    cfg = FedHPConfig(**{**CFG_KW, **cfg_kw}, algorithm=algo)
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        cfg, churn=torch_churn(churn), rounds=rounds, device="cpu",
        **DATA_KW)
    strategy = (ReplayStrategy(replay) if replay is not None else
                make_strategy(cfg, make_base_topology(
                    cfg.num_workers, cfg.base_topology, cfg.seed)))
    run = {"reference": engine.run_dfl,
           "fused": fused.run_dfl_fused}[engine_name]
    return run(train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
               mixing=mixing,
               init_params=params_from_jax(jax_init(cfg.seed,
                                                    cfg.num_workers,
                                                    model=cfg.model)),
               mesh=mesh, device="cpu")


def run_reference_adpsgd(churn: bool, rounds: int = ROUNDS, **cfg_kw):
    """The reference ``engine.run_adpsgd`` (which starts from the JAX
    init ``jax_init`` gives)."""
    cfg = JaxConfig(**{**CFG_KW, **cfg_kw}, algorithm="adpsgd")
    train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
        cfg, churn=jax_churn(churn), rounds=rounds, **DATA_KW)
    with xla_cache():
        return jax_engine.run_adpsgd(train, tx, ty, shards, cluster, cfg,
                                     rounds=rounds)


def run_port_adpsgd(churn: bool, engine_name: str, *, rounds: int = ROUNDS,
                    **cfg_kw):
    """The port's ``run_adpsgd`` or ``run_adpsgd_fused`` on the CPU from
    the JAX init."""
    cfg = FedHPConfig(**{**CFG_KW, **cfg_kw}, algorithm="adpsgd")
    train, tx, ty, shards, cluster = experiment.setup_experiment(
        cfg, churn=torch_churn(churn), rounds=rounds, device="cpu",
        **DATA_KW)
    run = {"reference": engine.run_adpsgd,
           "fused": fused.run_adpsgd_fused}[engine_name]
    return run(train, tx, ty, shards, cluster, cfg, rounds=rounds,
               init_params=params_from_jax(jax_init(cfg.seed,
                                                    cfg.num_workers,
                                                    model=cfg.model)),
               device="cpu")


# the registry slice's tiny dense LM (tests/test_torch_registry_engine.py
# says why this size)
TINY_LM = "dense:d=32,layers=2,heads=2,kv=1,ff=32,vocab=32,seq=12"
# the parity contract (tests/test_torch_engine.py)
EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time", "staleness")
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6
# under an int8 codec (tests/test_torch_codec_engine.py says why)
INT8_LOSS_RTOL = 2e-3
INT8_CONSENSUS_RTOL = 1e-2


def assert_parity(h_ref, h_port, rounds: int, *, int8: bool = False) -> None:
    """The parity contract between a reference and a port History: host
    fields exactly equal, accuracy within 1/512, loss and consensus
    within 1e-4 relative (consensus also 1e-6 absolute), finite final
    parameters of the adapter's leaves. ``int8``: a run whose codec
    quantizes to int8, held to loss 2e-3 and consensus 1e-2 relative."""
    assert len(h_ref.records) == len(h_port.records) == rounds
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"],
                               rtol=INT8_LOSS_RTOL if int8 else REL_TOL)
    np.testing.assert_allclose(
        a["consensus"], b["consensus"], atol=CONSENSUS_ATOL,
        rtol=INT8_CONSENSUS_RTOL if int8 else REL_TOL)
    for name, leaf in h_port.final_params.items():
        assert bool(torch.isfinite(leaf).all()), name


def worst_diffs(a: dict, b: dict) -> dict[str, float]:
    """The largest device-metric differences of two ``as_arrays()``:
    accuracy absolute, loss and consensus relative to ``a``."""
    return {"accuracy": float(np.abs(a["accuracy"] - b["accuracy"]).max()),
            **{k: float((np.abs(a[k] - b[k])
                         / np.maximum(np.abs(a[k]), 1e-12)).max())
               for k in ("loss", "consensus")}}


def port_config(**kw) -> FedHPConfig:
    return replace(FedHPConfig(**CFG_KW), **kw)


# the registry families' loss and gradient parity (tests/test_torch_moe.py,
# _ssm.py, _xlstm.py): the dense tolerances of tests/test_torch_registry.py
FAMILY_LOSS_TOL = 2e-4
FAMILY_GRAD_TOL = 5e-3


def family_loss_and_grads(arch: str, fields: dict, *, batch: int = 2,
                          seq: int = 16, seed: int = 1):
    """The smoke config of ``arch`` (with ``fields`` over it) through the
    reference's ``jax.value_and_grad`` of ``registry.loss_fn`` and the
    port's adapter loss and autograd, from the reference's weights on
    seeded tokens [batch, seq] (next-token pairs of seq - 1) ->
    (reference loss, port loss, {leaf: (reference grad, port grad)},
    the port's ``ops.flash_attention`` calls)."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import registry as jax_registry
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import modelspec
    from repro_torch.kernels import ops
    jcfg = replace(jax_smoke_config(arch), **fields)
    tcfg = replace(get_smoke_config(arch), remat="none", **fields)
    p = jax_registry.init_params(jcfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]),
              "labels": jnp.asarray(tokens[:, 1:])}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda q: jax_registry.loss_fn(jcfg, q, jbatch)[0]))(p)
    adapter = modelspec.RegistryAdapter(tcfg, seq, 8, "port")
    flat = adapter.flatten({k: v[None] for k, v in
                            params_from_jax(p).items()})
    flat.requires_grad_(True)
    before = ops.LAUNCHES["flash_attention"]
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    ops.flash_attention = counting
    try:
        loss_t = adapter.loss(adapter.views(flat),
                              torch.from_numpy(tokens[None]), None)
        (g,) = torch.autograd.grad(loss_t.sum(), flat)
    finally:
        ops.flash_attention = real
    assert ops.LAUNCHES["flash_attention"] == before   # the plain version
    got = adapter.unflatten(g)
    grads = {name: (want.float().numpy(), got[name][0].float().numpy())
             for name, want in params_from_jax(grads_j).items()}
    return float(loss_j), float(loss_t.detach()[0]), grads, len(calls)


def assert_family_parity(arch: str, fields: dict, **kw) -> int:
    """``family_loss_and_grads`` held to loss 2e-4 and every gradient leaf
    5e-3 (absolute and relative); returns the flash calls."""
    loss_j, loss_t, grads, calls = family_loss_and_grads(arch, fields, **kw)
    np.testing.assert_allclose(loss_t, loss_j, rtol=FAMILY_LOSS_TOL,
                               atol=FAMILY_LOSS_TOL)
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, rtol=FAMILY_GRAD_TOL,
                                   atol=FAMILY_GRAD_TOL, err_msg=name)
    return calls


# the moe, hybrid and xlstm families' engine tests
# (tests/test_torch_families_engine*.py say why these sizes and settings)
FAMILY_SPECS = {
    "moe": "moe:d=32,layers=2,heads=2,kv=1,ff=32,vocab=32,seq=12,"
           "experts=4,experts_per_token=2",
    "hybrid": "hybrid:d=64,layers=2,heads=2,kv=1,ff=64,vocab=32,seq=12,"
              "ssm_state=8,ssm_every=2",
    "xlstm": "xlstm:d=64,layers=2,heads=2,vocab=32,seq=12,slstm_every=1"}
# a ring base: on a complete base FedHP's first round mixes every worker
# to the same row, and the two packages' consensus metrics are f32 noise
# there (the reference's 2-4e-6 at this size, past the contract's 1e-6)
FAMILY_KW = dict(num_workers=4, lr=0.02, tau_init=2, tau_max=2,
                 base_topology="ring")
FAMILY_ROUNDS = 3
# a leave, a crash, a straggler spike and a join inside the 3 rounds of
# the 4-worker fleet
FAMILY_CHURN = ((1, "leave", 1, {}), (1, "crash", 3, {}),
                (1, "straggle", 2, dict(factor=5.0, duration=2)),
                (2, "join", 1, {}))
# id -> (algorithm, churn, config fields)
FAMILY_CASES = {"fedhp-nochurn": ("fedhp", False, {}),
                "fedhp-churn": ("fedhp", FAMILY_CHURN, {}),
                "dpsgd-nochurn": ("dpsgd", False, {}),
                "dpsgd-int8": ("dpsgd", False, dict(compress="int8"))}


def check_family_engines(family: str, case: str) -> dict[str, float]:
    """One ``FAMILY_CASES`` case of ``family``'s tiny spec: the
    reference's ``engine.run_dfl`` against the port's ``run_dfl`` and
    ``run_dfl_fused``, held to the parity contract (int8's tolerances
    under int8) -> the worst device-metric differences."""
    algo, churn, fields = FAMILY_CASES[case]
    kw = dict(FAMILY_KW, model=FAMILY_SPECS[family], **fields)
    h_ref, _ = run_reference(algo, churn, FAMILY_ROUNDS, **kw)
    worst = {}
    for engine_name in ("reference", "fused"):
        h_port = run_port(algo, churn, engine_name, rounds=FAMILY_ROUNDS,
                          **kw)
        assert_parity(h_ref, h_port, FAMILY_ROUNDS,
                      int8="int8" in fields.get("compress", ""))
        for k, v in worst_diffs(h_ref.as_arrays(),
                                h_port.as_arrays()).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
