"""The port's numpy host control plane against the reference, bit for bit:
data, partitions, churn schedules, the simulated cluster's streams,
topologies, mixing matrices, connectivity repair, consensus distances,
the strategies' plans under identical observations, and wire accounting.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs.base import FedHPConfig as JaxConfig
from repro.core import algorithms as jax_algorithms
from repro.core import compression as jax_compression
from repro.core import consensus as jax_consensus
from repro.core import topology as jax_topology
from repro.data import partition as jax_partition
from repro.data import synthetic as jax_synthetic
from repro.simulation import cluster as jax_cluster
from repro_torch.configs.base import FedHPConfig
from repro_torch.core import algorithms, compression, consensus, topology
from repro_torch.data import partition, synthetic
from repro_torch.simulation import cluster


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_config_fields_and_defaults_match():
    ours = {f.name: f.default for f in dataclasses.fields(FedHPConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == ref


@pytest.mark.parametrize("seed,spread", [(0, 1.0), (5, 3.0), (11, 0.5)])
def test_classification_data(seed, spread):
    a = jax_synthetic.make_classification_data(600, seed=seed, spread=spread)
    b = synthetic.make_classification_data(600, seed=seed, spread=spread)
    _same(a.x, b.x)
    _same(a.y, b.y)
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("n,p", [(8, 0.4), (30, 0.1), (4, 0.8), (2, 0.5)])
def test_pskew_partition(n, p):
    labels = np.random.default_rng(1).integers(0, 10, 900)
    a = jax_partition.pskew_partition(labels, n, p,
                                      np.random.default_rng(2), shift=1)
    b = partition.pskew_partition(labels, n, p, np.random.default_rng(2),
                                  shift=1)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x, y)


def test_drifting_partition_shards_at():
    labels = np.random.default_rng(3).integers(0, 10, 700)
    a = jax_partition.DriftingPartition(labels, 8, 0.4, seed=4, period=3)
    b = partition.DriftingPartition(labels, 8, 0.4, seed=4, period=3)
    for h in (0, 2, 3, 7, 25):
        for x, y in zip(a.shards_at(h), b.shards_at(h)):
            _same(x, y)
    for x, y in zip(a, b):
        _same(x, y)


def _events(schedule):
    return [(e.round, e.kind, e.worker, e.factor, e.duration, e.group)
            for e in schedule.events]


@pytest.mark.parametrize("kw", [
    dict(num_workers=8, rounds=20, rate=0.3, seed=1),
    dict(num_workers=30, rounds=40, rate=0.5, seed=7, min_alive=5),
    dict(num_workers=10, rounds=12, rate=0.4, seed=2, kinds=("crash",)),
    dict(num_workers=12, rounds=30, rate=0.25, seed=3, rejoin_p=1.0,
         straggle_factor=2.0, straggle_duration=2)])
def test_churn_schedule_generate(kw):
    n, r = kw.pop("num_workers"), kw.pop("rounds")
    a = jax_cluster.ChurnSchedule.generate(n, r, **kw)
    b = cluster.ChurnSchedule.generate(n, r, **kw)
    assert _events(a) == _events(b)


def test_churn_schedule_generate_correlated():
    kw = dict(racks=4, outages=3, seed=5, outage_len=3)
    a = jax_cluster.ChurnSchedule.generate_correlated(16, 20, **kw)
    b = cluster.ChurnSchedule.generate_correlated(16, 20, **kw)
    assert _events(a) == _events(b)


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_sim_cluster_streams_with_churn(heterogeneous):
    """advance_round, sample_mu and sample_beta in the engines' order over
    20 rounds of churn: the RNG draw order is the contract."""
    sched = dict(num_workers=10, rounds=20, rate=0.4, seed=9)
    ca = jax_cluster.SimCluster(
        10, model_bits=221_504.0, seed=4, heterogeneous=heterogeneous,
        fail_at={5: [0]}, recover_at={9: [0]},
        churn=jax_cluster.ChurnSchedule.generate(**sched))
    cb = cluster.SimCluster(
        10, model_bits=221_504.0, seed=4, heterogeneous=heterogeneous,
        fail_at={5: [0]}, recover_at={9: [0]},
        churn=cluster.ChurnSchedule.generate(**sched))
    _same(ca.mu_mean, cb.mu_mean)
    for h in range(20):
        _same(ca.advance_round(h), cb.advance_round(h))
        _same(ca.last_joined, cb.last_joined)
        _same(ca.last_crashed, cb.last_crashed)
        _same(ca.sample_mu(), cb.sample_mu())
        _same(ca.sample_beta(), cb.sample_beta())


# every family of README.md's topology spec table
TOPOLOGY_SPECS = ["full", "ring", "erdos:0.3", "erdos:0.02", "ba:2",
                  "ws:4:0.2", "geo:3"]


@pytest.mark.parametrize("spec", TOPOLOGY_SPECS)
@pytest.mark.parametrize("n", [12, 30])
def test_make_base_topology(spec, n):
    # erdos' unsatisfiable-spec fallback warns; both packages must agree
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        a = jax_topology.make_base_topology(n, spec, seed=6)
        b = topology.make_base_topology(n, spec, seed=6)
    _same(a, b)


def _random_adj(n, p, seed):
    return jax_topology.erdos_topology(n, p, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixing_matrices(seed):
    adj = _random_adj(12, 0.3, seed)
    adj[3, :] = adj[:, 3] = 0                       # an isolated worker
    _same(jax_topology.mixing_matrix_uniform(adj),
          topology.mixing_matrix_uniform(adj))
    _same(jax_topology.mixing_matrix_metropolis(adj),
          topology.mixing_matrix_metropolis(adj))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_repair_connectivity(seed):
    rng = np.random.default_rng(seed)
    u = rng.random((14, 14))
    adj = ((u + u.T) / 2 < 0.2).astype(np.int8)     # often disconnected
    np.fill_diagonal(adj, 0)
    alive = rng.random(14) > 0.35
    cost = rng.random((14, 14))
    cost = cost + cost.T
    for c in (None, cost):
        _same(jax_topology.repair_connectivity(adj, alive, c),
              topology.repair_connectivity(adj, alive, c))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_distances(dtype):
    rng = np.random.default_rng(4)
    flat = rng.normal(size=(8, 6922)).astype(dtype)
    flat[5] = flat[2]                 # identical models: the noise floor
    _same(jax_consensus.pairwise_distances(flat),
          consensus.pairwise_distances(flat))


def _observations(n, h, rng, alive):
    d = rng.random((n, n)) * 2.0
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    return dict(mu=rng.random(n) * 0.3 + 0.05,
                beta=rng.random((n, n)) * 0.5,
                edge_dist=d.astype(np.float32),
                update_norms=(rng.random(n) + 0.5).astype(np.float32)[alive],
                smooth_l=float(rng.random() * 3 + 0.5),
                sigma=float(rng.random() + 0.1),
                loss=float(2.0 - 0.1 * h),
                cross_loss=rng.random((n, n)) + 1.0,
                alive=alive)


@pytest.mark.parametrize("algo", ["base", "dpsgd", "ldsgd", "fedhp", "pens"])
@pytest.mark.parametrize("churn", [False, True], ids=["nochurn", "churn"])
def test_strategy_plans(algo, churn):
    """Both packages' strategies fed the same observe() inputs plan the
    same topology, taus and overheads, round after round."""
    n = 10
    kw = dict(num_workers=n, algorithm=algo, tau_init=5, tau_max=20, seed=2,
              base_topology="erdos:0.5")
    base = jax_topology.make_base_topology(n, "erdos:0.5", seed=2)
    sa = jax_algorithms.make_strategy(JaxConfig(**kw), base)
    sb = algorithms.make_strategy(FedHPConfig(**kw), base)
    rng = np.random.default_rng(11)
    alive = np.ones(n, bool)
    for h in range(8):
        if churn and h == 3:
            alive[[1, 4]] = False
        if churn and h == 6:
            alive[1] = True
        pa, pb = sa.plan(h, alive=alive.copy()), sb.plan(h, alive=alive.copy())
        _same(pa.adj, pb.adj)
        _same(pa.taus, pb.taus)
        if pa.extra_time is None:
            assert pb.extra_time is None
        else:
            _same(pa.extra_time, pb.extra_time)
        obs = _observations(n, h, rng, alive)
        adj = pa.adj
        sa.observe(h, adj=adj, **obs)
        sb.observe(h, adj=adj, **obs)


@pytest.mark.parametrize("mode", ["none", "int8", "topk:0.1", "topk:100",
                                  "randk:0.05", "randk:7"])
@pytest.mark.parametrize("p", [6922, 1000, 50_000])
def test_codec_wire_accounting(mode, p):
    a = jax_compression.parse_mode(mode)
    b = compression.parse_mode(mode)
    assert (a.kind, a.k, a.mode) == (b.kind, b.k, b.mode)
    assert a.resolve_k(p) == b.resolve_k(p)
    assert a.wire_bits(p) == b.wire_bits(p)
    assert a.wire_ratio(p) == b.wire_ratio(p)
    assert jax_compression.flat_tile_shape(p) == compression.flat_tile_shape(p)


def test_leafmap_codecs_are_not_ported_yet():
    """Ported since this test was written: a leafmap parses to the
    reference's map (tests/test_torch_leafmap.py holds the rest)."""
    mode = "leafmap:embed=int8,default=none"
    lm = compression.parse_mode(mode)
    assert isinstance(lm, compression.LeafmapCodec)
    assert lm.mode == jax_compression.parse_mode(mode).mode == mode
    with pytest.raises(ValueError):
        compression.parse_mode("topk:0")
