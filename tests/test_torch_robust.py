"""The port's Byzantine scenario axis (``core/robust.py``, the robust
kernel's plain version, the engines' wiring) against the reference.

1. ``core/robust.py`` function by function: the parsers, the attacker
   mask and the neighbour table bit-exact; the attacks and the AD-PSGD
   screening primitives exact; the edge-list trimmed mean (peeling, ties
   broken by the lowest edge id) and the attacked baseline's two forms.
2. ``ref.robust_gossip_ref`` (what ``ops.robust_gossip`` runs on CPU
   tensors) against the reference's Pallas ``robust_gossip`` in
   interpret mode, trimmed with an integer and a fractional b and the
   median, with degree-0 rows. The sorted windows hold the same values;
   the trimmed sums add them in another order (the Pallas kernel's
   ``sum`` over the window against the port's ascending positions), so
   trimmed means agree to 1e-6 on unit-scale rows and medians exactly.
3. The engines: the reference JAX ``engine.run_dfl`` against the port's
   ``run_dfl`` and ``run_dfl_fused`` with 20% sign-flip attackers (the
   W = 10, byzantine = (0, 5) fleet of the reference's scenario
   benchmark) — the attacked baseline dense and sparse, ``trimmed:2``
   dense and sparse, the median under a norm-blown attack — and the
   reference ``engine.run_adpsgd`` against both port AD-PSGD engines
   under ``screen:8``, rejection counts equal. ROADMAP's parity
   contract: host fields exact; accuracy within 1/512, loss and
   consensus within 1e-4 relative (consensus also 1e-6 absolute).
4. The guard matrix: where the reference raises for a combination that
   does not compose (a ``ValueError`` in every case), the port raises the
   same exception type.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (port_config, run_port, run_port_adpsgd,
                           run_reference, run_reference_adpsgd, worst_diffs)
from repro.configs.base import FedHPConfig as JaxConfig
from repro.core import experiment as jax_experiment
from repro.core import robust as jax_robust
from repro.core import topology as jax_topo
from repro.kernels.robust_gossip import robust_gossip as pallas_robust
from repro_torch.core import robust, topology as topo
from repro_torch.core.experiment import run_algorithm
from repro_torch.kernels import ops

torch.set_num_threads(1)

EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time", "staleness")
ROUNDS = 6
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6
# the reference's scenario fleet: 20% attackers (benchmarks/run.py)
BYZ_KW = dict(num_workers=10, tau_init=4, byzantine=(0, 5))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# core/robust.py, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["signflip", "signflip:2.5", "largenorm",
                                  "largenorm:3", "bogus"])
def test_parse_attack(spec):
    try:
        want = jax_robust.parse_attack(spec)
    except ValueError:
        with pytest.raises(ValueError):
            robust.parse_attack(spec)
        return
    assert robust.parse_attack(spec) == want


@pytest.mark.parametrize("spec", ["none", "median", "trimmed:2",
                                  "trimmed:0.2", "screen:8", "trimmed:-1",
                                  "screen:0", "mean"])
def test_parse_robust(spec):
    try:
        want = jax_robust.parse_robust(spec)
    except ValueError:
        with pytest.raises(ValueError):
            robust.parse_robust(spec)
        return
    assert robust.parse_robust(spec) == want


def test_byzantine_mask_and_neighbor_table():
    np.testing.assert_array_equal(robust.byzantine_mask((0, 5, 9), 10),
                                  jax_robust.byzantine_mask((0, 5, 9), 10))
    with pytest.raises(ValueError):
        robust.byzantine_mask((10,), 10)
    for spec in ("full", "ring", "ba:2", "erdos:0.3"):
        adj = topo.make_base_topology(12, spec, 4)
        adj[3, :] = adj[:, 3] = 0                  # an isolated worker
        for got, want in zip(robust.neighbor_table(adj),
                             jax_robust.neighbor_table(adj)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,scale", [("signflip", 1.0), ("largenorm", 10.0),
                                        ("signflip", 2.5)])
def test_attacks_exact(kind, scale):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 50)).astype(np.float32)
    byz = np.array([1, 0, 0, 1, 0, 0], bool)
    want = jax_robust.apply_attack(x, jnp.asarray(byz), jnp.float32(scale),
                                   kind=kind)
    got = robust.apply_attack(_t(x), _t(byz), scale, kind=kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for is_byz in (True, False):
        row = jax_robust.attack_row(x[0], jnp.bool_(is_byz),
                                    jnp.float32(scale), kind=kind)
        np.testing.assert_array_equal(
            robust.attack_row(_t(x[0]), is_byz, scale, kind=kind).numpy(),
            np.asarray(row))


def test_screen_primitives_exact():
    rng = np.random.default_rng(2)
    x = rng.normal(size=64).astype(np.float32)
    for h, nd in ((0.0, 0.7), (0.4, 0.9), (1.25, 0.1)):
        want = jax_robust.screen_fold(jnp.float32(h), jnp.float32(nd))
        got = robust.screen_fold(torch.tensor(h), torch.tensor(nd))
        assert got.item() == float(want)
    for t_peer, h in ((x + 0.01, 0.0), (-x, 0.0), (x + 0.01, 0.01),
                      (-x, 0.01), (x + 1e-4, 1e-6)):
        want = jax_robust.screen_accept(x, t_peer, jnp.float32(h), 8.0)
        got = robust.screen_accept(_t(x), _t(t_peer), torch.tensor(h), 8.0)
        assert bool(got) == bool(want)
    assert robust.SCREEN_EMA_ALPHA == jax_robust.SCREEN_EMA_ALPHA


@pytest.mark.parametrize("b", [0.0, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0])
def test_resolve_trim(b):
    cnt = np.arange(1, 40, dtype=np.int32)
    np.testing.assert_array_equal(
        robust.resolve_trim(b, _t(cnt)).numpy(),
        np.asarray(jax_robust.resolve_trim(b, cnt)))


def _scenario_inputs(spec: str, n: int, c: int, seed: int):
    rng = np.random.default_rng(seed)
    adj = topo.make_base_topology(n, spec, seed)
    adj[2, :] = adj[:, 2] = 0                        # a degree-0 worker
    x = rng.normal(size=(n, c)).astype(np.float32)
    byz = np.zeros(n, bool)
    byz[[0, n // 2]] = True
    t = np.where(byz[:, None], -x, x)                # sign-flipped rows
    return adj, x, t


@pytest.mark.parametrize("spec,b", [("full", 1.0), ("full", 0.3),
                                    ("ba:2", 2.0), ("ring", 1.0)])
def test_trimmed_mean_edges_matches_reference(spec, b):
    n = 9
    adj, x, t = _scenario_inputs(spec, n, 40, seed=len(spec))
    e = topo.edges_from_adj(adj)
    src, dst, _ = topo.directed_edges(e, np.zeros(e.shape[0]))
    cnt = adj.sum(1) + 1
    bi = np.minimum(np.floor(b * cnt) if b < 1 else np.full(n, b),
                    (cnt - 1) // 2)
    b_max = max(int(bi.max()), 0)
    want = np.asarray(jax_robust.trimmed_mean_edges(
        x, t, jnp.asarray(src), jnp.asarray(dst), b=b, num_workers=n,
        b_max=b_max))
    got = robust.trimmed_mean_edges(_t(x), _t(t), src, dst, b=b,
                                    num_workers=n, b_max=b_max).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], x[2])


def test_trimmed_mean_breaks_ties_once_per_side():
    """The reference's tie case: worker 0's multiset {0, 5, 5, -5, -5}
    loses one 5 and one -5, so its trimmed mean is 0."""
    n = 5
    adj = np.zeros((n, n), np.int8)
    adj[0, 1:] = adj[1:, 0] = 1
    flat = np.array([[0.0], [5.0], [5.0], [-5.0], [-5.0]], np.float32)
    e = topo.edges_from_adj(adj)
    src, dst, _ = topo.directed_edges(e, np.zeros(len(e)))
    got = robust.trimmed_mean_edges(_t(flat), _t(flat), src, dst, b=1.0,
                                    num_workers=n, b_max=1)
    want = jax_robust.trimmed_mean_edges(
        jnp.asarray(flat), jnp.asarray(flat), jnp.asarray(src),
        jnp.asarray(dst), b=1.0, num_workers=n, b_max=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == 0.0
    nbr, deg = robust.neighbor_table(adj)
    dense = ops.robust_gossip(_t(flat), _t(flat), _t(nbr), _t(deg), b=1.0,
                              mode="trimmed")
    assert float(dense[0, 0]) == 0.0


def test_attacked_baseline_forms_match_reference():
    adj, x, t = _scenario_inputs("erdos:0.5", 8, 64, seed=3)
    mix = jax_topo.mixing_matrix_uniform(adj).astype(np.float32)
    want = np.asarray(jax_robust.gossip_byz_dense(x, t, mix))
    got = robust.gossip_byz_dense(_t(x), _t(t), _t(mix)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the fused engine's form: gossip_mix with the diagonal zeroed
    fused = ops.gossip_mix(_t(x), _t(t), _t(mix * (1 - np.eye(8, dtype=
                                                             np.float32))))
    np.testing.assert_allclose(fused.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the robust kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,b", [("trimmed", 1.0), ("trimmed", 0.25),
                                    ("median", 0.0)],
                         ids=["trim1", "trim25pct", "median"])
@pytest.mark.parametrize("spec,c", [("full", 300), ("ring", 512),
                                    ("ba:2", 37)])
def test_robust_gossip_ref_matches_pallas_kernel(spec, c, mode, b):
    adj, x, t = _scenario_inputs(spec, 8, c, seed=c)
    nbr, deg = robust.neighbor_table(adj)
    want = np.asarray(pallas_robust(x, t, nbr, deg, b=b, mode=mode,
                                    interpret=True))
    got = ops.robust_gossip(_t(x), _t(t), _t(nbr), _t(deg), b=b,
                            mode=mode).numpy()
    if mode == "median":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], x[2])     # degree 0
    # a table padded to a wider D (the fused engine's power-of-two
    # bucket) gives the same result
    wide = np.pad(nbr, ((0, 0), (0, 5)))
    y_wide = ops.robust_gossip(_t(x), _t(t), _t(wide), _t(deg), b=b,
                               mode=mode)
    assert torch.equal(y_wide, torch.from_numpy(got))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

CASES = {
    "attacked-dense": dict(),
    "attacked-sparse": dict(gossip="sparse"),
    "trimmed-dense": dict(robust="trimmed:2"),
    "trimmed-sparse": dict(robust="trimmed:2", gossip="sparse"),
    "median-largenorm": dict(robust="median", byzantine_attack="largenorm"),
}
_reference_runs: dict = {}


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference_byzantine(case, engine_name):
    kw = dict(BYZ_KW, **CASES[case])
    if case not in _reference_runs:
        _reference_runs[case] = run_reference("dpsgd", False, ROUNDS,
                                              **kw)[0]
    h_ref = _reference_runs[case]
    h_port = run_port("dpsgd", False, engine_name, rounds=ROUNDS, **kw)
    _hold(h_ref, h_port, f"{case} [{engine_name}]")


def _hold(h_ref, h_port, name):
    assert len(h_ref.records) == len(h_port.records) == ROUNDS
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    print(f"{name} worst differences:", worst_diffs(a, b))
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=REL_TOL)
    np.testing.assert_allclose(a["consensus"], b["consensus"],
                               rtol=REL_TOL, atol=CONSENSUS_ATOL)


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
def test_port_adpsgd_screen_matches_reference(engine_name):
    kw = dict(BYZ_KW, robust="screen:8")
    if "screen" not in _reference_runs:
        _reference_runs["screen"] = run_reference_adpsgd(False, ROUNDS, **kw)
    h_ref = _reference_runs["screen"]
    h_port = run_port_adpsgd(False, engine_name, rounds=ROUNDS, **kw)
    _hold(h_ref, h_port, f"adpsgd screen:8 [{engine_name}]")
    print("screen_rejects", h_ref.screen_rejects, h_port.screen_rejects)
    assert h_port.screen_rejects == h_ref.screen_rejects
    assert sum(h_port.screen_rejects) > 0


# ---------------------------------------------------------------------------
# the guard matrix
# ---------------------------------------------------------------------------

GUARDS = {
    "trimmed-int8": ("dpsgd", dict(robust="trimmed:1", compress="int8")),
    "byzantine-topk": ("dpsgd", dict(byzantine=(1,), compress="topk:0.1")),
    "screen-sync": ("dpsgd", dict(robust="screen:3")),
    "trimmed-adpsgd": ("adpsgd", dict(robust="trimmed:1")),
    "median-adpsgd": ("adpsgd", dict(robust="median")),
    "screen-int8-adpsgd": ("adpsgd", dict(robust="screen:3",
                                          compress="int8")),
    "byzantine-int8-adpsgd": ("adpsgd", dict(byzantine=(1,),
                                             compress="int8")),
    "byzantine-sharded": ("dpsgd", dict(byzantine=(1,), sharded=True)),
    "byzantine-outside-fleet": ("dpsgd", dict(byzantine=(8,))),
    "unknown-attack": ("dpsgd", dict(byzantine=(1,),
                                     byzantine_attack="bogus")),
}


@pytest.mark.parametrize("fused", [False, True], ids=["reference", "fused"])
@pytest.mark.parametrize("case", list(GUARDS))
def test_port_raises_where_reference_raises(case, fused):
    algo, fields = GUARDS[case]
    from repro.core import algorithms as jax_algorithms
    from repro.core import engine as jax_engine
    from repro.core import fused as jax_fused
    from repro.core import topology as jax_topology
    cfg = JaxConfig(num_workers=8, rounds=2, seed=3, algorithm=algo,
                    **fields)
    args = (*jax_experiment.setup_experiment(cfg, rounds=2), cfg)
    if algo == "adpsgd":
        run = jax_fused.run_adpsgd_fused if fused else jax_engine.run_adpsgd
    else:
        run = jax_fused.run_dfl_fused if fused else jax_engine.run_dfl
        args += (jax_algorithms.make_strategy(
            cfg, jax_topology.make_base_topology(8, cfg.base_topology, 3)),)
    with pytest.raises(ValueError):
        run(*args, rounds=2)
    with pytest.raises(ValueError):
        run_algorithm(algo, port_config(**fields), rounds=2, fused=fused,
                      device="cpu")
