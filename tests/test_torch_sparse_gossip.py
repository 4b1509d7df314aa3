"""The port's sparse edge-list gossip (``cfg.gossip="sparse"``) against the
reference.

1. The kernel's plain version ``ref.gossip_edges_ref`` (what
   ``ops.gossip_edges`` runs on CPU tensors) adds each destination's
   edges one at a time in list order, reading the pre-mix rows, with
   one rounding per subtract, multiply and add: bit-equal to that loop
   written out in numpy. The reference's Pallas ``gossip_edges`` walks
   the same edges in the same order, but in interpret mode XLA contracts
   its ``cur + w * (xs - xd)`` into a fused multiply-add (one rounding
   instead of two; a numpy emulation of the FMA reproduces it bit for
   bit), so the two differ in the last ulp: measured 2.4e-7 absolute on
   unit-scale rows, held to 1e-6. Against the reference's
   ``segment_sum`` oracle ``kernel_ref.gossip_edges_ref``, which sums a
   row's deltas first and adds them to x after, the same 1e-6. The
   port's segment form (``compression.edge_mix_delta``, what its
   reference engine runs) is bit-equal to that oracle.
2. The CSR form: a stable sort by destination keeps each row's edges in
   list order; zero-weight padding edges and entries past ``row_ptr[W]``
   are exact no-ops.
3. The engines: the reference JAX ``engine.run_dfl`` against the port's
   ``run_dfl`` and ``run_dfl_fused`` under ``gossip="sparse"`` at W = 8,
   from the JAX initialisation — FedHP and D-PSGD with and without
   churn, int8 and top-k 0.1, and Metropolis mixing. ROADMAP's parity
   contract: host fields exact; accuracy within 1/512, loss and
   consensus within 1e-4 relative (consensus also 1e-6 absolute); int8
   at the wider tolerances ``tests/test_torch_codec_engine.py`` gives
   its reasons for.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import run_port, run_reference, worst_diffs
from repro.core import compression as jax_compression
from repro.kernels import ref as jax_kernel_ref
from repro.kernels.gossip_edges import gossip_edges as pallas_gossip_edges
from repro.kernels.gossip_edges import pad_edges
from repro_torch.core import compression, topology as topo
from repro_torch.kernels import ops

torch.set_num_threads(1)

EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time")
ROUNDS = 6
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6
INT8_LOSS_RTOL = 2e-3
INT8_CONSENSUS_RTOL = 1e-2


def _graph(w: int, p: int, seed: int, mixing: str = "uniform"):
    """A random connected graph's directed edges with their mixing
    weights, two isolated (departed) workers, and a fleet's rows."""
    rng = np.random.default_rng(seed)
    adj = topo.erdos_topology(w, 0.5, rng)
    adj[[1, w - 2], :] = 0
    adj[:, [1, w - 2]] = 0
    e = topo.edges_from_adj(adj)
    src, dst, wts = topo.directed_edges(
        e, topo.edge_mixing_weights(e, w, mixing))
    x = rng.normal(size=(w, p)).astype(np.float32)
    return x, src, dst, wts


def _csr(src, dst, wts, w):
    return [torch.from_numpy(a) for a in topo.edges_to_csr(src, dst, wts, w)]


@pytest.mark.parametrize("mixing", ["uniform", "metropolis"])
@pytest.mark.parametrize("p", [300, 37])
def test_gossip_edges_matches_pallas_kernel(p, mixing):
    x, src, dst, wts = _graph(8, p, seed=p, mixing=mixing)
    csr = _csr(src, dst, wts, 8)
    xt = torch.from_numpy(x)
    y = ops.gossip_edges(xt, xt, *csr).numpy()
    loop = x.copy()
    for s, d, w in zip(src, dst, wts):      # list order, pre-mix reads
        loop[d] = loop[d] + w * (x[s] - x[d])
    np.testing.assert_array_equal(y, loop)
    y_pallas = np.asarray(pallas_gossip_edges(x, src, dst, wts,
                                              interpret=True))
    np.testing.assert_allclose(y, y_pallas, rtol=0, atol=1e-6)
    y_oracle = np.asarray(jax_kernel_ref.gossip_edges_ref(x, src, dst, wts))
    np.testing.assert_allclose(y, y_oracle, rtol=0, atol=1e-6)
    # the port's segment form is the oracle's arithmetic, bit for bit
    seg = (xt + compression.edge_mix_delta(xt, csr)).numpy()
    np.testing.assert_array_equal(seg, y_oracle)
    for i in (1, 6):                      # no edges: the row as it was
        np.testing.assert_array_equal(y[i], x[i])


def test_gossip_edges_lying_wire_matches_reference():
    """t != x: y[d] = x[d] + sum_e w_e (t[src_e] - x[d]) against the
    reference's jitted ``gossip_byz_edges`` (segment form), the kernel's
    plain version and the port's own segment form alike to 1e-6 (XLA
    fuses the jitted multiply into the scatter-add: measured 2.4e-7)."""
    from repro.core import robust as jax_robust
    from repro_torch.core import robust
    x, src, dst, wts = _graph(8, 200, seed=9)
    t = -2.0 * x
    csr = _csr(src, dst, wts, 8)
    y = ops.gossip_edges(torch.from_numpy(x), torch.from_numpy(t), *csr)
    want = np.asarray(jax_robust.gossip_byz_edges(x, t, src, dst, wts))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-6)
    seg = robust.gossip_byz_edges(torch.from_numpy(x), torch.from_numpy(t),
                                  csr)
    np.testing.assert_allclose(seg.numpy(), want, rtol=0, atol=1e-6)


def test_padding_edges_are_exact_noops():
    x, src, dst, wts = _graph(8, 100, seed=4)
    xt = torch.from_numpy(x)
    y = ops.gossip_edges(xt, xt, *_csr(src, dst, wts, 8))
    # the reference's padding: zero-weight self-loops at vertex 0
    ps, pd, pw = (np.asarray(a) for a in pad_edges(src, dst, wts,
                                                    len(src) + 13))
    assert len(ps) > len(src)
    y_pad = ops.gossip_edges(xt, xt, *_csr(ps, pd, pw, 8))
    assert torch.equal(y, y_pad)
    # entries past row_ptr[W] are never read
    row_ptr, col, w = _csr(src, dst, wts, 8)
    col = torch.cat([col, torch.full((5,), 3, dtype=torch.int32)])
    w = torch.cat([w, torch.full((5,), 7.0)])
    assert torch.equal(y, ops.gossip_edges(xt, xt, row_ptr, col, w))


def test_csr_keeps_list_order_within_each_row():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 6, 40).astype(np.int32)
    dst = rng.integers(0, 6, 40).astype(np.int32)
    wts = rng.random(40).astype(np.float32)
    row_ptr, col, w = topo.edges_to_csr(src, dst, wts, 6)
    assert row_ptr[0] == 0 and row_ptr[-1] == 40
    for d in range(6):
        ids = np.nonzero(dst == d)[0]             # list order
        np.testing.assert_array_equal(col[row_ptr[d]:row_ptr[d + 1]],
                                      src[ids])
        np.testing.assert_array_equal(w[row_ptr[d]:row_ptr[d + 1]], wts[ids])


def test_edge_mix_delta_matches_reference():
    x, src, dst, wts = _graph(8, 500, seed=11, mixing="metropolis")
    want = np.asarray(jax_compression.edge_mix_delta(x, src, dst, wts, 8))
    got = compression.edge_mix_delta(torch.from_numpy(x),
                                     _csr(src, dst, wts, 8))
    np.testing.assert_array_equal(got.numpy(), want)


# id -> (algorithm, churn, config fields, mixing)
CASES = {
    "fedhp-nochurn": ("fedhp", False, {}, "uniform"),
    "fedhp-churn": ("fedhp", True, {}, "uniform"),
    "dpsgd-nochurn": ("dpsgd", False, {}, "uniform"),
    "dpsgd-churn": ("dpsgd", True, {}, "uniform"),
    "fedhp-int8-churn": ("fedhp", True, dict(compress="int8"), "uniform"),
    "dpsgd-topk-churn": ("dpsgd", True, dict(compress="topk:0.1"),
                         "uniform"),
    "fedhp-metropolis": ("fedhp", False, {}, "metropolis"),
}
_reference_runs: dict = {}


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference_sparse(case, engine_name):
    algo, churn, kw, mixing = CASES[case]
    kw = dict(kw, gossip="sparse")
    if case not in _reference_runs:
        _reference_runs[case] = run_reference(algo, churn, ROUNDS,
                                              mixing=mixing, **kw)[0]
    h_ref = _reference_runs[case]
    h_port = run_port(algo, churn, engine_name, rounds=ROUNDS,
                      mixing=mixing, **kw)
    assert len(h_ref.records) == len(h_port.records) == ROUNDS
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    print(f"sparse {case} [{engine_name}] worst differences:",
          worst_diffs(a, b))
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    int8 = kw.get("compress") == "int8"
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"],
                               rtol=INT8_LOSS_RTOL if int8 else REL_TOL)
    np.testing.assert_allclose(
        a["consensus"], b["consensus"],
        rtol=INT8_CONSENSUS_RTOL if int8 else REL_TOL, atol=CONSENSUS_ATOL)
