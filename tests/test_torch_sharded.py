"""The port's sharded-execution pieces against the reference, on the CPU.

- ``runtime/collectives.edge_shard_tables`` is bit-equal to the
  reference's (numpy on both sides), forced offsets and widths included,
  and raises where it raises;
- the routed delta and both sharded gossip functions, on meshes of CPU
  shards (``make_worker_mesh(S, devices=["cpu"] * S)``), match the
  reference's unsharded ``compression.edge_mix_delta`` and
  ``compressed_gossip_ref`` within 1e-6: the sharded delta adds each
  offset's edges in another order than the reference's one
  ``segment_sum``, and codec payloads are row-local (int8, top-k and
  rand-k with error feedback on and off);
- every directed edge is delivered exactly once (the counterpart of the
  reference's ``tests/test_collectives.py`` property, over seeded
  topologies: hypothesis is not installed here);
- ``make_worker_mesh`` and ``WorkerShardPlan``'s layout helpers;
- ``compression.compressed_gossip_ref``, rebuilt from
  ``compressed_payload`` and ``compressed_update``, is bit-equal to its
  form before the split (written out below).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jax_compression
from repro.core import topology as jax_topology
from repro.runtime import collectives as jax_collectives
from repro_torch.core import compression, engine
from repro_torch.launch.mesh import WorkerMesh, make_worker_mesh
from repro_torch.runtime import collectives, shardexec

# tier 1 runs the test files on parallel xdist workers: one core each
torch.set_num_threads(1)

GRAPHS = ("ring", "full", "ba:2", "erdos:0.3")
# (W, shards): every split the three fleets allow among 2, 3 and 4
SPLITS = ((8, 2), (8, 4), (12, 2), (12, 3), (12, 4), (30, 2), (30, 3))
TOL = 1e-6


def edge_list(w: int, spec: str, seed: int = 0, mixing: str = "uniform"):
    """The reference's directed edge list (src, dst, w) of a base graph,
    with its mixing weights (numpy)."""
    adj = jax_topology.make_base_topology(w, spec, seed)
    e = jax_topology.edges_from_adj(adj)
    return jax_topology.directed_edges(
        e, jax_topology.edge_mixing_weights(e, w, mixing))


def cpu_mesh(shards: int) -> WorkerMesh:
    return make_worker_mesh(shards, devices=["cpu"] * shards)


def split(x: np.ndarray, shards: int) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(b))
            for b in np.split(x, shards)]


def joined(blocks) -> np.ndarray:
    return torch.cat(list(blocks)).numpy()


# ---------------------------------------------------------------------------
# edge_shard_tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", GRAPHS)
@pytest.mark.parametrize("w,shards", SPLITS,
                         ids=[f"W{w}-S{s}" for w, s in SPLITS])
def test_edge_shard_tables_bit_equal(w, shards, spec):
    src, dst, wt = edge_list(w, spec)
    for kw in ({}, dict(offsets=tuple(range(shards)),
                        width=(w // shards) ** 2 + 1)):
        want = jax_collectives.edge_shard_tables(src, dst, wt, w, shards,
                                                 **kw)
        got = collectives.edge_shard_tables(src, dst, wt, w, shards, **kw)
        assert got[0] == want[0]
        for g, r in zip(got[1:], want[1:]):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["indivisible", "offset", "width"])
def test_edge_shard_tables_raise_as_the_reference(case):
    src, dst, wt = edge_list(8, "ring")
    args, kw, match = {
        "indivisible": ((8, 3), {}, "not divisible"),
        "offset": ((8, 4), dict(offsets=(0,)), "not in the forced"),
        "width": ((8, 2), dict(width=1), "forced width"),
    }[case]
    for fn in (jax_collectives.edge_shard_tables,
               collectives.edge_shard_tables):
        with pytest.raises(ValueError, match=match):
            fn(src, dst, wt, *args, **kw)


# ---------------------------------------------------------------------------
# the routed delta and the sharded gossip functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", GRAPHS)
@pytest.mark.parametrize("w,shards", SPLITS,
                         ids=[f"W{w}-S{s}" for w, s in SPLITS])
def test_routed_delta_matches_edge_mix_delta(w, shards, spec):
    """Each shard's ``routed_mix_delta`` (through ``RoutedEdges``) against
    the reference's unsharded ``edge_mix_delta``; and the sharded gossip
    function's blocks against x + that delta."""
    src, dst, wt = edge_list(w, spec, seed=1)
    x = np.random.default_rng(w + shards).normal(size=(w, 37)) \
        .astype(np.float32)
    want = np.asarray(jax_compression.edge_mix_delta(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(wt),
        w))
    mesh = cpu_mesh(shards)
    (routed,) = collectives.route_edges([(src, dst, wt)], w, mesh.devices)
    np.testing.assert_allclose(joined(routed.mix_delta(split(x, shards))),
                               want, atol=TOL, rtol=0)
    mixed = collectives.gossip_edges_sharded_fn(
        mesh, (mesh.axis,), src, dst, wt, w)(split(x, shards))
    np.testing.assert_allclose(joined(mixed), x + want, atol=TOL, rtol=0)
    # one launch per (shard, offset that carries edges into the shard)
    _, _, _, wl = collectives.edge_shard_tables(src, dst, wt, w, shards)
    assert routed.launches() == int((wl != 0).any(axis=2).sum())


CODECS = (("int8", 0, True), ("int8", 0, False), ("topk", 5, True),
          ("topk", 5, False), ("randk", 6, True), ("randk", 6, False))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind,k,ef", CODECS,
                         ids=[f"{k}-{'ef' if e else 'noef'}"
                              for k, _, e in CODECS])
def test_compressed_sharded_matches_reference(kind, k, ef, shards):
    """``gossip_edges_compressed_sharded_fn`` against the reference's
    unsharded ``compressed_gossip_ref`` over the same edges, from the
    same state (``state_init``), at rand-k's step 2 of seed 0."""
    w, p = 8, 300
    src, dst, wt = edge_list(w, "erdos:0.5", seed=2)
    x = np.random.default_rng(7).normal(size=(w, p)).astype(np.float32)
    err0 = jax_compression.state_init(jnp.asarray(x), kind, ef)
    want_y, want_e = jax_compression.compressed_gossip_ref(
        jnp.asarray(x), err0, None, error_feedback=ef, kind=kind, k=k,
        key=jax_compression.sparsify_base_key(0), step=jnp.int32(2),
        gamma=0.5, use_kernel=False,
        edges=(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(wt)))
    fn = collectives.gossip_edges_compressed_sharded_fn(
        cpu_mesh(shards), ("workers",), src, dst, wt, w, kind=kind, k=k,
        error_feedback=ef, seed=0, gamma=0.5)
    state = compression.state_init(torch.from_numpy(x), kind, ef)
    ys, es = fn(split(x, shards),
                None if state is None else list(state.split(w // shards)),
                2)
    np.testing.assert_allclose(joined(ys), np.asarray(want_y), atol=TOL,
                               rtol=0)
    if state is None:
        assert all(e is None for e in es)
    else:
        np.testing.assert_allclose(joined(es), np.asarray(want_e),
                                   atol=TOL, rtol=0)


def test_compressed_kind_with_its_fraction():
    """``kind="topk:0.05"`` resolves k against P, as the reference's."""
    w, p = 8, 200
    src, dst, wt = edge_list(w, "ring")
    x = np.random.default_rng(3).normal(size=(w, p)).astype(np.float32)
    mesh = cpu_mesh(2)
    state = list(torch.from_numpy(x).clone().split(4))
    by_mode = collectives.gossip_edges_compressed_sharded_fn(
        mesh, ("workers",), src, dst, wt, w, kind="topk:0.05")
    by_k = collectives.gossip_edges_compressed_sharded_fn(
        mesh, ("workers",), src, dst, wt, w, kind="topk",
        k=compression.parse_mode("topk:0.05").resolve_k(p))
    for a, b in zip(by_mode(split(x, 2), state, 0),
                    by_k(split(x, 2), state, 0)):
        np.testing.assert_array_equal(joined(a), joined(b))


@pytest.mark.parametrize("seed", range(8))
def test_routing_delivers_every_edge_exactly_once(seed):
    """Sharded edge gossip applied to X = I_W extracts the effective
    mixing matrix, which must equal the dense matrix built from the
    directed edge list: every edge lands once, on the right row, with its
    weight."""
    rng = np.random.default_rng(seed)
    shards = (2, 4, 8)[seed % 3]
    w = (8, 16)[seed % 2]
    adj = jax_topology.erdos_topology(w, rng.uniform(0.15, 0.8), rng)
    if adj.sum() == 0:
        adj = jax_topology.ring_topology(w)
    e = jax_topology.edges_from_adj(adj)
    src, dst, wt = jax_topology.directed_edges(
        e, jax_topology.edge_mixing_weights(e, w, "uniform"))
    mesh = cpu_mesh(shards)
    got = joined(collectives.gossip_edges_sharded_fn(
        mesh, (mesh.axis,), src, dst, wt, w)(
            split(np.eye(w, dtype=np.float32), shards)))
    want = np.eye(w)
    for s, d, weight in zip(src, dst, wt):
        want[d, s] += weight
        want[d, d] -= weight
    np.testing.assert_allclose(got, want, atol=TOL)


# ---------------------------------------------------------------------------
# the mesh and the plan's layout
# ---------------------------------------------------------------------------

def test_make_worker_mesh_validates():
    mesh = make_worker_mesh(devices=["cpu"])
    assert mesh.devices == (torch.device("cpu"),)
    assert mesh.axis == "workers"
    four = make_worker_mesh(3, "fleet", devices=["cpu"] * 4)
    assert four.devices == (torch.device("cpu"),) * 3
    assert four.axis == "fleet"
    for shards in (0, 5, -1):
        with pytest.raises(ValueError, match="out of range"):
            make_worker_mesh(shards, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        # the default is every visible card: none here
        with pytest.raises(ValueError, match="0 devices"):
            make_worker_mesh()
    assert shardexec.default_worker_mesh("cpu").devices == \
        (torch.device("cpu"),)


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"],
                                     ["cuda:0", "cpu", "cpu"]])
def test_mesh_rejects_mixed_device_kinds(devices):
    """Shards hand blocks to each other with non-blocking copies, which a
    card-to-host copy would let its reader race: a mesh that mixes the
    CPU with a card raises."""
    with pytest.raises(ValueError, match="one kind"):
        make_worker_mesh(len(devices), devices=devices)


@pytest.mark.parametrize("make", [
    collectives.gossip_edges_sharded_fn,
    collectives.gossip_edges_compressed_sharded_fn])
def test_sharded_fn_checks_worker_axes(make):
    """The worker axes name the mesh's one axis, or the call raises."""
    src, dst, wt = edge_list(8, "ring")
    mesh = cpu_mesh(2)
    make(mesh, (mesh.axis,), src, dst, wt, 8)
    with pytest.raises(ValueError, match="not the mesh's axis"):
        make(mesh, ("pod", "data"), src, dst, wt, 8)


@pytest.mark.parametrize("w,shards", [(10, 4), (8, 4), (3, 2)])
def test_plan_layout(w, shards):
    """put_stacked pads with zero rows and unpad returns the real rows;
    host arrays pad and split by shard; the blend's psum of per-shard
    partial products matches the unsharded ``_reinit_joined``."""
    plan = shardexec.WorkerShardPlan(cpu_mesh(shards), w)
    assert plan.w_pad == plan.rows * shards >= w > plan.w_pad - shards
    x = torch.from_numpy(np.random.default_rng(w).normal(
        size=(w, 6)).astype(np.float32))
    blocks = plan.put_stacked(x)
    assert [tuple(b.shape) for b in blocks] == [(plan.rows, 6)] * shards
    assert torch.equal(plan.unpad(blocks), x)
    assert not plan.gather(blocks)[w:].any()
    taus = plan.put_host(np.arange(1, w + 1))
    assert torch.equal(torch.cat(taus)[w:], torch.zeros(plan.pad,
                                                        dtype=torch.int64))
    alive = np.ones(w, bool)
    joined_ = np.zeros(w, bool)
    joined_[[0, w - 1]] = True
    got = plan.unpad(plan.reinit_joined(blocks, joined_, alive & ~joined_))
    want = engine._reinit_joined(x, torch.from_numpy(joined_),
                                 torch.from_numpy(alive & ~joined_))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got[~torch.from_numpy(joined_)],
                       x[~torch.from_numpy(joined_)])


# ---------------------------------------------------------------------------
# compressed_gossip_ref after the split
# ---------------------------------------------------------------------------

def gossip_before_split(flat, err, mix, *, error_feedback, kind, k,
                        scores=None, gamma=1.0, edges=None):
    """``compressed_gossip_ref``'s body before it was split into
    ``compressed_payload`` and ``compressed_update``."""
    def mix_delta(v):
        if edges is not None:
            return compression.edge_mix_delta(v, edges)
        return torch.matmul(mix, v) - v

    if kind == "topk" and error_feedback:
        xhat = err + compression.sparsify_rows(flat - err, "topk", k)
        return flat + gamma * mix_delta(xhat), xhat
    yhat, new_err = compression.compress_decompress(
        flat, err, error_feedback=error_feedback, kind=kind, k=k,
        scores=scores)
    return flat + mix_delta(yhat), new_err


@pytest.mark.parametrize("form", ["dense", "edges"])
@pytest.mark.parametrize("kind,k,ef", CODECS,
                         ids=[f"{k}-{'ef' if e else 'noef'}"
                              for k, _, e in CODECS])
def test_compressed_gossip_ref_unchanged_by_the_split(kind, k, ef, form):
    w, p = 8, 2500
    gen = np.random.default_rng(11)
    x = torch.from_numpy(gen.normal(size=(w, p)).astype(np.float32))
    err = compression.state_init(x, kind, ef)
    if err is not None:
        err = err + 0.01 * torch.from_numpy(
            gen.normal(size=(w, p)).astype(np.float32))
    adj = jax_topology.make_base_topology(w, "erdos:0.5", 4)
    mix = torch.from_numpy(jax_topology.mixing_matrix_uniform(adj)).float()
    edges = engine._on(engine.round_edges(adj, "uniform"), "cpu")
    scores = torch.from_numpy(compression.randk_scores(
        compression.sparsify_base_key(3), 5, p))
    kw = dict(error_feedback=ef, kind=kind, k=k, scores=scores, gamma=0.4)
    if form == "edges":
        kw["edges"] = edges
    got = compression.compressed_gossip_ref(
        x, err, None if form == "edges" else mix, **kw)
    want = gossip_before_split(x, err, None if form == "edges" else mix,
                               **kw)
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            assert torch.equal(g, r)
