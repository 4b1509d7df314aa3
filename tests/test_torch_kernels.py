"""The port's kernel module against the reference: gossip_mix here, the
wire codecs' kernels in ``tests/test_torch_codecs.py``, gossip_edges in
``tests/test_torch_sparse_gossip.py``, robust_gossip in
``tests/test_torch_robust.py`` — the wrappers' shape checks, and every
CUDA kernel against its plain version on a card (the ``cuda`` cases).

On the CPU ``ops.gossip_mix`` runs the kernel's plain version
(``ref.gossip_mix_ref``); it is held against the reference's Pallas
``gossip_mix_2d`` in interpret mode, called as the reference's fused
engine calls it (``repro/core/fused.py:284-290``: the flat rows padded to
the int8 tile layout, the kernel vmapped over the output rows with all W
rows as neighbour buffers). The CUDA kernels themselves are held against
their plain versions bit for bit by the ``cuda``-marked tests, on a
card.

The file imports JAX only inside the tests that compare with it, so the
``cuda`` tests also run where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import topology as topo
from repro_torch.core.topology import erdos_topology, mixing_matrix_uniform
from repro_torch.kernels import ops, ref

# the driver runs one test file per xdist worker: keep each on one core
torch.set_num_threads(1)

ATOL = 1e-6


def _reference_mix(flat: np.ndarray, mix: np.ndarray) -> np.ndarray:
    """The reference fused engine's gossip: [W, P] -> [W, P]."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.compression import flat_tile_shape
    from repro.kernels.gossip_mix import gossip_mix_2d

    w, p = flat.shape
    rows, cols = flat_tile_shape(p)
    x2 = jnp.pad(flat, ((0, 0), (0, rows * cols - p))).reshape(w, rows, cols)
    kernel = functools.partial(gossip_mix_2d, interpret=True)
    y2 = jax.jit(jax.vmap(lambda xi, wi: kernel(xi, x2, wi)))(x2, mix)
    return np.asarray(y2.reshape(w, -1)[:, :p])


def _main_path_inputs(w: int, p: int, seed: int):
    """A fleet's flat rows and the uniform mix of a random connected
    topology, with two departed workers' identity rows."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(w, p)).astype(np.float32)
    adj = erdos_topology(w, 0.5, rng)
    dead = [1, w - 2]
    adj[dead, :] = 0
    adj[:, dead] = 0
    return flat, mixing_matrix_uniform(adj).astype(np.float32), dead


@pytest.mark.parametrize("p", [6922, 1000])
def test_gossip_mix_matches_pallas_kernel(p):
    flat, mix, dead = _main_path_inputs(8, p, seed=p)
    y_ref = _reference_mix(flat, mix)
    x = torch.from_numpy(flat)
    y = ops.gossip_mix(x, x, torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=ATOL)
    for i in dead:                       # identity rows: exact no-ops
        np.testing.assert_array_equal(y[i], flat[i])
        np.testing.assert_array_equal(y_ref[i], flat[i])


def test_gossip_mix_pairwise_average():
    """AD-PSGD's use: one row, one neighbour, weight 0.5."""
    rng = np.random.default_rng(3)
    x, u = rng.normal(size=(2, 1, 6922)).astype(np.float32)
    y = ops.gossip_mix(torch.from_numpy(x), torch.from_numpy(u),
                       torch.full((1, 1), 0.5)).numpy()
    np.testing.assert_allclose(y, x + 0.5 * (u - x), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shapes", [((4, 10), (3, 10), (4, 2)),
                                    ((4, 10), (3, 9), (4, 3)),
                                    ((4, 10, 1), (3, 10), (4, 3))])
def test_gossip_mix_rejects_bad_shapes(shapes):
    x, u, w = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        ops.gossip_mix(x, u, w)


def test_gossip_edges_rejects_bad_shapes():
    x = torch.zeros(4, 10)
    row_ptr = torch.zeros(5, dtype=torch.int32)
    col = torch.zeros(3, dtype=torch.int32)
    w = torch.zeros(3)
    for args in ((x, torch.zeros(4, 9), row_ptr, col, w),
                 (x, x, torch.zeros(4, dtype=torch.int32), col, w),
                 (x, x, row_ptr, col, torch.zeros(2))):
        with pytest.raises(ValueError):
            ops.gossip_edges(*args)


def test_robust_gossip_rejects_bad_calls():
    x = torch.zeros(4, 10)
    deg = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=str(ops.ROBUST_MAX_DEGREE)):
        ops.robust_gossip(x, x, torch.zeros(4, ops.ROBUST_MAX_DEGREE + 1,
                                            dtype=torch.int32), deg, b=1.0,
                          mode="trimmed")
    with pytest.raises(ValueError):
        ops.robust_gossip(x, x, torch.zeros(3, 2, dtype=torch.int32), deg,
                          b=1.0, mode="trimmed")
    with pytest.raises(ValueError):
        ops.robust_gossip(x, x, torch.zeros(4, 2, dtype=torch.int32), deg,
                          b=1.0, mode="mean")


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises — nothing falls back to the plain
    version."""
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.build()


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,length", [(30, 30, 6922), (30, 30, 8192),
                                        (30, 30, 1000), (1, 1, 6922)])
def test_cuda_kernel_bit_equal_to_plain_version(b, k, length):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(length)
    x = torch.randn(b, length, generator=gen, device="cuda")
    # the fused engine's call mixes the fleet with itself (u = x)
    u = x if b == k > 1 else torch.randn(k, length, generator=gen,
                                         device="cuda")
    w = torch.rand(b, k, generator=gen, device="cuda") / k
    if b > 2:
        w[2] = 0.0
        w[2, 2] = 1.0                    # identity row
    before = ops.LAUNCHES["gossip_mix"]
    y = ops.gossip_mix(x, u, w)
    assert ops.LAUNCHES["gossip_mix"] == before + 1
    assert torch.equal(y, ref.gossip_mix_ref(x, u, w))
    if b > 2:
        assert torch.equal(y[2], x[2])


@pytest.mark.cuda
@pytest.mark.parametrize("w,p", [(30, 6922), (2, 6922), (30, 100000),
                                 (30, 1000)])
def test_cuda_codec_kernels_bit_equal_to_plain_versions(w, p):
    """quantize_block, dequantize_block and sparsify_block (a gate per
    row, and one shared row) against their plain versions on the card,
    with identity cases: an all-zero row (floor scale, zero codes, exact
    zeros back), a threshold of -inf (everything kept, whole tiles
    counted) and +inf (nothing kept)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(p + w)
    x = torch.randn(w, p, generator=gen, device="cuda")
    x[-1] = 0.0
    before = dict(ops.LAUNCHES)
    q, scales = ops.quantize_block(x)
    y = ops.dequantize_block(q, scales, p)
    q_ref, s_ref = ref.quantize_block_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(scales, s_ref)
    assert torch.equal(y, ref.dequantize_block_ref(q, scales, p))
    assert not y[-1].any() and not q[-1].any()

    k = max(p // 10, 1)
    shared = torch.rand(1, p, generator=gen, device="cuda")
    _, tile_len, n_tiles = ref.wire_tiles(p)
    tile_sizes = torch.tensor([min(tile_len, p - t * tile_len)
                               for t in range(n_tiles)], dtype=torch.int32,
                              device="cuda")
    for gate in (x.abs(), shared):
        thresh = torch.topk(gate, k, dim=1).values[:, -1].expand(w)
        for th in (thresh.contiguous(), torch.full((w,), -float("inf"),
                                                   device="cuda"),
                   torch.full((w,), float("inf"), device="cuda")):
            y_s, nnz = ops.sparsify_block(x, gate, th)
            y_r, nnz_r = ref.sparsify_block_ref(x, gate, th)
            assert torch.equal(y_s, y_r) and torch.equal(nnz, nnz_r)
        assert torch.equal(y_s, torch.zeros_like(x)) and not nnz.any()
    full, nnz = ops.sparsify_block(x, shared, th.neg())
    assert torch.equal(full, x) and torch.equal(nnz, tile_sizes.expand(w, -1))
    assert ops.LAUNCHES["quantize_block"] == before["quantize_block"] + 1
    assert ops.LAUNCHES["dequantize_block"] == before["dequantize_block"] + 1
    assert ops.LAUNCHES["sparsify_block"] == before["sparsify_block"] + 7


def _edge_case_graph(w: int, spec: str, seed: int):
    """A ``spec`` graph's directed edges in CSR form with uniform
    weights, one worker cut off (a row with no edges)."""
    adj = topo.make_base_topology(w, spec, seed)
    adj[3, :] = adj[:, 3] = 0
    e = topo.edges_from_adj(adj)
    src, dst, wts = topo.directed_edges(e, topo.edge_mixing_weights(e, w))
    return adj, src, dst, wts


@pytest.mark.cuda
@pytest.mark.parametrize("w,spec", [(30, "full"), (30, "ring"),
                                    (2048, "ring"), (2048, "ba:2")])
def test_cuda_gossip_edges_bit_equal_to_plain_version(w, spec):
    """gossip_edges against its plain version on the card: t = x and
    t != x, a row with no edges, and zero-weight padding edges and
    entries past row_ptr[W] (exact no-ops)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, src, dst, wts = _edge_case_graph(w, spec, seed=w)
    pad = 8
    src_p = np.concatenate([src, np.zeros(pad, np.int32)])
    dst_p = np.concatenate([dst, np.zeros(pad, np.int32)])
    wts_p = np.concatenate([wts, np.zeros(pad, np.float32)])
    csr = [torch.from_numpy(a).cuda() for a in
           topo.edges_to_csr(src, dst, wts, w)]
    csr_p = [torch.from_numpy(a).cuda() for a in
             topo.edges_to_csr(src_p, dst_p, wts_p, w)]
    gen = torch.Generator(device="cuda").manual_seed(w)
    x = torch.randn(w, 6922, generator=gen, device="cuda")
    t = torch.where(torch.arange(w, device="cuda")[:, None] % 5 == 0, -x, x)
    before = ops.LAUNCHES["gossip_edges"]
    for src_rows in (x, t):
        y = ops.gossip_edges(x, src_rows, *csr)
        assert torch.equal(y, ref.gossip_edges_ref(x, src_rows, *csr))
        assert torch.equal(y, ops.gossip_edges(x, src_rows, *csr_p))
        assert torch.equal(y[3], x[3])
    row_ptr, col, wt = csr
    tail = torch.full((5,), 1, dtype=torch.int32, device="cuda")
    y = ops.gossip_edges(x, x, row_ptr, torch.cat([col, tail]),
                         torch.cat([wt, tail.float()]))
    assert torch.equal(y, ref.gossip_edges_ref(x, x, *csr))
    assert ops.LAUNCHES["gossip_edges"] == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("d_table,spec,w", [(1, "ring", 30), (2, "ring", 30),
                                            (2, "ring", 2048),
                                            (32, "full", 30),
                                            (64, "full", 30),
                                            (64, "full", 60)])
def test_cuda_robust_gossip_bit_equal_to_plain_version(d_table, spec, w):
    """robust_gossip against its plain version on the card: trimmed with
    an integer and a fractional b, and the median, at D_PAD 1, 2, 32 and
    64, with degree-0 rows and sign-flipped rows in t. A table wider
    than the neighbourhoods (padding slots past deg) picks a wider
    instance and gives the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core import robust
    adj, *_ = _edge_case_graph(w, spec, seed=w)
    if d_table == 1:                    # a matching: every degree <= 1
        adj = np.zeros((w, w), np.int8)
        for i in range(0, w - 1, 2):
            adj[i, i + 1] = adj[i + 1, i] = 1
        adj[3, :] = adj[:, 3] = 0
    nbr, deg = robust.neighbor_table(adj)
    assert nbr.shape[1] <= d_table
    nbr = np.pad(nbr, ((0, 0), (0, d_table - nbr.shape[1])))
    nbr, deg = torch.from_numpy(nbr).cuda(), torch.from_numpy(deg).cuda()
    gen = torch.Generator(device="cuda").manual_seed(d_table + w)
    x = torch.randn(w, 6922, generator=gen, device="cuda")
    t = torch.where(torch.arange(w, device="cuda")[:, None] % 5 == 0, -x, x)
    before = ops.LAUNCHES["robust_gossip"]
    for mode, b in (("trimmed", 6.0), ("trimmed", 1.0), ("trimmed", 0.2),
                    ("median", 0.0)):
        y = ops.robust_gossip(x, t, nbr, deg, b=b, mode=mode)
        assert torch.equal(y, ref.robust_gossip_ref(x, t, nbr, deg, b=b,
                                                    mode=mode)), (mode, b)
        assert torch.equal(y[3], x[3])
    assert ops.LAUNCHES["robust_gossip"] == before + 4
