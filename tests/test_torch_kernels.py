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


def test_robust_gossip_rejects_bad_calls(monkeypatch):
    x = torch.zeros(4, 10)
    deg = torch.ones(4, dtype=torch.int32)
    wide = torch.zeros(4, ops.ROBUST_SHARED_MAX_DEGREE + 1,
                       dtype=torch.int32)
    # the plain version has no width limit: CPU tensors never raise for D
    y = ops.robust_gossip(x, x, wide, deg, b=1.0, mode="trimmed")
    assert torch.equal(y, x)
    # a launch raises past the wide instance's limit, naming it, before
    # anything is built (the device checks stubbed: no card here)
    monkeypatch.setattr(ops, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_library", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match=str(ops.ROBUST_SHARED_MAX_DEGREE)):
        ops.robust_gossip(x, x, wide, deg, b=1.0, mode="trimmed")
    with pytest.raises(ValueError):
        ops.robust_gossip(x, x, torch.zeros(3, 2, dtype=torch.int32), deg,
                          b=1.0, mode="trimmed")
    with pytest.raises(ValueError):
        ops.robust_gossip(x, x, torch.zeros(4, 2, dtype=torch.int32), deg,
                          b=1.0, mode="mean")


@pytest.mark.parametrize("d,want", [(1, "register"), (2, "register"),
                                    (33, "register"), (64, "register"),
                                    (65, "wide"), (127, "wide"),
                                    (128, "wide"), (255, "wide"),
                                    (511, "wide"), (1023, "wide"),
                                    (1024, "shared"), (1100, "shared"),
                                    (32767, "shared")])
def test_robust_instance(d, want):
    """A table of D neighbours launches the register instance up to 64
    (its window D rounded up to a power of two), the wide one (a warp's
    registers per column) while every window fits 1,024 slots, the
    shared one past that; the launcher, which picks the instance from D,
    holds the same two limits."""
    assert ops.robust_instance(d) == want
    source = (ops.CSRC / "robust_gossip.cu").read_text()
    for name, limit in (("kRegisterMaxDegree",
                         ops.ROBUST_REGISTER_MAX_DEGREE),
                        ("kWideMaxDegree", ops.ROBUST_WIDE_MAX_DEGREE)):
        assert f"constexpr int {name} = {limit};" in source
    assert f"robust_gossip:{want}" in ops.INSTANCE_LAUNCHES


@pytest.mark.parametrize("w,p,want", [(30, 6922, 8), (2, 6922, 8),
                                      (1, 6922, 8), (66, 6922, 4),
                                      (300, 6922, 1), (30, 100000, 1),
                                      (30, 1000, 1), (1, 1, 1),
                                      (1, 1024, 2), (1, 100000, 8)])
def test_quantize_cluster(w, p, want):
    """quantize_block's cluster on a card of 132 SMs: 8 blocks a tile
    where the fleet's tiles are few (the main path's and AD-PSGD's
    shapes), fewer as they fill the card, 1 where they do or where one
    block covers the tile."""
    _, tile_len, n_tiles = ref.wire_tiles(p)
    assert ops.quantize_cluster(w, n_tiles, tile_len, 132) == want


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises — nothing falls back to the plain
    version."""
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.build()


# (B, K, L): the MLP path's round, an aligned and a short row, AD-PSGD's
# pair (one row, and both endpoints' rows), a ragged L of a million with
# the registry path's eight rows, K past one staged chunk of 64
# neighbours (u = x, and u apart from x with fewer rows than neighbours)
@pytest.mark.cuda
@pytest.mark.parametrize("b,k,length", [(30, 30, 6922), (30, 30, 8192),
                                        (30, 30, 1000), (1, 1, 6922),
                                        (2, 2, 6922), (8, 8, 1_000_003),
                                        (100, 100, 6922), (30, 100, 6922)])
def test_cuda_kernel_bit_equal_to_plain_version(b, k, length):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(length)
    x = torch.randn(b, length, generator=gen, device="cuda")
    # the fused engine's call mixes the fleet with itself (u = x)
    u = x if b == k > 2 else torch.randn(k, length, generator=gen,
                                         device="cuda")
    w = torch.rand(b, k, generator=gen, device="cuda") / k
    if u is x:
        w[2] = 0.0
        w[2, 2] = 1.0                    # identity row
    before = ops.LAUNCHES["gossip_mix"]
    y = ops.gossip_mix(x, u, w)
    assert ops.LAUNCHES["gossip_mix"] == before + 1
    assert torch.equal(y, ref.gossip_mix_ref(x, u, w))
    if u is x:
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


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("p", [1, 999, 1023, 1024, 1025, 6921, 6922,
                               100000])
def test_cuda_quantize_block_edges(w, p):
    """quantize_block and dequantize_block against their plain versions
    on the card at one and two workers, across the tile layout's edges (P
    below, at and one past a 1,024-column row; odd P, whose second row
    of x and of y starts on 4 bytes; 13 tiles, the last ragged), on
    random rows, all-zero rows (scale 1e-30, zero codes), rows with one
    nonzero value (its code -127), random rows with an all-zero first
    tile and a one-value last tile, and random rows that start 4 bytes
    into their storage (no 16- or 8-byte loads); each q decoded as it
    came and from a copy whose rows start at an odd byte (no vector
    loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3 * p + w)
    _, tile_len, n_tiles = ref.wire_tiles(p)
    rand = torch.randn(w, p, generator=gen, device="cuda")
    one = torch.zeros(w, p, device="cuda")
    one[:, p // 2] = -2.5
    mixed = rand.clone()
    mixed[:, :tile_len] = 0.0
    if n_tiles > 1:
        mixed[:, (n_tiles - 1) * tile_len:] = 0.0
        mixed[:, -1] = 4.0
    shifted = torch.randn(w * p + 1, generator=gen, device="cuda")[1:]
    before = dict(ops.LAUNCHES)
    for x in (rand, torch.zeros(w, p, device="cuda"), one, mixed,
              shifted.view(w, p)):
        q, scales = ops.quantize_block(x)
        q_ref, s_ref = ref.quantize_block_ref(x)
        assert torch.equal(q, q_ref) and torch.equal(scales, s_ref)
        q_odd = torch.empty(q.numel() + 1, dtype=torch.int8,
                            device="cuda")[1:].view(q.shape)
        q_odd.copy_(q)
        want = ref.dequantize_block_ref(q, scales, p)
        for codes in (q, q_odd):
            assert torch.equal(ops.dequantize_block(codes, scales, p), want)
    assert bool((q_ref[:, p:] == 0).all())
    assert ops.LAUNCHES["quantize_block"] == before["quantize_block"] + 5
    assert ops.LAUNCHES["dequantize_block"] == \
        before["dequantize_block"] + 10


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


def _degree_table(w: int, d_table: int, spec: str, seed: int):
    """A neighbour table [w, d_table] of distinct random neighbours by
    degree: ``"steps"`` gives worker i degree i mod (d_table + 1), every
    window size from 1 to d_table + 1 in one table; ``"deg3"`` gives
    every worker degree 3. Worker 3 has degree 0."""
    rng = np.random.default_rng(seed)
    deg = (np.arange(w) % (d_table + 1) if spec == "steps"
           else np.full(w, 3)).astype(np.int32)
    deg[3] = 0
    nbr = np.zeros((w, d_table), np.int32)
    for i, d in enumerate(deg):
        others = np.delete(np.arange(w, dtype=np.int32), i)
        nbr[i, :d] = rng.choice(others, d, replace=False)
    return nbr, deg


@pytest.mark.cuda
@pytest.mark.parametrize("d_table,spec,w", [(1, "ring", 30), (2, "ring", 30),
                                            (2, "ring", 2048),
                                            (32, "full", 30),
                                            (64, "full", 30),
                                            (64, "full", 60),
                                            (65, "full", 67),
                                            (128, "full", 130),
                                            (513, "full", 515),
                                            (128, "full", 67),
                                            (200, "ring", 30),
                                            (65, "full", 60),
                                            (127, "full", 100),
                                            (255, "full", 200),
                                            (511, "full", 300),
                                            (1023, "full", 700),
                                            (1024, "full", 700),
                                            (1100, "full", 1050),
                                            (2, "steps", 30),
                                            (4, "steps", 30),
                                            (8, "steps", 30),
                                            (16, "steps", 30),
                                            (32, "steps", 40),
                                            (64, "steps", 70),
                                            (64, "deg3", 70)])
def test_cuda_robust_gossip_bit_equal_to_plain_version(d_table, spec, w):
    """robust_gossip against its plain version on the card: trimmed with
    an integer and a fractional b, and the median, at D_PAD 1, 2, 32 and
    64 (register instances), D 65 to 1,023 (the wide instance: each
    block's own window of 2 to 1,024 slots) and D 1,024 and 1,100 (the
    shared instance), with degree-0 rows and sign-flipped rows in t. A
    table wider than the neighbourhoods (padding slots past deg) picks a
    wider instance and gives the same result. The ``steps`` tables give
    the register instances every window size up to D_PAD + 1 in one
    launch (each side of every size class's edge: a window of 2, 3, 4,
    5, 8, 9, 16, 17, 32, 33, 64 and 65 values), ``deg3`` narrow windows
    in a table 64 wide."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core import robust
    if spec in ("steps", "deg3"):
        nbr, deg = _degree_table(w, d_table, spec, seed=w)
    else:
        adj, *_ = _edge_case_graph(w, spec, seed=w)
        if d_table == 1:                # a matching: every degree <= 1
            adj = np.zeros((w, w), np.int8)
            for i in range(0, w - 1, 2):
                adj[i, i + 1] = adj[i + 1, i] = 1
            adj[3, :] = adj[:, 3] = 0
        nbr, deg = robust.neighbor_table(adj)
    assert nbr.shape[1] <= d_table
    nbr = np.pad(nbr, ((0, 0), (0, d_table - nbr.shape[1])))
    nbr, deg = torch.from_numpy(nbr).cuda(), torch.from_numpy(deg).cuda()
    gen = torch.Generator(device="cuda").manual_seed(d_table + w)
    # the plain version sorts a [W, D + 1, P] window: narrower rows for
    # the larger fleets, narrowest past 600 neighbours
    p = 6922 if w < 250 else 2000 if d_table <= 600 else 256
    x = torch.randn(w, p, generator=gen, device="cuda")
    t = torch.where(torch.arange(w, device="cuda")[:, None] % 5 == 0, -x, x)
    before = ops.LAUNCHES["robust_gossip"]
    instance = f"robust_gossip:{ops.robust_instance(d_table)}"
    before_instance = ops.INSTANCE_LAUNCHES[instance]
    for mode, b in (("trimmed", 6.0), ("trimmed", 1.0), ("trimmed", 0.2),
                    ("median", 0.0)):
        y = ops.robust_gossip(x, t, nbr, deg, b=b, mode=mode)
        assert torch.equal(y, ref.robust_gossip_ref(x, t, nbr, deg, b=b,
                                                    mode=mode)), (mode, b)
        assert torch.equal(y[3], x[3])
    assert ops.LAUNCHES["robust_gossip"] == before + 4
    assert ops.INSTANCE_LAUNCHES[instance] == before_instance + 4


def test_flash_attention_rejects_bad_calls():
    """The wrapper's rejects, on the CPU as on the card: a head width
    without a kernel instance, Hq not a multiple of Hkv, more queries
    than keys, mismatched shapes."""
    def qkv(b=1, s=8, hq=4, hkv=2, hd=64, sk=None):
        sk = s if sk is None else sk
        return (torch.zeros(b, s, hq, hd), torch.zeros(b, sk, hkv, hd),
                torch.zeros(b, sk, hkv, hd))
    for hd in (32, 96, 256):
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_attention(*qkv(hd=hd))
    for hq, hkv in ((5, 2), (3, 4)):
        with pytest.raises(ValueError, match="multiple of Hkv"):
            ops.flash_attention(*qkv(hq=hq, hkv=hkv))
    with pytest.raises(ValueError, match="S <= Sk"):
        ops.flash_attention(*qkv(s=9, sk=8))
    q, k, v = qkv()
    for args in ((q, k, v[:, :4]), (q[0], k, v), (q, k[..., :32], v)):
        with pytest.raises(ValueError):
            ops.flash_attention(*args)
    # a grid past the x axis, for each instance: one block per (sequence,
    # KV head, chunk of a block's query rows) — 1 chunk of the short
    # kernel's 45 rows at S = 15, 5 of the tile kernel's 600 at S = 200
    # (128 rows a block at hd 64), 10 at hd 192 (64 rows a block);
    # expanded views: nothing is allocated
    for s, hd, rows in ((15, 64, ops.FLASH_SHORT_ROWS),
                        (200, 64, ops.FLASH_TILE_ROWS[64]),
                        (200, 192, ops.FLASH_TILE_ROWS[192])):
        chunks = -(-3 * s // rows)
        b = 2 ** 31 // (5 * chunks) + 1
        q = torch.zeros(1, s, 15, hd).expand(b, -1, -1, -1)
        k = torch.zeros(1, s, 5, hd).expand(b, -1, -1, -1)
        assert ops.flash_block_rows(q, k, k) == rows
        with pytest.raises(ValueError, match="grid"):
            ops.flash_attention(q, k, k)


@pytest.mark.parametrize("sk,offset,want", [
    (15, 0, "short"), (ops.FLASH_SHORT_MAX_KEYS[64], 0, "short"),
    (ops.FLASH_SHORT_MAX_KEYS[64] + 1, 0, "tile"), (4096, 0, "tile"),
    (15, 1, "tile")])
def test_flash_instance(sk, offset, want):
    """The instance a launch runs: the short-sequence kernel up to
    FLASH_SHORT_MAX_KEYS[hd] keys on 16-byte aligned operands (its float4
    loads), the tile kernel past it or on a view that starts off 16
    bytes."""
    q, k, v = (torch.zeros(2 * sk * 4 * 64 + offset)[offset:]
               .view(2, sk, 4, 64) for _ in range(3))
    assert ops.flash_instance(q, k, v) == want


def test_consensus_dist_rejects_bad_shapes():
    for x, u in ((torch.zeros(10), torch.zeros(3, 9)),
                 (torch.zeros(2, 10), torch.zeros(3, 10)),
                 (torch.zeros(10), torch.zeros(10))):
        with pytest.raises(ValueError):
            ops.consensus_dist(x, u)


# (B, S, Hq, Hkv, hd, causal, window): the DFL path's local step and a
# slice of its measurement stack (S = 15), a ragged multi-tile S, the
# forced-causal rule (non-causal, Sk not a multiple of 128), a sliding
# window, each head width's instance, and for each head width the short
# kernel's dispatch limit and one key past it (the tile kernel), a short
# sliding window and a group of 60 rows across two blocks' chunks; then
# the tile kernel's own: a long causal S at each head width, not a
# multiple of its block's rows (128 at hd 64 and 128, 64 at hd 192); a
# window narrower than one key tile (32 keys at hd 64, 16 at hd 128 and
# 192); and groups whose blocks and warps straddle two heads (S = 72, 90
# and 100)
_LIMIT = ops.FLASH_SHORT_MAX_KEYS
FLASH_CUDA_CASES = [(256, 15, 15, 5, 64, True, 0),
                    (2048, 15, 15, 5, 64, True, 0),
                    (2, 300, 15, 5, 64, True, 0),
                    (3, 100, 6, 2, 64, False, 0),
                    (2, 256, 4, 4, 64, False, 0),
                    (1, 700, 8, 4, 128, True, 128),
                    (1, 333, 24, 2, 192, True, 0),
                    (64, _LIMIT[64], 15, 5, 64, True, 0),
                    (64, _LIMIT[64] + 1, 15, 5, 64, True, 0),
                    (16, _LIMIT[128], 32, 16, 128, True, 0),
                    (16, _LIMIT[128] + 1, 32, 16, 128, True, 0),
                    (8, _LIMIT[192], 24, 2, 192, True, 0),
                    (8, _LIMIT[192] + 1, 24, 2, 192, True, 0),
                    (32, 48, 32, 16, 128, True, 16),
                    (4, 5, 12, 1, 64, True, 2),
                    (1, 1100, 6, 2, 64, True, 0),
                    (1, 1030, 8, 4, 128, True, 0),
                    (1, 1001, 12, 2, 192, True, 0),
                    (2, 400, 6, 2, 64, True, 20),
                    (1, 500, 8, 4, 128, True, 8),
                    (1, 300, 6, 2, 192, True, 5),
                    (2, 100, 12, 4, 64, True, 0),
                    (1, 72, 4, 1, 128, True, 0),
                    (1, 90, 6, 2, 192, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", FLASH_CUDA_CASES)
def test_cuda_flash_attention_matches_plain_version(b, s, hq, hkv, hd,
                                                    causal, window):
    """flash_attention against its plain version on the card, within the
    reference's flash tolerance (2e-5 absolute and relative, unit-normal
    inputs); its backward recomputes through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(b * s + hd)
    q = torch.randn(b, s, hq, hd, generator=gen, device="cuda")
    k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
    v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
    assert ops.flash_instance(q, k, v) == ("short" if s <= _LIMIT[hd]
                                           else "tile")
    before = ops.LAUNCHES["flash_attention"]
    y = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    forced = causal or s % 128 != 0
    want = ref.flash_attention_ref(q, k, v, causal=forced, window=window)
    torch.testing.assert_close(y, want, atol=2e-5, rtol=2e-5)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.flash_attention(qg, kg, vg, causal=causal, window=window).sum() \
        .backward()
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref.flash_attention_ref(qr, kr, vr, causal=forced, window=window).sum() \
        .backward()
    for a, b_ in ((qg, qr), (kg, kr), (vg, vr)):
        assert torch.equal(a.grad, b_.grad)


@pytest.mark.cuda
def test_cuda_flash_attention_unaligned_operands():
    """Operands that start off 16 bytes run the tile kernel, and agree
    with the plain version as the short kernel does on aligned ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(15)
    shape = (64, 15, 15, 64)
    n = shape[0] * shape[1] * shape[2] * shape[3]
    q = torch.randn(n + 1, generator=gen, device="cuda")[1:].view(shape)
    k, v = (torch.randn(n // 3 + 1, generator=gen, device="cuda")[1:]
            .view(64, 15, 5, 64) for _ in range(2))
    assert ops.flash_instance(q, k, v) == "tile"
    want = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    y = ops.flash_attention(q, k, v, causal=True, window=0)
    torch.testing.assert_close(y, want, atol=2e-5, rtol=2e-5)
    y_short = ops.flash_attention(q.clone(), k.clone(), v.clone(),
                                  causal=True, window=0)
    torch.testing.assert_close(y_short, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,length", [(4, 2 ** 17), (7, 1_000_003),
                                      (1, 5), (30, 6922)])
def test_cuda_consensus_dist_matches_plain_version(k, length):
    """consensus_dist against its plain version on the card (1e-6
    relative), and the same bits on a second run (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(length)
    x = torch.randn(length, generator=gen, device="cuda")
    u = x + 0.1 * torch.randn(k, length, generator=gen, device="cuda")
    before = ops.LAUNCHES["consensus_dist"]
    d = ops.consensus_dist(x, u)
    assert ops.LAUNCHES["consensus_dist"] == before + 1
    torch.testing.assert_close(d, ref.consensus_dist_ref(x, u), rtol=1e-6,
                               atol=0)
    assert torch.equal(d, ops.consensus_dist(x, u))
    assert torch.equal(ops.consensus_dist(x, x[None].expand(k, -1)
                                          .contiguous()),
                       torch.zeros(k, device="cuda"))
