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
rows as neighbour buffers); its lane-strided form
(``ops.gossip_mix_lanes``, the fused engines' batched seeds axis) runs
one plain call a lane. The CUDA kernels themselves are held against
their plain versions bit for bit by the ``cuda``-marked tests, on a
card — the lane-strided form also against one single-form launch a
lane, and the codec kernels at a leafmap's segment widths.

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


def test_gossip_mix_lanes_plain_version_is_per_lane():
    """On the CPU the lane-strided form runs S calls of the plain
    version, one per lane, with one mixing matrix shared (expanded) or
    one a lane."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4, 50, generator=gen)
    u = torch.randn(3, 6, 50, generator=gen)
    for w in (torch.rand(4, 6, generator=gen).expand(3, 4, 6),
              torch.rand(3, 4, 6, generator=gen)):
        y = ops.gossip_mix_lanes(x, u, w)
        for s in range(3):
            assert torch.equal(y[s], ops.gossip_mix(x[s], u[s], w[s]))


@pytest.mark.parametrize("shapes", [((2, 4, 10), (2, 3, 10), (2, 4, 2)),
                                    ((2, 4, 10), (3, 3, 10), (2, 4, 3)),
                                    ((2, 4, 10), (2, 3, 10), (4, 3)),
                                    ((4, 10), (3, 10), (4, 3))])
def test_gossip_mix_lanes_rejects_bad_shapes(shapes):
    x, u, w = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        ops.gossip_mix_lanes(x, u, w)


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


@pytest.mark.parametrize("w,p,want", [(30, 6922, 4), (2, 6922, 8),
                                      (1, 6922, 8), (66, 6922, 2),
                                      (67, 6922, 1), (100, 6922, 1),
                                      (300, 6922, 1), (30, 100000, 1),
                                      (30, 1000, 1), (30, 6921, 4),
                                      (1, 1, 1), (1, 1024, 2),
                                      (1, 100000, 8)])
def test_sparsify_cluster(w, p, want):
    """sparsify_block's cluster on a card of 132 SMs: 4 blocks a tile at
    the main path's [30, 6922], 8 at AD-PSGD's pair, fewer as the fleet's
    tiles fill the card at one block an SM, 1 where they do or where one
    block covers the tile; the launcher takes 1, 2, 4 or 8."""
    _, tile_len, n_tiles = ref.wire_tiles(p)
    s = ops.sparsify_cluster(w, n_tiles, tile_len, 132)
    assert s == want
    assert w * n_tiles * s <= 132 or s == 1
    source = (ops.CSRC / "sparsify_block.cu").read_text()
    assert f"constexpr int kMaxCluster = {ops.QUANT_MAX_CLUSTER};" in source


def _staged_source_smem(w: int) -> int:
    """The staged gossip_edges instance's shared memory at W rows in a
    group of the most rows a block takes, from the source's constants
    (staged_smem in the .cu: the t tile, the group's x rows, each row's
    CSR offsets and weights)."""
    source = (ops.CSRC / "gossip_edges.cu").read_text()

    def const(name):
        return int(source.split(f"constexpr int {name} = ")[1].split(";")[0])
    rows = const("kStagedMaxRows")
    return (w + rows) * const("kStagedCols") * 4 + \
        rows * const("kWarpEdges") * 8


@pytest.mark.parametrize("w,want", [(1, "staged"), (2, "staged"),
                                    (30, "staged"),
                                    (ops.EDGES_STAGED_MAX_ROWS, "staged"),
                                    (ops.EDGES_STAGED_MAX_ROWS + 1, "gather"),
                                    (300, "gather"), (2048, "gather"),
                                    (65535, "gather")])
def test_edges_instance(w, want):
    """gossip_edges runs the staged instance on every W = 30 path and up
    to EDGES_STAGED_MAX_ROWS workers, the gather one past it (the W =
    2,048 ring); the limit's column tile of all W rows fits a block's
    227 KB of shared memory."""
    assert ops.edges_instance(w) == want
    assert f"gossip_edges:{want}" in ops.INSTANCE_LAUNCHES
    assert _staged_source_smem(ops.EDGES_STAGED_MAX_ROWS) <= 232448


def test_gossip_edges_rejects_too_many_rows(monkeypatch):
    """Past 65,535 rows a launch raises before anything is built (the
    device checks stubbed: no card here); the plain version takes it."""
    x = torch.zeros(65536, 2)
    row_ptr = torch.zeros(65537, dtype=torch.int32)
    col, w = torch.zeros(0, dtype=torch.int32), torch.zeros(0)
    assert torch.equal(ops.gossip_edges(x, x, row_ptr, col, w), x)
    monkeypatch.setattr(ops, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_library", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="65535"):
        ops.gossip_edges(x, x, row_ptr, col, w)


@pytest.mark.parametrize("w,spec,p,offset", [(30, "full", 6922, 0),
                                             (30, "ring", 6921, 1),
                                             (70, "ba:2", 1000, 2),
                                             (300, "star", 100, 1)])
def test_cpu_gossip_edges_and_sparsify_run_plain_versions(w, spec, p,
                                                          offset):
    """On CPU tensors the two wrappers return their plain versions' bits
    (no kernel, no launch counted), on views that start ``offset`` floats
    into their storage as on contiguous rows, the gate per row and
    shared."""
    rng = np.random.default_rng(w + p)
    if spec == "star":
        adj = np.zeros((w, w), np.int8)
        adj[0, 1:] = adj[1:, 0] = 1
    else:
        adj = topo.make_base_topology(w, spec, 5)
    e = topo.edges_from_adj(adj)
    src, dst, wts = topo.directed_edges(e, topo.edge_mixing_weights(e, w))
    csr = [torch.from_numpy(a) for a in topo.edges_to_csr(src, dst, wts, w)]
    flat = rng.normal(size=w * p + offset).astype(np.float32)
    x = torch.from_numpy(flat)[offset:].view(w, p)
    t = torch.where(torch.arange(w)[:, None] % 5 == 0, -x, x)
    before = dict(ops.LAUNCHES)
    for src_rows in (x, t):
        assert torch.equal(ops.gossip_edges(x, src_rows, *csr),
                           ref.gossip_edges_ref(x, src_rows, *csr))
    k = max(p // 10, 1)
    for gate in (x.abs(), torch.from_numpy(rng.random((1, p),
                                                      np.float32))):
        thresh = torch.topk(gate, k, dim=1).values[:, -1].expand(w) \
            .contiguous()
        for got, want in zip(ops.sparsify_block(x, gate, thresh),
                             ref.sparsify_block_ref(x, gate, thresh)):
            assert torch.equal(got, want)
    assert ops.LAUNCHES == before


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


# the matching gossip (launch/train's round step): W rows against u = the
# rows themselves with K = M·W matching-major weights (column k weights
# row k mod W), and a ragged L past a column tile; the compressed
# gossip's centre is the decoded payload
def _matching_operands(gen, device, w: int, length: int):
    from repro_torch.core import topology as topo
    from repro_torch.runtime import collectives
    adj = topo.full_topology(w)
    pairs = collectives.matchings_as_pairs(adj)
    wt = collectives.matching_weight_tables(
        adj, topo.mixing_matrix_uniform(adj))
    x = torch.randn(w, length, generator=gen, device=device) \
        .to(torch.bfloat16).float()
    mw = torch.from_numpy(collectives.matching_mix_weights(pairs, wt))
    return x, mw.to(device)


def test_gossip_mix_bf16_rounding_plain_version():
    """Each term and each sum rounded to bf16, a zero weight adding an
    exact nothing: the rounded form keeps bf16 values, and differs from
    the f32 form's one rounding."""
    gen = torch.Generator().manual_seed(3)
    x, w = _matching_operands(gen, "cpu", 4, 5000)
    y = ops.gossip_mix(x, x, w, round_bf16=True)
    assert torch.equal(y, y.to(torch.bfloat16).float())
    acc = x
    for k in range(w.shape[1]):
        term = (w[:, k:k + 1] * (x[k % 4] - x)).to(torch.bfloat16).float()
        acc = (acc + term).to(torch.bfloat16).float()
    assert torch.equal(y, acc)
    once = ops.gossip_mix(x, x, w).to(torch.bfloat16).float()
    assert not torch.equal(y, once)
    w0 = torch.zeros_like(w)
    assert torch.equal(ops.gossip_mix(x, x, w0, round_bf16=True), x)


@pytest.mark.parametrize("round_bf16", [False, True])
def test_gossip_mix_centre_and_repeated_rows_plain_version(round_bf16):
    """u's rows are read cyclically (K = M·U): the same as u repeated M
    times, bit for bit; the terms differ from the centre while the sum
    starts at x; a centre of x is the default."""
    gen = torch.Generator().manual_seed(5)
    x, w = _matching_operands(gen, "cpu", 4, 3000)
    u = torch.randn(4, 3000, generator=gen).to(torch.bfloat16).float()
    y = ops.gossip_mix(x, u, w, centre=u, round_bf16=round_bf16)
    assert torch.equal(y, ops.gossip_mix(x, u.repeat(3, 1), w, centre=u,
                                         round_bf16=round_bf16))
    acc = x
    for k in range(w.shape[1]):
        term = w[:, k:k + 1] * (u[k % 4] - u)
        acc = acc + (term.to(torch.bfloat16).float() if round_bf16
                     else term)
        if round_bf16:
            acc = acc.to(torch.bfloat16).float()
    assert torch.equal(y, acc)
    assert torch.equal(ops.gossip_mix(x, x, w, centre=x,
                                      round_bf16=round_bf16),
                       ops.gossip_mix(x, x, w, round_bf16=round_bf16))


@pytest.mark.parametrize("shapes", [((4, 10), (3, 10), (4, 7), None),
                                    ((4, 10), (2, 10), (4, 6), (4, 9)),
                                    ((4, 10), (2, 10), (4, 6), (3, 10))])
def test_gossip_mix_rejects_bad_repeats_and_centres(shapes):
    x, u, w = (torch.zeros(s) for s in shapes[:3])
    centre = None if shapes[3] is None else torch.zeros(shapes[3])
    with pytest.raises(ValueError):
        ops.gossip_mix(x, u, w, centre=centre)


@pytest.mark.cuda
@pytest.mark.parametrize("w,length", [(4, 6922), (4, 1_000_003), (8, 4096)])
def test_cuda_gossip_mix_bf16round_bit_equal(w, length):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(length)
    x, mw = _matching_operands(gen, "cuda", w, length)
    before = (ops.LAUNCHES["gossip_mix"],
              ops.INSTANCE_LAUNCHES["gossip_mix:bf16round"])
    y = ops.gossip_mix(x, x, mw, round_bf16=True)
    assert (ops.LAUNCHES["gossip_mix"],
            ops.INSTANCE_LAUNCHES["gossip_mix:bf16round"]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y, ref.gossip_mix_ref(x, x, mw, round_bf16=True))


# the compressed matching gossip's call: the sum from x, the terms from
# the payload (u = centre), and the uncompressed call with a centre of x
# given (c = x, so the rows of c are staged with u's); 16 workers' 15
# matchings take K = 240 columns, past one staged chunk of 64
@pytest.mark.cuda
@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("w,length", [(4, 6922), (4, 1_000_003), (8, 4096),
                                      (16, 5000)])
def test_cuda_gossip_mix_centre_bit_equal(w, length, round_bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(length + 1)
    x, mw = _matching_operands(gen, "cuda", w, length)
    payload = torch.randn(w, length, generator=gen, device="cuda")
    for u, centre in ((payload, payload), (x, x), (payload, x)):
        before = ops.LAUNCHES["gossip_mix"]
        y = ops.gossip_mix(x, u, mw, centre=centre, round_bf16=round_bf16)
        assert ops.LAUNCHES["gossip_mix"] == before + 1
        assert torch.equal(y, ref.gossip_mix_ref(
            x, u, mw, centre=centre, round_bf16=round_bf16))


# (S, B, K, L, a mixing matrix shared by the lanes): the batched MLP
# round (4 lanes of the W = 30 fleet, u = x), AD-PSGD's pairwise average
# (one row a lane) and both endpoints' rows (two), a lane count past
# the grid's row groups, and K past one staged chunk
@pytest.mark.cuda
@pytest.mark.parametrize("lanes,b,k,length,shared", [
    (4, 30, 30, 6922, True), (4, 30, 30, 6922, False),
    (4, 1, 1, 6922, True), (4, 2, 2, 6922, True), (40, 8, 8, 1000, True),
    (3, 100, 100, 2000, True), (1, 30, 30, 6922, True)])
def test_cuda_gossip_mix_lanes_bit_equal(lanes, b, k, length, shared):
    """The lane-strided form against its plain version and against one
    launch of the single form per lane, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(lanes * length + b)
    x = torch.randn(lanes, b, length, generator=gen, device="cuda")
    u = x if b == k > 2 else torch.randn(lanes, k, length, generator=gen,
                                         device="cuda")
    w = (torch.rand(b, k, generator=gen, device="cuda") / k).expand(
        lanes, b, k) if shared else \
        torch.rand(lanes, b, k, generator=gen, device="cuda") / k
    before = dict(ops.LAUNCHES)
    y = ops.gossip_mix_lanes(x, u, w)
    assert ops.LAUNCHES["gossip_mix_lanes"] == before["gossip_mix_lanes"] + 1
    assert torch.equal(y, ref.gossip_mix_lanes_ref(x, u, w))
    for s in range(lanes):
        assert torch.equal(y[s], ops.gossip_mix(x[s], u[s], w[s]))


# leaf segment widths (the per-leaf codec maps): one coordinate, a width
# below one 1,024-column row (the MLP's merged biases, 138; a bias of
# 10; a layernorm of 960), rows not a multiple of 8 (the MLP's merged
# int8 leaves, 4,736 = 5 rows; 6,144 = 6 rows) and a segment staged from
# a column slice of a wider fleet
@pytest.mark.cuda
@pytest.mark.parametrize("w,p", [(30, 1), (30, 10), (30, 138), (8, 960),
                                 (30, 4736), (120, 6144), (1, 1)])
def test_cuda_codec_kernels_at_segment_widths(w, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(7 * p + w)
    wide = torch.randn(w, p + 77, generator=gen, device="cuda")
    x = wide[:, 40:40 + p].contiguous()
    q, scales = ops.quantize_block(x)
    assert all(torch.equal(a, b_) for a, b_ in
               zip((q, scales), ref.quantize_block_ref(x)))
    assert torch.equal(ops.dequantize_block(q, scales, p),
                       ref.dequantize_block_ref(q, scales, p))
    k = max(p // 10, 1)
    for gate in (x.abs(), torch.rand(1, p, generator=gen, device="cuda")):
        th = torch.topk(gate, k, dim=1).values[:, -1].expand(w).contiguous()
        assert all(torch.equal(a, b_) for a, b_ in
                   zip(ops.sparsify_block(x, gate, th),
                       ref.sparsify_block_ref(x, gate, th)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [
    "leafmap:w1=topk:0.1,b=none,default=int8",
    "leafmap:w=randk:0.2,b1=randk:3,b=int8,default=topk:0.05"])
def test_cuda_leafmap_payload_matches_the_cpu(mode):
    """A leafmap's payload through the kernels on the card, each segment
    staged from its column slice, bit-equal to the plain versions' on
    the CPU, over 3 lanes of the MLP's fleet folded into rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.core import compression, modelspec
    lm = compression.parse_mode(mode).compile(
        modelspec.get_adapter("mlp").leaf_offsets())
    gen = torch.Generator().manual_seed(11)
    flat = 0.3 * torch.randn(90, lm.segments[-1].stop, generator=gen)
    err = compression.leafmap_state_init(flat, lm, True) + \
        0.01 * torch.randn(flat.shape, generator=gen)
    scores = compression.leafmap_scores(
        lm, compression.sparsify_base_key(5), 3)
    scores = None if scores is None else torch.from_numpy(scores)
    before = dict(ops.LAUNCHES)
    got = compression.leafmap_payload(
        flat.cuda(), err.cuda(), lm,
        scores=None if scores is None else scores.cuda())
    want = compression.leafmap_payload(flat, err, lm, scores=scores)
    for a, b_ in zip(got, want):
        assert torch.equal(a.cpu(), b_)
    kinds = [s.codec.kind for s in lm.segments]
    assert ops.LAUNCHES["quantize_block"] - before["quantize_block"] == \
        kinds.count("int8")
    assert ops.LAUNCHES["sparsify_block"] - before["sparsify_block"] == \
        kinds.count("topk") + kinds.count("randk")


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


def _csr_on_card(w: int, spec: str, seed: int):
    """A ``spec`` graph's CSR edge list on the card (``star``: worker 0
    joined to every other), one worker cut off where W > 3."""
    if spec == "star":
        adj = np.zeros((w, w), np.int8)
        adj[0, 1:] = adj[1:, 0] = 1
    else:
        adj = topo.make_base_topology(w, spec, seed)
    if w > 3:
        adj[3, :] = adj[:, 3] = 0
    e = topo.edges_from_adj(adj)
    src, dst, wts = topo.directed_edges(e, topo.edge_mixing_weights(e, w))
    return [torch.from_numpy(a).cuda()
            for a in topo.edges_to_csr(src, dst, wts, w)]


# (W, base, P, x's offset into its storage in floats): each instance at
# its limit and one past it (the staged one at EDGES_STAGED_MAX_ROWS on a
# dense and a sparse graph, the gather one at 65,535 rows), both gather
# widths (2 columns a thread below 512 rows, 4 from 512 on), odd P, views
# off 4 and 8 bytes, a star (in-degree 299 at the hub: the gather's
# shuffled CSR entries in ten passes of 32), a full graph of 300 at P =
# 1,000, one of 64 past the staged limit, P = 1 and P = 3
EDGES_CUDA_CASES = [(ops.EDGES_STAGED_MAX_ROWS, "full", 6922, 0),
                    (ops.EDGES_STAGED_MAX_ROWS + 1, "full", 6922, 0),
                    (ops.EDGES_STAGED_MAX_ROWS, "ba:2", 6922, 0),
                    (ops.EDGES_STAGED_MAX_ROWS + 1, "ba:2", 6922, 0),
                    (65535, "ring", 8, 0), (30, "full", 6921, 0),
                    (30, "full", 6922, 1), (30, "full", 6921, 2),
                    (2048, "ring", 6922, 1), (511, "ring", 6921, 1),
                    (512, "ba:2", 6921, 2), (300, "star", 6922, 0),
                    (300, "full", 1000, 0), (64, "full", 6922, 0),
                    (30, "ring", 1, 0), (2, "full", 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,spec,p,offset", EDGES_CUDA_CASES)
def test_cuda_gossip_edges_instances(w, spec, p, offset):
    """gossip_edges against its plain version on the card, on the
    instance ``edges_instance`` names: t = x, and t != x in storage whose
    alignment differs from x's (one float further in), rows without edges
    kept, entries past row_ptr[W] never read; the launches counted under
    the instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    csr = _csr_on_card(w, spec, seed=w)
    gen = torch.Generator(device="cuda").manual_seed(w + p + offset)
    x = torch.randn(w * p + offset, generator=gen,
                    device="cuda")[offset:].view(w, p)
    t = torch.empty(w * p + offset + 1, device="cuda")[offset + 1:] \
        .view(w, p)
    t.copy_(torch.where(torch.arange(w, device="cuda")[:, None] % 5 == 0,
                        -x, x))
    instance = f"gossip_edges:{ops.edges_instance(w)}"
    before = ops.LAUNCHES["gossip_edges"], ops.INSTANCE_LAUNCHES[instance]
    for src_rows in (x, t):
        y = ops.gossip_edges(x, src_rows, *csr)
        assert torch.equal(y, ref.gossip_edges_ref(x, src_rows, *csr))
        if w > 3:
            assert torch.equal(y[3], x[3])
    row_ptr, col, wt = csr
    tail = torch.full((5,), 1, dtype=torch.int32, device="cuda")
    y = ops.gossip_edges(x, x, row_ptr, torch.cat([col, tail]),
                         torch.cat([wt, tail.float()]))
    assert torch.equal(y, ref.gossip_edges_ref(x, x, *csr))
    assert (ops.LAUNCHES["gossip_edges"], ops.INSTANCE_LAUNCHES[instance]) \
        == (before[0] + 3, before[1] + 3)


# (W, P): the cluster sizes 8, 4, 2 and 1 at P = 6,922 on a card of 132
# SMs (sparsify_cluster), AD-PSGD's pair, odd P, 13 tiles, P below one
# wire row, P = 1
SPARSIFY_CUDA_CASES = [(30, 6922), (66, 6922), (100, 6922), (300, 6922),
                       (2, 6922), (30, 6921), (30, 100000), (30, 1000),
                       (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,p", SPARSIFY_CUDA_CASES)
def test_cuda_sparsify_block_clusters(w, p):
    """sparsify_block against its plain version on the card, y and nnz,
    over the cluster size the wrapper picks: a gate per row and one
    shared row, the k-th largest gate as the threshold and thresholds of
    -inf (everything kept, whole tiles counted) and +inf (nothing), on
    contiguous rows and on x and a gate whose storage starts 4 and 8
    bytes before them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(w * p)
    _, tile_len, n_tiles = ref.wire_tiles(p)
    tile_sizes = torch.tensor([min(tile_len, p - t * tile_len)
                               for t in range(n_tiles)], dtype=torch.int32,
                              device="cuda").expand(w, -1)
    k = max(p // 10, 1)
    before = ops.LAUNCHES["sparsify_block"]
    for offset in (0, 1):
        x = torch.randn(w * p + offset, generator=gen,
                        device="cuda")[offset:].view(w, p)
        gates = (torch.empty(w * p + 2 * offset, device="cuda")[2 * offset:]
                 .view(w, p).copy_(x.abs()),
                 torch.rand(p + offset, generator=gen,
                            device="cuda")[offset:].view(1, p))
        for gate in gates:
            kth = torch.topk(gate, k, dim=1).values[:, -1].expand(w)
            for th in (kth.contiguous(),
                       torch.full((w,), -float("inf"), device="cuda"),
                       torch.full((w,), float("inf"), device="cuda")):
                y, nnz = ops.sparsify_block(x, gate, th)
                y_r, nnz_r = ref.sparsify_block_ref(x, gate, th)
                assert torch.equal(y, y_r) and torch.equal(nnz, nnz_r)
            assert not y.any() and not nnz.any()
            y, nnz = ops.sparsify_block(x, gate, th.neg())
            assert torch.equal(y, x) and torch.equal(nnz, tile_sizes)
    assert ops.LAUNCHES["sparsify_block"] == before + 16


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
    than keys, mismatched shapes and dtypes."""
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
    # operands of mixed dtypes (each alone runs: bf16 is an instance)
    for args in ((q.bfloat16(), k, v), (q, k.bfloat16(), v.bfloat16()),
                 (q.bfloat16(), k.bfloat16(), v.half())):
        with pytest.raises(TypeError, match="one dtype"):
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
        assert ops.flash_blocks(q, k, k) == b * 5 * chunks
        with pytest.raises(ValueError, match="grid"):
            ops.flash_attention(q, k, k)
    # the bf16 tile instance: one block per (sequence, query head, chunk
    # of 128 positions) -- 2 chunks at S = 200, every head width
    for hd in ops.FLASH_HEAD_DIMS:
        b = 2 ** 31 // (15 * 2) + 1
        q = torch.zeros(1, 200, 15, hd, dtype=torch.bfloat16).expand(
            b, -1, -1, -1)
        k = torch.zeros(1, 200, 5, hd, dtype=torch.bfloat16).expand(
            b, -1, -1, -1)
        assert ops.flash_block_rows(q, k, k) == ops.FLASH_BF16_TILE_ROWS
        assert ops.flash_blocks(q, k, k) == b * 15 * 2
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
# and 100); at head width 112 (not a power of two: 28 16-byte chunks a
# row, 14 k-steps) zamba2's local step (32 ungrouped heads), the short
# kernel's limit and one key past it, a window inside the short kernel's
# reach on kimi-k2's 64 / 8 heads, those heads over a long causal S, a
# window narrower than a key tile and a group straddling two heads
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
                    (1, 90, 6, 2, 192, True, 0),
                    (64, 15, 32, 32, 112, True, 0),
                    (16, _LIMIT[112], 32, 32, 112, True, 0),
                    (16, _LIMIT[112] + 1, 32, 32, 112, True, 0),
                    (8, _LIMIT[112], 64, 8, 112, True, 6),
                    (1, 700, 64, 8, 112, True, 0),
                    (1, 500, 8, 4, 112, True, 8),
                    (1, 90, 6, 2, 112, True, 0)]


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
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", FLASH_CUDA_CASES)
def test_cuda_flash_attention_bf16_matches_plain_version(b, s, hq, hkv, hd,
                                                         causal, window):
    """The bf16 instances against the plain version on bf16 operands
    (upcast, the f32 composition, one rounding): each element within one
    bf16 ulp, since the two f32 results differ in their last bits and may
    round apart — or within 2e-5, the f32 instances' tolerance, where an
    element is so near 0 that the f32 results' own difference passes its
    ulp (an f64 composition, rounded, misses one ulp on 16 of 3.7 M
    elements at the first case's shape, at |o| ~ 1e-6). The backward
    recomputes through the reference's bf16 composition
    (``ref.masked_attention``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(b * s + hd)
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    assert ops.flash_instance(q, k, v) == ("short" if s <= _LIMIT[hd]
                                           else "tile")
    before = ops.LAUNCHES["flash_attention"]
    y = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert y.dtype == torch.bfloat16
    forced = causal or s % 128 != 0
    want = ref.flash_attention_ref(q, k, v, causal=forced, window=window)
    assert bool(((y.float() - want.float()).abs()
                 <= ref.bf16_ulp(want).clamp_min(2e-5)).all())
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.flash_attention(qg, kg, vg, causal=causal, window=window).float() \
        .sum().backward()
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref.masked_attention(qr, kr, vr, causal=forced, window=window).float() \
        .sum().backward()
    for a, b_ in ((qg, qr), (kg, kr), (vg, vr)):
        assert torch.equal(a.grad, b_.grad)


# the bf16 tile instance (csrc/flash_attention_bf16.cu) at every head
# width: non-causal with Sk a multiple of 128, causal, sliding windows
# (one without causal), ragged S (100 and 1,000: the last 128-position
# chunk part empty, a consumer warpgroup wholly past S at 100 on a
# 128-row block), and g = Hq / Hkv of 1, 3, 6 and 8 (b, s, hq, hkv, hd,
# causal, window)
FLASH_BF16_TILE_CASES = [(2, 256, 6, 2, 64, False, 0),
                         (1, 1000, 8, 1, 64, True, 0),
                         (2, 100, 6, 1, 64, True, 0),
                         (1, 512, 4, 4, 64, True, 200),
                         (1, 384, 3, 1, 112, False, 0),
                         (1, 1000, 8, 1, 112, True, 0),
                         (2, 100, 1, 1, 112, True, 0),
                         (1, 600, 6, 1, 112, True, 128),
                         (1, 512, 8, 1, 128, False, 0),
                         (1, 1000, 6, 1, 128, True, 0),
                         (2, 100, 3, 1, 128, True, 0),
                         (1, 768, 4, 4, 128, True, 256),
                         (1, 512, 4, 2, 128, False, 100),
                         (1, 256, 6, 1, 192, False, 0),
                         (1, 1000, 8, 1, 192, True, 0),
                         (2, 100, 1, 1, 192, True, 0),
                         (1, 640, 3, 1, 192, True, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window",
                         FLASH_BF16_TILE_CASES)
def test_cuda_flash_attention_bf16_tile_matches_plain_version(
        b, s, hq, hkv, hd, causal, window):
    """The bf16 tile instance (wgmma bf16 products, p split hi / lo, TMA
    key tiles) against the plain version on bf16 operands: each element
    within one bf16 ulp, or within 2e-5 near 0 (see the test above); the
    launch counted as a bf16 tile launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(b * s + hd + hq)
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    assert ops.flash_instance(q, k, v) == "tile"
    before = (ops.LAUNCHES["flash_attention"],
              ops.INSTANCE_LAUNCHES["flash_attention:bf16"],
              ops.INSTANCE_LAUNCHES["flash_attention:bf16_tile"])
    y = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert (ops.LAUNCHES["flash_attention"],
            ops.INSTANCE_LAUNCHES["flash_attention:bf16"],
            ops.INSTANCE_LAUNCHES["flash_attention:bf16_tile"]) == \
        tuple(n + 1 for n in before)
    forced = causal or s % 128 != 0
    want = ref.flash_attention_ref(q, k, v, causal=forced, window=window)
    assert y.dtype == torch.bfloat16
    assert bool(((y.float() - want.float()).abs()
                 <= ref.bf16_ulp(want).clamp_min(2e-5)).all())


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
