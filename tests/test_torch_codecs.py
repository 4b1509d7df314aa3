"""The wire codecs' kernels and update formulas against the reference.

On the CPU ``ops.quantize_block``, ``ops.dequantize_block`` and
``ops.sparsify_block`` run their plain versions (``kernels/ref.py``);
they are held against the reference's jnp oracles on numpy inputs made
from a seed, at P in {6922 (the paper's MLP, one tile per worker), 1000,
100, 20000 (three tiles, the last ragged)} and W in {2, 8}:

- quantize (q and scales), dequantize and the int8 round trip against
  ``compression.quantize_2d_ref`` / ``dequantize_2d_ref`` / ``qdq_rows``
  — bit-equal, with exact half-quantum values planted in every tile (the
  largest |x| of a tile is 127/128, so the scale is 1/128 and
  (n + ½)/128 divides to n + ½ exactly: round half to even decides);
- sparsify (y and the per-tile survivor counts) for top-k and rand-k
  against ``ref.sparsify_block_ref`` on the reference's padded layout and
  ``compression.sparsify_rows`` — bit-equal, with values on a coarse grid
  so that many ties straddle the top-k threshold (both keep every tie);
- the rand-k stream against ``jax.random`` at sampled (seed, step) —
  bit-equal;
- the compensated updates for each codec, error feedback on and off:
  ``compressed_pair_ref`` bit-equal (elementwise arithmetic only), and
  ``compressed_gossip_ref`` with the codec state bit-equal and the mixed
  parameters within 1e-6 absolute — the one product ``W v`` sums in
  another order than the reference's ``tensordot``. Both are held
  against the reference's formulas run eagerly: its jitted engines fuse
  the dequantize multiply into ``z - q * scale`` (no rounding of the
  product), 1 ulp of the parameter from the eager form.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels import ref as jax_ref
from repro.kernels.gossip_mix import pad_to_blocks
from repro_torch.core import compression as tc
from repro_torch.core.topology import erdos_topology, mixing_matrix_uniform
from repro_torch.kernels import ops, ref

# the suite runs one test file per xdist worker: keep each on one core
torch.set_num_threads(1)

SHAPES = [(w, p) for p in (6922, 1000, 100, 20000) for w in (2, 8)]
SHAPE_IDS = [f"W{w}-P{p}" for w, p in SHAPES]


def _planted(w: int, p: int, seed: int) -> np.ndarray:
    """[W, P] f32 with |x| < 127/128, each tile's first element 127/128
    (so its scale is exactly 1/128) and exact half quanta (n + ½)/128
    planted through every tile."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=(w, p)) * 0.3, -0.98, 0.98)
    _, tile_len, n_tiles = ref.wire_tiles(p)
    for t in range(n_tiles):
        lo, hi = t * tile_len, min((t + 1) * tile_len, p)
        x[:, lo] = 127 / 128 * np.where(rng.random(w) < 0.5, -1, 1)
        idx = rng.choice(np.arange(lo + 1, hi), min(40, hi - lo - 1),
                         replace=False)
        x[:, idx] = (rng.integers(-126, 126, (w, idx.size)) + 0.5) / 128
    return x.astype(np.float32)


def _rows_2d(z: np.ndarray):
    """The reference's wire layout of each worker row: [rows, cols]."""
    rows, cols = jc.flat_tile_shape(z.shape[1])
    pad = rows * cols - z.shape[1]
    return np.pad(z, ((0, 0), (0, pad))).reshape(z.shape[0], rows, cols)


@pytest.mark.parametrize("w,p", SHAPES, ids=SHAPE_IDS)
def test_int8_round_trip_bit_equal(w, p):
    x = _planted(w, p, seed=p + w)
    q, scales = ops.quantize_block(torch.from_numpy(x))
    y = ops.dequantize_block(q, scales, p)
    rows, cols = jc.flat_tile_shape(p)
    assert q.dtype == torch.int8 and tuple(q.shape) == (w, rows * cols)
    for i, x2 in enumerate(_rows_2d(x)):
        q_ref, s_ref = jc.quantize_2d_ref(jnp.asarray(x2))
        np.testing.assert_array_equal(q[i].view(rows, cols).numpy(),
                                      np.asarray(q_ref))
        np.testing.assert_array_equal(scales[i].numpy(),
                                      np.asarray(s_ref)[:, 0])
        y_ref = jc.dequantize_2d_ref(q_ref, s_ref)
        np.testing.assert_array_equal(y[i].numpy(),
                                      np.asarray(y_ref).reshape(-1)[:p])
    np.testing.assert_array_equal(
        tc.qdq_rows(torch.from_numpy(x)).numpy(),
        np.asarray(jc.qdq_rows(jnp.asarray(x))))
    # the planted half quanta really sit on the boundary
    assert (np.abs(x * 128 % 1 - 0.5) == 0).any()


def test_quantize_zero_tile_and_padding():
    """An all-zero tile gets the 1e-30 floor scale and zero codes; the
    wire row's padding past P is zero."""
    x = torch.zeros(2, 1500)
    x[1, :7] = torch.tensor([1.0, -2.0, 0.5, 3.0, -3.0, 0.0, 1.5])
    q, scales = ops.quantize_block(x)
    assert tuple(q.shape) == (2, 2048) and tuple(scales.shape) == (2, 1)
    assert scales[0, 0] == torch.tensor(1e-30) and not q[0].any()
    assert not q[:, 1500:].any()
    assert q[1, :7].tolist() == [42, -85, 21, 127, -127, 0, 64]
    torch.testing.assert_close(ops.dequantize_block(q, scales, 1500)[1, :4],
                               q[1, :4].float() * 3.0 / 127, rtol=0, atol=0)


def _sparse_inputs(w, p, seed):
    """Values on a 1/16 grid: many exact ties in |x|."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(w, p)) * 16) / 16).astype(np.float32)


@pytest.mark.parametrize("kind", ["topk", "randk"])
@pytest.mark.parametrize("w,p", SHAPES, ids=SHAPE_IDS)
def test_sparsify_bit_equal(w, p, kind):
    z = _sparse_inputs(w, p, seed=p * w)
    k = max(p // 10, 1)
    skey, step = tc.sparsify_base_key(3), 17
    scores = torch.from_numpy(tc.randk_scores(skey, step, p))
    zt = torch.from_numpy(z)
    gate = zt.abs() if kind == "topk" else scores[None]
    thresh = torch.topk(gate, k, dim=1).values[:, -1].expand(w).contiguous()
    y, nnz = ops.sparsify_block(zt, gate, thresh)

    # the reference's kernel layout: [rows, cols] per worker, the gate
    # padded with -1 (never kept), rows padded to whole tiles
    rows, cols = jc.flat_tile_shape(p)
    br, bc, rp, cp = pad_to_blocks(rows, cols)
    g = np.broadcast_to(gate.numpy(), (w, p))
    g2 = np.pad(g, ((0, 0), (0, rp * cp - p)), constant_values=-1.0)
    z2 = np.pad(z, ((0, 0), (0, rp * cp - p)))
    for i in range(w):
        y_ref, nnz_ref = jax_ref.sparsify_block_ref(
            jnp.asarray(z2[i].reshape(rp, cp)),
            jnp.asarray(g2[i].reshape(rp, cp)), thresh[i].item())
        np.testing.assert_array_equal(
            y[i].numpy(), np.asarray(y_ref).reshape(-1)[:p])
        np.testing.assert_array_equal(nnz[i].numpy(),
                                      np.asarray(nnz_ref)[:, 0])
    assert (nnz.sum(dim=1) >= k).all()

    y_rows = tc.sparsify_rows(zt, kind, k, scores=scores)
    y_jax = jc.sparsify_rows(jnp.asarray(z), kind, k, key=jnp.asarray(
        skey, jnp.uint32), step=step)
    np.testing.assert_array_equal(y_rows.numpy(), np.asarray(y_jax))
    np.testing.assert_array_equal(y_rows.numpy(), y.numpy())


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (5, 7), (11, 123),
                                       (123456789, 2 ** 31 - 1)])
def test_randk_scores_match_jax_random(seed, step):
    skey = tc.sparsify_base_key(seed)
    np.testing.assert_array_equal(np.asarray(skey, np.uint32),
                                  np.asarray(jc.sparsify_base_key(seed)))
    for p in (6922, 100):
        np.testing.assert_array_equal(
            tc.randk_scores(skey, step, p),
            np.asarray(jc.randk_scores(jc.sparsify_base_key(seed), step, p)))


CODECS = [("int8", True), ("int8", False), ("topk", True), ("topk", False),
          ("randk", True)]
CODEC_IDS = [f"{c}-{'ef' if ef else 'noef'}" for c, ef in CODECS]


def _codec_inputs(kind, ef, w=8, p=6922, seed=0):
    rng = np.random.default_rng(seed)
    flat = (rng.normal(size=(w, p)) * 0.3).astype(np.float32)
    if kind == "topk" and ef:       # x̂: a stale public copy of flat
        err = flat + (rng.normal(size=(w, p)) * 0.01).astype(np.float32)
    else:
        err = (rng.normal(size=(w, p)) * 0.003).astype(np.float32)
    mix = mixing_matrix_uniform(erdos_topology(w, 0.5, rng))
    return flat, err, mix.astype(np.float32), p // 10


@pytest.mark.parametrize("kind,ef", CODECS, ids=CODEC_IDS)
def test_compressed_gossip_matches_reference(kind, ef):
    flat, err, mix, k = _codec_inputs(kind, ef)
    skey, step = tc.sparsify_base_key(3), 4
    x_jax, e_jax = jc.compressed_gossip_ref(
        jnp.asarray(flat), jnp.asarray(err), jnp.asarray(mix),
        error_feedback=ef, kind=kind, k=k, gamma=0.25,
        key=jnp.asarray(skey, jnp.uint32), step=step)
    x, e = tc.compressed_gossip_ref(
        torch.from_numpy(flat), torch.from_numpy(err), torch.from_numpy(mix),
        error_feedback=ef, kind=kind, k=k, gamma=0.25,
        scores=torch.from_numpy(tc.randk_scores(skey, step, flat.shape[1])))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_jax))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax), rtol=0,
                               atol=1e-6)
    # an identity mix is an exact no-op on the parameters
    x_id, _ = tc.compressed_gossip_ref(
        torch.from_numpy(flat), torch.from_numpy(err),
        torch.eye(flat.shape[0]), error_feedback=ef, kind=kind, k=k,
        gamma=0.25, scores=torch.from_numpy(
            tc.randk_scores(skey, step, flat.shape[1])))
    np.testing.assert_array_equal(x_id.numpy(), flat)


@pytest.mark.parametrize("kind,ef", CODECS, ids=CODEC_IDS)
def test_compressed_pair_bit_equal(kind, ef):
    flat, err, _, k = _codec_inputs(kind, ef, w=2, seed=1)
    skey, step = tc.sparsify_base_key(5), 9
    out_jax = jc.compressed_pair_ref(
        *map(jnp.asarray, (flat[0], flat[1], err[0], err[1])),
        error_feedback=ef, kind=kind, k=k, gamma=0.25,
        key=jnp.asarray(skey, jnp.uint32), step=step)
    out = tc.compressed_pair_ref(
        *map(torch.from_numpy, (flat[0], flat[1], err[0], err[1])),
        error_feedback=ef, kind=kind, k=k, gamma=0.25,
        scores=torch.from_numpy(tc.randk_scores(skey, step, flat.shape[1])))
    for a, b in zip(out, out_jax):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the pair's sum is preserved
    np.testing.assert_allclose((out[0] + out[1]).numpy(),
                               flat[0] + flat[1], rtol=0, atol=1e-6)


def test_state_init_and_join_reset():
    flat = torch.randn(4, 50)
    err = torch.randn(4, 50)
    keep = torch.tensor([True, False, False, True])[:, None]
    assert torch.equal(tc.state_init(flat, "topk", True), flat)
    assert not tc.state_init(flat, "int8", True).any()
    assert all(tc.state_init(flat, kind, ef) is None for kind, ef in
               (("none", True), ("randk", True), ("int8", False),
                ("topk", False)))
    reset = tc.state_after_join(err, keep, flat, "int8", True)
    assert not reset[0].any() and torch.equal(reset[1], err[1])
    xhat = tc.state_after_join(err, keep, flat, "topk", True)
    assert torch.equal(xhat[3], flat[3]) and torch.equal(xhat[2], err[2])
    assert [tc.carries_state(c, True) for c in ("int8", "topk", "randk")] \
        == [True, True, False]
    assert not tc.carries_state("int8", False)


@pytest.mark.parametrize("call", [
    lambda: ops.quantize_block(torch.zeros(10)),
    lambda: ops.dequantize_block(torch.zeros(2, 1024, dtype=torch.int8),
                                 torch.zeros(2, 2), 1000),
    lambda: ops.sparsify_block(torch.zeros(2, 10), torch.zeros(3, 10),
                               torch.zeros(2)),
    lambda: ops.sparsify_block(torch.zeros(2, 10), torch.zeros(2, 10),
                               torch.zeros(1)),
], ids=["quantize-1d", "dequantize-scales", "sparsify-gate", "sparsify-thresh"])
def test_codec_wrappers_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()
