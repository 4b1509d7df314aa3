"""The port's kernel module against the reference: gossip_mix here, the
wire codecs' kernels in ``tests/test_torch_codecs.py`` — and every CUDA
kernel against its plain version on a card (the ``cuda`` cases).

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
