"""The port's MLP, adapter layout and per-worker training math against
the reference on JAX-initialised weights (tolerance 1e-6 absolute /
relative: f32 products summed in another order)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_init
from repro.core import engine as jax_engine
from repro.core import modelspec as jax_modelspec
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import engine, modelspec

W, D, H, C = 6, 32, 64, 10
TOL = 1e-6

JAX_ADAPTER = jax_modelspec.get_adapter("mlp", dim=D, hidden=H,
                                        num_classes=C)
ADAPTER = modelspec.get_adapter("mlp", dim=D, hidden=H, num_classes=C)


def _fleet(seed=0):
    """Distinct per-worker weights: the JAX init plus seeded noise."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in jax_init(seed, W).items()}


def _batch(seed, *shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (D,)).astype(np.float32)
    y = rng.integers(0, C, shape).astype(np.int32)
    return x, y


def _flat(stacked):
    return ADAPTER.flatten(params_from_jax(stacked))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_params_round_trip():
    tree = jax_init(1, W)
    back = params_to_numpy(params_from_jax(tree))
    assert back.keys() == tree.keys()
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    single = jax.device_get(JAX_ADAPTER.init(jax.random.PRNGKey(2)))
    for k, v in params_to_numpy(params_from_jax(single)).items():
        np.testing.assert_array_equal(v, single[k])


def test_flat_layout_is_the_reference_layout():
    stacked = _fleet(3)
    np.testing.assert_array_equal(
        _flat(stacked).numpy(),
        np.asarray(jax_engine._flatten_workers(stacked)))
    ours = [(l.name, l.start, l.size, l.shape)
            for l in ADAPTER.leaf_offsets()]
    ref = [(l.name, l.start, l.size, l.shape)
           for l in JAX_ADAPTER.leaf_offsets()]
    assert ours == ref
    assert [n for n, *_ in ours] == ["b1", "b2", "b3", "w1", "w2", "w3"]
    assert ADAPTER.param_count == JAX_ADAPTER.param_count == 6922
    assert ADAPTER.model_bits == JAX_ADAPTER.model_bits
    back = ADAPTER.unflatten(_flat(stacked))
    for k, v in stacked.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("bad", ["transposed", "missing"])
def test_flatten_rejects_foreign_parameters(bad):
    stacked = params_from_jax(jax_init(0, W))
    if bad == "transposed":
        stacked["w1"] = stacked["w1"].transpose(1, 2)    # same size
    else:
        del stacked["b3"]
    with pytest.raises(ValueError):
        ADAPTER.flatten(stacked)


@pytest.mark.parametrize("batch", [(32,), (W, 16)],
                         ids=["per-worker", "eval-stack"])
def test_loss_and_accuracy(batch):
    """Per-worker loss on a [B] batch, and on the [W, N] eval stack every
    worker sees (the reference's broadcast gold-logit semantics)."""
    stacked = _fleet(4)
    x, y = _batch(5, W, *batch) if len(batch) == 1 else _batch(5, *batch)
    ref_loss, ref_acc = [], []
    for i in range(W):
        p = {k: v[i] for k, v in stacked.items()}
        xi, yi = (x[i], y[i]) if len(batch) == 1 else (x, y)
        ref_loss.append(JAX_ADAPTER.loss(p, {"x": xi, "y": yi}))
        ref_acc.append(JAX_ADAPTER.accuracy(p, xi, yi))
    views = ADAPTER.views(_flat(stacked))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    if len(batch) == 2:
        xt, yt = xt.expand(W, *xt.shape), yt.expand(W, *yt.shape)
    _close(ADAPTER.loss(views, xt, yt), ref_loss)
    if len(batch) == 1:
        np.testing.assert_array_equal(ADAPTER.accuracy(views, xt, yt),
                                      np.asarray(ref_acc))


def test_tau_masked_local_sgd():
    """Three masked SGD steps with taus 0..3 across workers: tau 0 leaves
    a worker's row exactly as it was."""
    stacked = _fleet(6)
    bx, by = _batch(7, W, 3, 32)
    taus = np.array([0, 1, 2, 3, 3, 1])
    ref = jax_engine._local_train(JAX_ADAPTER, stacked, bx, by,
                                  jnp.asarray(taus), jnp.float32(0.1), 3)
    flat = _flat(stacked)
    out = engine._local_train(ADAPTER, flat, torch.from_numpy(bx),
                              torch.from_numpy(by).long(),
                              torch.from_numpy(taus),
                              torch.tensor(0.1, dtype=torch.float32), 3)
    _close(out.numpy(), np.asarray(jax_engine._flatten_workers(ref)))
    np.testing.assert_array_equal(out[0].numpy(), flat[0].numpy())


def test_measurements_and_cross_loss():
    """Alg. 1 estimates (loss, L_i, sigma_i, update norm) on the eval
    stack, and PENS' cross-loss matrix."""
    prev, cur = _fleet(8), _fleet(9)
    ex, ey = _batch(10, W, 64)
    px, py = ex[:, :32], ey[:, :32]
    ref = jax_engine._measure(JAX_ADAPTER, cur, prev, ex, ey, px, py)
    ours = engine._measure(ADAPTER, _flat(cur), _flat(prev),
                           torch.from_numpy(ex), torch.from_numpy(ey).long(),
                           torch.from_numpy(px), torch.from_numpy(py).long())
    for a, b in zip(ours, (ref[0], ref[2], ref[3], ref[4])):
        _close(a.numpy(), np.asarray(b), tol=1e-5)
    cross = jax_engine._cross_loss_matrix(JAX_ADAPTER, cur, ex[:, :16],
                                          ey[:, :16])
    _close(engine._cross_loss_matrix(
        ADAPTER, _flat(cur), torch.from_numpy(ex[:, :16]),
        torch.from_numpy(ey[:, :16]).long()).numpy(), np.asarray(cross))


@pytest.mark.parametrize("alive", [None, [1, 1, 0, 1, 0, 1]])
def test_mean_accuracy_and_join_blend(alive):
    stacked = _fleet(11)
    tx, ty = _batch(12, 128)
    mask = None if alive is None else np.asarray(alive, bool)
    ref = jax_engine._mean_accuracy(JAX_ADAPTER, stacked, tx, ty, mask)
    ours = engine._mean_accuracy(ADAPTER, _flat(stacked),
                                 torch.from_numpy(tx),
                                 torch.from_numpy(ty).long(), mask)
    _close(ours, ref)
    joined = np.zeros(W, bool)
    joined[2] = True
    donors = np.ones(W, bool) & ~joined
    ref_j = jax_engine._reinit_joined(stacked, jnp.asarray(joined),
                                      jnp.asarray(donors))
    ours_j = engine._reinit_joined(_flat(stacked), torch.from_numpy(joined),
                                   torch.from_numpy(donors))
    _close(ours_j.numpy(), np.asarray(jax_engine._flatten_workers(ref_j)))
    np.testing.assert_array_equal(ours_j[0].numpy(), _flat(stacked)[0])
