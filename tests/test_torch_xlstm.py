"""The port's xLSTM family (``repro_torch.models.xlstm``, xlstm-1.3b)
against the reference JAX package, on the reference's weights and seeded
numpy inputs:

- ``apply_mlstm`` (through ``ssm.chunked_recurrence`` with the
  ones-column normaliser, in one chunk and in several) and
  ``apply_slstm`` (the token loop with its block-diagonal recurrence, the
  final state too, then the gated FFN) on two workers with their own
  weights, against the reference's per worker, gradients included: within
  1e-4 of each array's largest magnitude (f32 sums in another order);
- the mLSTM's unstabilised update gate exp(i): finite and equal at a
  large input gate, non-finite in both packages past f32 exp's range;
- the sLSTM stabiliser's tie rule: ``amax`` splits the gradient of tied
  maxima as the reference's ``max`` does;
- xlstm-1.3b's smoke config (one group of 2 mLSTM + 1 sLSTM blocks and
  an mLSTM tail), loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn``: loss 2e-4,
  gradients 5e-3 (measured: loss within 5e-7, gradients within 8e-5);
  with ``use_flash_kernel`` it is the same model (no attention, no flash
  call);
- the leaf-offset tables against the reference adapter's, with and
  without a tail and with no sLSTM groups.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_family_parity
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import modelspec as jax_modelspec
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import modelspec
from repro_torch.models import xlstm

# pytest-xdist runs one test file per worker (--dist loadfile): keep each
# on one core
torch.set_num_threads(1)

TOL = 1e-4


def _close(got, want, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * scale, err_msg=name)


def _two_workers(init, cfg):
    """The reference's block for two workers (keys 0 and 1, the second's
    biases moved), and the port's worker-stacked copy."""
    ps = [init(jax.random.PRNGKey(i), cfg, jnp.float32) for i in range(2)]
    ps[1] = {k: (v + 0.1 if k.startswith("b") else v)
             for k, v in ps[1].items()}
    flat = [params_from_jax(p) for p in ps]
    return ps, {k: torch.stack([f[k] for f in flat]).requires_grad_(True)
                for k in flat[0]}


@pytest.mark.parametrize("block,s,chunk", [
    ("mlstm", 15, 256), ("mlstm", 16, 4), ("slstm", 15, 0)],
    ids=["mlstm-one-chunk", "mlstm-four-chunks", "slstm"])
def test_xlstm_blocks_match_reference_per_worker(block, s, chunk):
    cfg_j = jax_smoke_config("xlstm-1.3b")
    cfg_t = get_smoke_config("xlstm-1.3b")
    init = (jax_xlstm.init_mlstm_block if block == "mlstm"
            else jax_xlstm.init_slstm_block)
    ps, stacked = _two_workers(init, cfg_j)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, s, cfg_j.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    if block == "mlstm":
        y_t = xlstm.apply_mlstm(stacked, xt, cfg_t, chunk=chunk)
        out = (y_t * torch.from_numpy(ct)).sum()
    else:
        y_t, st_t = xlstm.apply_slstm(stacked, xt, cfg_t)
        out = (y_t * torch.from_numpy(ct)).sum() + st_t["c"].sum()
    grads = torch.autograd.grad(out, [*stacked.values(), xt])

    def f(p, xx, cw):
        if block == "mlstm":
            y = jax_xlstm.apply_mlstm(p, xx, cfg_j, chunk=chunk)
            return (y * cw).sum(), (y, None)
        y, st = jax_xlstm.apply_slstm(p, xx, cfg_j)
        return (y * cw).sum() + st["c"].sum(), (y, st)

    ref = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    for w in range(2):
        (_, (y_j, st_j)), (g_p, g_x) = ref(ps[w], jnp.asarray(x[w]), ct[w])
        _close(y_t.detach()[w], y_j)
        if st_j is not None:
            for key in ("c", "n", "h", "m"):
                _close(st_t[key].detach()[w], st_j[key], key)
        _close(grads[-1][w], g_x)
        want = params_from_jax(g_p)
        for name, got in zip(stacked, grads):
            _close(got[w], want[name], name)


@pytest.mark.parametrize("gate_bias,finite", [(40.0, True), (100.0, False)],
                         ids=["large-gate", "gate-past-exp-range"])
def test_mlstm_input_gate_range_matches_reference(gate_bias, finite):
    """The mLSTM update gate is exp(i) with no stabiliser, in both
    packages: with every input-gate pre-activation near ``gate_bias``, a
    large gate stays finite and agrees, and gates all past f32 exp's range
    (88.7) make the block's output non-finite in the reference and the
    port alike. (Near the edge of the range, at 90, a few rows overflow
    in one package and not the other: the pre-activations' f32 sums
    differ in the last ulp.)"""
    cfg_j = jax_smoke_config("xlstm-1.3b")
    cfg_t = get_smoke_config("xlstm-1.3b")
    ps, stacked = _two_workers(jax_xlstm.init_mlstm_block, cfg_j)
    ps = [dict(p, b_igate=p["b_igate"] + gate_bias) for p in ps]
    with torch.no_grad():
        stacked["b_igate"] += gate_bias
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 15, cfg_j.d_model)).astype(np.float32)
    y_t = xlstm.apply_mlstm(stacked, torch.from_numpy(x), cfg_t).detach()
    for w in range(2):
        y_j = np.asarray(jax_xlstm.apply_mlstm(ps[w], jnp.asarray(x[w]),
                                               cfg_j))
        got = y_t[w].numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(y_j))
        assert np.isfinite(y_j).all() == finite
        if finite:
            _close(got, y_j)


def test_slstm_stabiliser_splits_tied_gradients():
    """Two tied maxima of i_t share the stabiliser's gradient, in both
    packages (``torch.amax`` and the reference's ``max``)."""
    i_t = np.array([[1.0, 3.0, 3.0, 0.5]], np.float32)
    want = jax.grad(lambda a: jnp.sum(a.max(axis=-1) * 2.0))(jnp.asarray(i_t))
    t = torch.from_numpy(i_t).requires_grad_(True)
    (got,) = torch.autograd.grad((torch.amax(t, dim=-1) * 2.0).sum(), t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[0.0, 1.0, 1.0, 0.0]])


@pytest.mark.parametrize("fields", [{}, dict(use_flash_kernel=True)],
                         ids=["plain", "flash-flag"])
def test_xlstm_loss_and_grads_match_reference(fields):
    assert assert_family_parity("xlstm-1.3b", fields) == 0


@pytest.mark.parametrize("fields", [
    {}, dict(num_layers=6), dict(num_layers=2, slstm_every=0),
    dict(tie_embeddings=True, num_heads=4)],
    ids=["group-tail", "two-groups", "mlstm-only", "tied-4-heads"])
def test_xlstm_leaf_offsets_match_reference(fields):
    jcfg = dataclasses.replace(jax_smoke_config("xlstm-1.3b"), **fields)
    tcfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), remat="none",
                               **fields)
    jad = jax_modelspec.RegistryAdapter(jcfg, 16, 8, "ref")
    tad = modelspec.RegistryAdapter(tcfg, 16, 8, "port")
    want = [(l.name, l.start, l.size, l.shape) for l in jad.leaf_offsets()]
    assert [(l.name, l.start, l.size, l.shape)
            for l in tad.leaf_offsets()] == want
    init = tad.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {name: shape for name, _, _, shape in want}
