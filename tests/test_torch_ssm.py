"""The port's Mamba2 / SSD layer (``repro_torch.models.ssm``) and the
hybrid family (``models/hybrid.py``, zamba2-7b) against the reference JAX
package, on the reference's weights and seeded numpy inputs:

- ``chunked_recurrence`` with b / c shared by the heads (mamba2) and per
  head (mLSTM), in one chunk and in several (a chunk length that S does
  not divide is halved, the reference's rule), with a ``state0``: y and
  the final state against the reference's within 1e-4 of each array's
  largest magnitude (f32 sums in another order: a d_skip gradient sums
  2,880 terms and moves 2.5e-5), its gradients too; and
  ``final=False`` bit-equal to the full computation;
- ``ssd_chunked`` against the port's own sequential oracle ``ssd_ref``
  and against the reference's ``ssd_chunked``;
- ``apply_mamba2`` on two workers with their own weights, against the
  reference's per worker, with gradients;
- zamba2-7b's smoke config, loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, plain attention
  and the flash path at head width 112 (the reference's Pallas kernel in
  interpret mode; the port's ``ops.flash_attention`` once a group):
  loss 2e-4, gradients 5e-3 (measured: loss within 5e-7, gradients
  within 3e-5); with one group the second shared block's gradient is
  exactly zero in both;
- the leaf-offset tables against the reference adapter's, with groups,
  a tail and no groups at all.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_family_parity, family_loss_and_grads
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import modelspec as jax_modelspec
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import modelspec
from repro_torch.models import ssm

# pytest-xdist runs one test file per worker (--dist loadfile): keep each
# on one core
torch.set_num_threads(1)

TOL = 1e-4


def _close(got, want, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * scale, err_msg=name)


def _recurrence_inputs(per_head: bool, s: int, seed: int = 0):
    """xh [2, s, 3, 4], gate > 0, log_decay < 0, b and c of width 5."""
    rng = np.random.default_rng(seed)
    bsz, h, p, n = 2, 3, 4, 5
    bshape = (bsz, s, h, n) if per_head else (bsz, s, n)
    return [rng.normal(size=(bsz, s, h, p)).astype(np.float32),
            rng.uniform(0.1, 1.0, (bsz, s, h)).astype(np.float32),
            -rng.uniform(0.01, 0.5, (bsz, s, h)).astype(np.float32),
            rng.normal(size=bshape).astype(np.float32),
            rng.normal(size=bshape).astype(np.float32),
            rng.normal(size=(bsz, h, n, p)).astype(np.float32)]


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "head"])
@pytest.mark.parametrize("s,chunk,with_state0", [
    (15, 256, False), (32, 8, False), (24, 16, True)],
    ids=["one-chunk", "four-chunks", "halved-chunk-state0"])
def test_chunked_recurrence_matches_reference(per_head, s, chunk,
                                              with_state0):
    xh, gate, dec, b, c, st0 = _recurrence_inputs(per_head, s)
    st0 = st0 if with_state0 else None
    ct = np.random.default_rng(1).normal(size=xh.shape).astype(np.float32)

    def f(*args):
        y, final = jax_ssm.chunked_recurrence(*args[:5], chunk=chunk,
                                              state0=args[5])
        return (y * ct).sum() + final.sum(), (y, final)

    jargs = [jnp.asarray(a) for a in (xh, gate, dec, b, c)] + \
        [None if st0 is None else jnp.asarray(st0)]
    (_, (y_j, fin_j)), g_j = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (xh, gate, dec, b, c)]
    t0 = None if st0 is None else torch.from_numpy(st0)
    y_t, fin_t = ssm.chunked_recurrence(*targs, chunk=chunk, state0=t0)
    g_t = torch.autograd.grad((y_t * torch.from_numpy(ct)).sum()
                              + fin_t.sum(), targs)
    _close(y_t.detach(), y_j)
    _close(fin_t.detach(), fin_j)
    for name, a, b_ in zip(("xh", "gate", "log_decay", "b", "c"), g_t, g_j):
        _close(a, b_, name)
    # without the final state: the same y, bit for bit
    y_nf, fin_nf = ssm.chunked_recurrence(
        *(a.detach() for a in targs), chunk=chunk, state0=t0, final=False)
    assert fin_nf is None and torch.equal(y_nf, y_t.detach())


@pytest.mark.parametrize("s,chunk", [(15, 256), (32, 8)])
def test_ssd_chunked_matches_oracles(s, chunk):
    """The port's chunked SSD against its sequential oracle (both final
    states too) and against the reference's chunked SSD."""
    xh, dt, _, b, c, _ = _recurrence_inputs(False, s, seed=2)
    a_log = np.log(np.arange(1, 4, dtype=np.float32))
    y_j, fin_j = jax_ssm.ssd_chunked(*map(jnp.asarray, (xh, dt, a_log, b, c)),
                                     chunk=chunk)
    tx = [torch.from_numpy(a) for a in (xh, dt, a_log, b, c)]
    y_t, fin_t = ssm.ssd_chunked(*tx, chunk=chunk)
    y_r, fin_r = ssm.ssd_ref(*tx)
    _close(y_t, y_j)
    _close(fin_t, fin_j)
    _close(y_t, y_r)
    _close(fin_t, fin_r)
    # each sequence its own decay rates: a_log [B, H] rows
    rows = torch.stack([tx[2], 2 * tx[2]])
    y_rows, _ = ssm.ssd_chunked(tx[0], tx[1], rows, tx[3], tx[4],
                                chunk=chunk)
    for i in range(2):
        y_i, _ = ssm.ssd_ref(tx[0][i:i + 1], tx[1][i:i + 1], rows[i],
                             tx[3][i:i + 1], tx[4][i:i + 1])
        _close(y_rows[i:i + 1], y_i)


def test_apply_mamba2_matches_reference_per_worker():
    """Two workers with their own Mamba2 weights on their own tokens."""
    d, n = 32, 8
    ps = [jax_ssm.init_mamba2(jax.random.PRNGKey(i), d, n, jnp.float32)
          for i in range(2)]
    ps = [dict(p, dt_bias=p["dt_bias"] + 0.1 * i,
               conv_b=p["conv_b"] + 0.05) for i, p in enumerate(ps)]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 15, d)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    stacked = {k: torch.stack([params_from_jax(p)[k] for p in ps])
               .requires_grad_(True) for k in params_from_jax(ps[0])}
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = ssm.apply_mamba2(stacked, xt, n)
    grads = torch.autograd.grad((y_t * torch.from_numpy(ct)).sum(),
                                [*stacked.values(), xt])

    def f(p, xx, cw):
        y = jax_ssm.apply_mamba2(p, xx, n)
        return (y * cw).sum(), y

    ref = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    for w in range(2):
        (_, y_j), (g_p, g_x) = ref(ps[w], jnp.asarray(x[w]), ct[w])
        _close(y_t.detach()[w], y_j)
        _close(grads[-1][w], g_x)
        want = params_from_jax(g_p)
        for name, got in zip(stacked, grads):
            _close(got[w], want[name], name)


@pytest.mark.parametrize("fields", [
    {}, dict(d_model=224, num_heads=2, num_kv_heads=2, use_flash_kernel=True)],
    ids=["plain", "flash-hd112"])
def test_zamba2_loss_and_grads_match_reference(fields):
    calls = assert_family_parity("zamba2-7b", fields)
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"), **fields)
    groups = cfg.num_layers // cfg.ssm_every
    assert calls == (groups if cfg.use_flash_kernel else 0)


def test_zamba2_one_group_leaves_shared_block_b_untouched():
    """One group runs shared block A only: block B is still a leaf (it
    gossips and counts in P) and its gradient is exactly zero in both
    packages; a tail block follows the group."""
    _, _, grads, _ = family_loss_and_grads(
        "zamba2-7b", dict(num_layers=3))
    touched = 0
    for name, (want, got) in grads.items():
        _close(got, want, name)
        if name.startswith("shared/"):
            assert not want[1].any() and not got[1].any(), name
            touched += bool(got[0].any())
    assert touched


@pytest.mark.parametrize("fields", [
    {}, dict(num_layers=5), dict(num_layers=3, ssm_every=0),
    dict(tie_embeddings=True, act="relu2", ssm_state=8)],
    ids=["groups", "groups-tail", "tail-only", "tied-relu2"])
def test_hybrid_leaf_offsets_match_reference(fields):
    jcfg = dataclasses.replace(jax_smoke_config("zamba2-7b"), **fields)
    tcfg = dataclasses.replace(get_smoke_config("zamba2-7b"), remat="none",
                               **fields)
    jad = jax_modelspec.RegistryAdapter(jcfg, 16, 8, "ref")
    tad = modelspec.RegistryAdapter(tcfg, 16, 8, "port")
    want = [(l.name, l.start, l.size, l.shape) for l in jad.leaf_offsets()]
    assert [(l.name, l.start, l.size, l.shape)
            for l in tad.leaf_offsets()] == want
    init = tad.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {name: shape for name, _, _, shape in want}
