"""The port's MoE family (``repro_torch.models.moe``) against the
reference JAX package, on the reference's weights and seeded numpy
inputs:

- ``_moe_ffn_flat`` and ``apply_moe_ffn``, outputs, aux loss and
  gradients (through ``jax.grad``), without and with a shared expert,
  with ``moe_shard_groups=2`` (routing within each half of the tokens),
  and on tokens shifted off zero mean, whose routing is skewed enough
  that experts overflow their capacity and tokens are dropped (the test
  asserts the drop): held to 1e-5 of
  each array's largest magnitude (f32 sums in another order; the router's
  gradient reaches 700 at this size);
- the olmoe-1b-7b and kimi-k2-1t-a32b smoke configs' loss and every
  gradient leaf against ``jax.value_and_grad`` of the reference's
  ``loss_fn``, plain attention and the flash path (the reference's
  Pallas kernel in interpret mode at head width 128 for olmoe and 112
  for kimi-k2, the port's ``ops.flash_attention``, its plain version on
  the CPU, once a layer): the dense tolerances of
  ``tests/test_torch_registry.py``, loss 2e-4 and gradients 5e-3
  (measured: loss within 5e-7, gradients within 4e-6);
- the leaf-offset tables against the reference adapter's, name for name.
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
from repro.models import moe as jax_moe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import modelspec
from repro_torch.models import moe

# pytest-xdist runs one test file per worker (--dist loadfile): keep each
# on one core
torch.set_num_threads(1)

FFN_TOL = 1e-5


def _ffn_case(arch: str, shift: float, **fields):
    """The smoke config's MoE layer: reference params and cfgs, x [2, 32,
    d] from a numpy seed (plus ``shift``), and a cotangent for y."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **fields)
    tcfg = dataclasses.replace(get_smoke_config(arch), **fields)
    p = jax_moe.init_moe_ffn(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 32, jcfg.d_model)) + shift).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    return jcfg, tcfg, p, x, ct


def _port_ffn(fn, tcfg, p, x, ct):
    """The port's layer on one worker: (y, aux, grads of sum(y ct) + aux
    by leaf name, grad of x)."""
    params = {k: v[None].requires_grad_(True)
              for k, v in params_from_jax(p).items()}
    xt = torch.from_numpy(x)[None].requires_grad_(True)
    if fn == "flat":
        y, aux = moe._moe_ffn_flat(params, xt.reshape(1, 1, -1, x.shape[-1]),
                                   tcfg)
        y, aux = y.reshape(xt.shape), aux.reshape(1)
    else:
        y, aux = moe.apply_moe_ffn(params, xt, tcfg)
    out = (y * torch.from_numpy(ct)[None]).sum() + aux.sum()
    grads = torch.autograd.grad(out, [*params.values(), xt])
    return (y.detach()[0].numpy(), float(aux.detach()[0]),
            {k: g[0].numpy() for k, g in zip(params, grads)},
            grads[-1][0].numpy())


def _close(got, want, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_TOL * scale,
                               err_msg=name)


def _dropped(jcfg, p, x) -> int:
    """Assignments past capacity in the reference's routing of x, within
    each of its ``moe_shard_groups`` groups of tokens."""
    t = x.shape[0] * x.shape[1]
    groups = jcfg.moe_shard_groups
    groups = groups if groups and t % groups == 0 else 1
    tokens = x.reshape(groups, -1, x.shape[-1])
    c = jax_moe.capacity(tokens.shape[1], jcfg.num_experts,
                         jcfg.experts_per_token)
    out = 0
    for xg in tokens:
        probs = jax.nn.softmax(xg @ np.asarray(p["router"]), -1)
        _, eidx = jax.lax.top_k(probs, jcfg.experts_per_token)
        counts = np.bincount(np.asarray(eidx).ravel(),
                             minlength=jcfg.num_experts)
        out += int(np.maximum(counts - c, 0).sum())
    return out


@pytest.mark.parametrize("arch,fn,shift,fields", [
    ("olmoe-1b-7b", "flat", 0.0, {}),
    ("kimi-k2-1t-a32b", "flat", 0.0, {}),
    ("olmoe-1b-7b", "flat", 0.5, {}),
    ("kimi-k2-1t-a32b", "apply", 0.5, dict(moe_shard_groups=2)),
    ("olmoe-1b-7b", "apply", 0.0, dict(moe_shard_groups=2)),
    ("olmoe-1b-7b", "apply", 0.0, dict(moe_shard_groups=5))],
    ids=["olmoe", "kimi-shared", "olmoe-drops", "kimi-groups2-drops",
         "olmoe-groups2", "olmoe-groups5-flat"])
def test_moe_ffn_matches_reference(arch, fn, shift, fields):
    """Outputs, aux loss and gradients of the layer; on tokens shifted by
    0.5 the routing is skewed and tokens past an expert's capacity are
    dropped (asserted); 5 groups do not divide the 64 tokens, so both
    packages route them as one group."""
    jcfg, tcfg, p, x, ct = _ffn_case(arch, shift, **fields)
    if shift:
        assert _dropped(jcfg, p, x) > 0
    jfn = jax_moe._moe_ffn_flat if fn == "flat" else jax_moe.apply_moe_ffn

    def f(pp, xx):
        y, aux = jfn(pp, xx, jcfg)
        return (y * ct).sum() + aux, (y, aux)

    (_, (y_j, aux_j)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    y_t, aux_t, g_t, gx_t = _port_ffn(fn, tcfg, p, x, ct)
    _close(y_t, y_j)
    _close(aux_t, aux_j)
    _close(gx_t, g_x)
    for name, want in params_from_jax(g_p).items():
        _close(g_t[name], want.numpy(), name)


def test_moe_drops_in_stable_order():
    """Ties in the expert sort keep token order (``jnp.argsort`` is
    stable): with every token routed to the same experts, the first C
    tokens are kept and the rest come back as zeros (no shared expert)."""
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              num_experts=4, experts_per_token=1)
    t, d = 40, cfg.d_model
    c = moe.capacity(t, 4, 1)
    gen = torch.Generator().manual_seed(0)
    p = {k: v[None] for k, v in moe.init_moe_ffn(gen, cfg).items()}
    p["router"] = torch.zeros_like(p["router"])
    p["router"][0, :, 2] = 1.0             # every token prefers expert 2
    x = torch.rand(1, 1, t, d, generator=gen) + 0.5
    y, _ = moe._moe_ffn_flat(p, x, cfg)
    kept = y[0, 0].abs().sum(-1) > 0
    assert c < t and kept.tolist() == [True] * c + [False] * (t - c)


@pytest.mark.parametrize("arch,fields", [
    ("olmoe-1b-7b", {}), ("kimi-k2-1t-a32b", {}),
    ("olmoe-1b-7b", dict(d_model=256, num_heads=2, num_kv_heads=2,
                         use_flash_kernel=True)),
    ("kimi-k2-1t-a32b", dict(d_model=224, num_heads=2, num_kv_heads=1,
                             use_flash_kernel=True))],
    ids=["olmoe", "kimi", "olmoe-flash-hd128", "kimi-flash-hd112"])
def test_moe_loss_and_grads_match_reference(arch, fields):
    calls = assert_family_parity(arch, fields)
    cfg = dataclasses.replace(get_smoke_config(arch), **fields)
    assert calls == (cfg.num_layers if cfg.use_flash_kernel else 0)


@pytest.mark.parametrize("arch,fields", [
    ("olmoe-1b-7b", {}), ("kimi-k2-1t-a32b", {}),
    ("kimi-k2-1t-a32b", dict(num_layers=3, moe_d_ff=48,
                             num_shared_experts=2)),
    ("olmoe-1b-7b", dict(tie_embeddings=True, act="relu2"))],
    ids=["olmoe", "kimi", "kimi-3l-moe-dff", "olmoe-tied-relu2"])
def test_moe_leaf_offsets_match_reference(arch, fields):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **fields)
    tcfg = dataclasses.replace(get_smoke_config(arch), remat="none",
                               **fields)
    jad = jax_modelspec.RegistryAdapter(jcfg, 16, 8, "ref")
    tad = modelspec.RegistryAdapter(tcfg, 16, 8, "port")
    want = [(l.name, l.start, l.size, l.shape) for l in jad.leaf_offsets()]
    assert [(l.name, l.start, l.size, l.shape)
            for l in tad.leaf_offsets()] == want
    init = tad.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {name: shape for name, _, _, shape in want}
