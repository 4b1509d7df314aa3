"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``): SGD, momentum SGD (plain and Nesterov) and AdamW (with
and without weight decay, at a constant and a decaying learning rate)
over 20 steps on the same parameters and gradients, in f32 and with bf16
parameters; ``exponential_decay``; ``apply_updates`` and
``global_norm``; and the reference's convergence case
(``tests/test_substrate.py``: a quadratic, 120 steps).

Bounds: f32 within 1e-6 relative (1e-7 absolute, for the entries the
updates drive to 0; measured worst 8.5e-8 relative); with bf16
parameters the updates are rounded to bf16 each step in both packages,
so the parameters may part by one bf16 ulp where an f32 update's last
bit rounds apart, held to 2**-7 relative (measured: bit-equal).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.optim.optimizers import global_norm as jax_global_norm
from repro_torch import optim

torch.set_num_threads(1)

STEPS = 20
F32_RTOL, F32_ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -7

MAKERS = {
    "sgd": lambda o, lr: o.sgd(lr),
    "momentum": lambda o, lr: o.momentum_sgd(lr, 0.9),
    "nesterov": lambda o, lr: o.momentum_sgd(lr, 0.9, nesterov=True),
    "adamw": lambda o, lr: o.adamw(lr),
    "adamw-decay": lambda o, lr: o.adamw(lr, weight_decay=0.01),
}


def _problem(seed: int):
    """Nested parameters and STEPS gradients, numpy f32."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "blk": {"b": rng.normal(size=(5,)).astype(np.float32),
                      "g": rng.normal(size=(3, 2, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape)
                          .astype(np.float32), params)
             for _ in range(STEPS)]
    return params, grads


def _to_torch(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                        tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["constant", "decay"])
@pytest.mark.parametrize("maker", list(MAKERS))
def test_optimizer_matches_reference(maker, schedule, dtype):
    params, grads = _problem(len(maker) + len(schedule))
    lr_j = 0.05 if schedule == "constant" else \
        jax_optim.exponential_decay(0.05, 0.9)
    lr_t = 0.05 if schedule == "constant" else \
        optim.exponential_decay(0.05, 0.9)
    opt_j, opt_t = MAKERS[maker](jax_optim, lr_j), MAKERS[maker](optim, lr_t)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    pt = _to_torch(params, tdt)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for g in grads:
        gj = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        uj, sj = opt_j.update(gj, sj, pj)
        pj = jax_apply_updates(pj, uj)
        ut, st = opt_t.update(_to_torch(g, tdt), st, pt)
        pt = optim.apply_updates(pt, ut)
    assert int(st["step"]) == int(sj["step"]) == STEPS
    flat_t = {k: v for k, v in _leaves(pt)}
    for name, want in _leaves(pj):
        got = flat_t[name]
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                                       atol=F32_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=BF16_RTOL, atol=0,
                                       err_msg=name)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_exponential_decay_matches_reference():
    s_j, s_t = (o.exponential_decay(0.1, 0.98, 3)
                for o in (jax_optim, optim))
    for step in (0, 1, 2, 10, 99, 1000):
        got = float(s_t(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, float(s_j(jnp.asarray(step))),
                                   rtol=F32_RTOL)
    assert np.isclose(float(optim.exponential_decay(0.1, 0.98)(
        torch.tensor(10))), 0.1 * 0.98 ** 10)


def test_apply_updates_and_global_norm_match_reference():
    params, grads = _problem(3)
    pt, gt = _to_torch(params, torch.bfloat16), _to_torch(grads[0],
                                                         torch.float32)
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                      params)
    out_t = optim.apply_updates(pt, gt)
    out_j = jax_apply_updates(pj, jax.tree.map(jnp.asarray, grads[0]))
    for (name, want), (_, got) in zip(_leaves(out_j), _leaves(out_t)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)),
                                      err_msg=name)
    np.testing.assert_allclose(
        float(optim.global_norm(gt)),
        float(jax_global_norm(jax.tree.map(jnp.asarray, grads[0]))),
        rtol=F32_RTOL)


@pytest.mark.parametrize("maker", ["sgd", "momentum", "adamw"])
def test_optimizers_converge(maker):
    """The reference's case: 120 steps on sum((w - target)^2) from 0 end
    below 1e-2."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = {"sgd": lambda: optim.sgd(0.1),
           "momentum": lambda: optim.momentum_sgd(0.05, 0.9),
           "adamw": lambda: optim.adamw(0.2)}[maker]()
    state = opt.init(params)
    for _ in range(120):
        g = {"w": 2.0 * (params["w"] - target)}
        upd, state = opt.update(g, state, params)
        params = optim.apply_updates(params, upd)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2
