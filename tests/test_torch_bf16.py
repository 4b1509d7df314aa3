"""The port in bf16 against the reference in bf16, on the CPU: the flash
kernel's function, the attention composition and each registry family's
loss and gradients at the smoke configs with ``dtype="bfloat16"``.

- ``ref.flash_attention_ref`` on bf16 operands (upcast, the f32
  composition, one rounding: what the bf16 kernel instances compute)
  against the reference's Pallas kernel in interpret mode on the same
  bf16 operands (S <= 128), within the reference's own bf16 tolerance
  (2e-2, ``tests/test_kernels.py``); and ``ops.flash_attention`` on bf16
  CPU tensors against the reference's ``ops.flash_attention``.
- ``ref.gqa_attention`` in bf16 (f32 scores, weights rounded to bf16
  before the value product) against the reference's
  ``gqa_attention_ref``, forward and gradients (2e-2, bf16's 8 bits).
- Each family's loss (within 2e-2 relative; measured worst 5.8e-3,
  olmoe) and gradients, two-sided. bf16 gradients of these models
  scatter by about 1-7% (global relative norm) around the f32 gradient
  of the same bf16 weights (the port's f32 run, which matches the
  reference's within 4e-6 here and in ``tests/test_torch_registry.py``
  and the family files), in each package in its own way: XLA on the CPU
  keeps f32 through fused elementwise chains, torch rounds each op. So:
  the port's bf16 gradient is at least one bf16 ulp (2^-8, relative)
  from that f32 gradient, as a run that computed in f32 would not be
  (~1e-6); no farther from it than the reference's own bf16 gradient,
  plus 2e-2; and within ``GRAD_GAP`` of the reference's bf16 gradient,
  about 1.5x the measured gap (dense 0.0134, moe 0.0151, hybrid 0.0553,
  xlstm 0.0357).
- MoE is held against the reference evaluated one operation at a time
  (no jit, the layer scans unrolled, remat "none"). Under jit, XLA's
  fused norm chain resolves a near tie of the router differently: in the
  second layer, token 8's second and third experts' weights are 0.148814
  and 0.148827, and the jitted reference sends it to the third, which
  also changes which of expert 0's 24 assignments its capacity of 19
  keeps. Two rows of that layer's output change whole, and the jitted
  gradient moves 27% from the f32 one (loss 5.7577 against 5.7918). Op
  by op, the reference routes as the f32 run and the port do (loss
  5.7915, port 5.7910; gradient 0.0214 from the f32 one, the port's
  0.0208).

The engines in bf16 are in ``tests/test_torch_bf16_engine.py``.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_fwd
from repro.models import layers as jax_layers
from repro.models import registry as jax_registry
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import modelspec
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

BF16_TOL = 2e-2
LOSS_RTOL = 2e-2
GRAD_SLACK = 2e-2
# one bf16 ulp, relative: the least distance of a bf16 gradient from
# the f32 gradient of the same weights
BF16_FLOOR = 2.0 ** -8
# the port's bf16 gradient against the reference's (global relative
# norm), about 1.5x the measured gap
GRAD_GAP = {"smollm-360m": 0.02, "olmoe-1b-7b": 0.023, "zamba2-7b": 0.083,
            "xlstm-1.3b": 0.054}
# the families held against the reference evaluated op by op
OP_BY_OP = ("olmoe-1b-7b",)


def _qkv(seed, b, s, hq, hkv, hd, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return tuple(jnp.asarray(rng.normal(size=shape).astype(np.float32))
                 .astype(jnp.bfloat16)
                 for shape in ((b, s, hq, hd), (b, sk, hkv, hd),
                               (b, sk, hkv, hd)))


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))) \
        .to(torch.bfloat16)


@pytest.mark.parametrize("hd,causal,window", [(64, True, 0), (64, True, 32),
                                              (64, False, 0),
                                              (112, True, 0),
                                              (128, True, 0)])
def test_flash_plain_bf16_matches_pallas_kernel(hd, causal, window):
    q, k, v = _qkv(hd + window, 2, 128, 4, 2, hd)
    tr = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    want = flash_attention_fwd(tr(q), tr(k), tr(v), causal=causal,
                               window=window, block_q=128, block_k=128,
                               interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(tr(want).astype(jnp.float32))
    got = ref.flash_attention_ref(_torch(q), _torch(k), _torch(v),
                                  causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("s,causal,window", [(15, True, 0), (100, True, 30),
                                             (100, False, 0)])
def test_flash_entry_point_bf16_matches_reference_ops(s, causal, window):
    """Both packages' entry points on bf16 operands, ragged S (the
    reference pads to 128 and forces the causal mask)."""
    q, k, v = _qkv(s, 2, s, 6, 2, 64)
    want = jax_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   interpret=True)
    assert want.dtype == jnp.bfloat16
    got = ops.flash_attention(_torch(q), _torch(k), _torch(v),
                              causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_gqa_attention_bf16_matches_reference(masked):
    """Forward and the gradients of sum(o * w) for a fixed f32 w."""
    q, k, v = _qkv(7, 2, 24, 4, 2, 16)
    mask = jax_layers.gqa_scores_mask(24, 24, causal=True, window=0) \
        if masked else None
    w = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)

    def jf(qq, kk, vv):
        o = jax_layers.gqa_attention_ref(qq, kk, vv, mask)
        return jnp.sum(o.astype(jnp.float32) * w), o
    (_, o_j), g_j = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    assert o_j.dtype == jnp.bfloat16
    tq, tk, tv = (_torch(a).requires_grad_(True) for a in (q, k, v))
    tmask = torch.from_numpy(np.array(mask)) if masked else None
    o_t = ref.gqa_attention(tq, tk, tv, tmask)
    assert o_t.dtype == torch.bfloat16
    (o_t.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o_t.detach().float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), g_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=BF16_TOL, rtol=BF16_TOL)


def _family_runs(arch: str, seed: int = 0):
    """The reference's bf16 loss and gradients from one set of bf16
    weights (jitted, and for ``OP_BY_OP`` also op by op), and the port's
    in bf16 and in f32 (on the weights upcast, exactly) from the same
    weights; gradients flat per leaf, f32."""
    jb = replace(jax_smoke_config(arch), dtype="bfloat16")
    p = jax_registry.init_params(jb, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, jb.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :-1]),
             "labels": jnp.asarray(tokens[:, 1:])}

    def jrun(cfg, params):
        loss, g = jax.jit(jax.value_and_grad(
            lambda q: jax_registry.loss_fn(cfg, q, batch)[0]))(params)
        return float(loss), {k: v.float().numpy() for k, v in
                             params_from_jax(g).items()}

    runs = {"ref-bf16": jrun(jb, p)}
    if arch in OP_BY_OP:
        with jax_layers.scan_unroll(True):
            loss, g = jax.value_and_grad(lambda q: jax_registry.loss_fn(
                replace(jb, remat="none"), q, batch)[0])(p)
        runs["ref-bf16-op-by-op"] = (float(loss), {
            k: v.float().numpy() for k, v in params_from_jax(g).items()})
    init = params_from_jax(p)
    assert {str(v.dtype) for k, v in init.items()} <= \
        {"torch.bfloat16", "torch.float32"}
    for dtype in ("bfloat16", "float32"):
        cfg = replace(get_smoke_config(arch), dtype=dtype, remat="none")
        adapter = modelspec.RegistryAdapter(cfg, 16, 8, dtype)
        flat = adapter.flatten({k: v[None] for k, v in init.items()})
        flat.requires_grad_(True)
        loss = adapter.loss(adapter.views(flat),
                            torch.from_numpy(tokens[None]), None)
        (g,) = torch.autograd.grad(loss.sum(), flat)
        runs[f"port-{dtype}"] = (float(loss[0].detach()), {
            k: v[0].float().numpy()
            for k, v in adapter.unflatten(g).items()})
    return runs


def _gap(g: dict, truth: dict) -> float:
    num = sum(float(np.sum((g[k] - truth[k]) ** 2)) for k in truth)
    den = sum(float(np.sum(truth[k] ** 2)) for k in truth)
    return (num / den) ** 0.5


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_family_bf16_loss_and_grads_match_reference(arch):
    runs = _family_runs(arch)
    loss_j, g_j = runs["ref-bf16"]
    loss_t, g_t = runs["port-bfloat16"]
    _, truth = runs["port-float32"]
    assert sorted(g_t) == sorted(truth)
    np.testing.assert_allclose(loss_t, loss_j, rtol=LOSS_RTOL)
    gap_t, gap_j = _gap(g_t, truth), _gap(g_j, truth)
    loss_h, g_h = runs.get("ref-bf16-op-by-op", runs["ref-bf16"])
    np.testing.assert_allclose(loss_t, loss_h, rtol=LOSS_RTOL)
    gap_h = _gap(g_t, g_h)
    print(arch, "loss", loss_t, loss_j, loss_h, "from f32: port", gap_t,
          "ref", gap_j, "port from ref", gap_h)
    assert BF16_FLOOR <= gap_t <= gap_j + GRAD_SLACK
    assert gap_h <= GRAD_GAP[arch]


def test_bf16_ulp_is_the_spacing_of_bf16_values():
    """``ref.bf16_ulp`` (the bf16 flash instances' tolerance) is the
    distance from each bf16 value to the next one away from 0."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=4096) * np.exp2(
        rng.integers(-60, 60, size=4096))).astype(np.float32)).bfloat16()
    x = x[x != 0]
    nxt = (x.abs().view(torch.int16) + 1).view(torch.bfloat16)
    assert torch.equal(nxt.float() - x.abs().float(), ref.bf16_ulp(x))
