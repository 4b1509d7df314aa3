"""Serving of the moe, hybrid, xlstm and encdec families, and the encdec
and vlm training losses, against the reference JAX package on the CPU,
from the reference's weights (``convert.params_from_jax``) at the smoke
configs in f32.

- ``registry.run_prefill``'s logits and every cache leaf, then 4
  ``decode_step``s fed the same tokens, logits and cache after each:
  olmoe-1b-7b (a decode step routes its B tokens with capacity
  ``capacity(B, E, k)``), zamba2-7b at 5 layers (two groups and a
  tail: Mamba2 states and contexts, the shared blocks' KV caches),
  xlstm-1.3b (a group and a tail: mLSTM ``C`` over the ones-augmented
  v, sLSTM c / n / h / m) and whisper-large-v3 (self and cross K / V). Elementwise ``|port - ref| <= 1e-5 + 1e-5 |ref|``;
  measured worst |diff|: logits 3.9e-6 / 6.9e-6 / 6.2e-6 / 1.9e-6,
  caches 2.3e-6 / 3.0e-5 (the Mamba2 state, whose entries reach 12) /
  4.8e-6 / 1.7e-6.
- whisper's keys: the reference's ``encdec.prefill`` caches the prompt's
  self-attention keys before RoPE while its decode steps rotate theirs
  (the port caches them rotated, ``models/encdec.py``). The port's cache
  is held to the reference's with RoPE applied, and the reference's
  decode steps run from that corrected cache; a test shows the fault:
  from its own cache the reference's first decode step is far from its
  teacher-forced forward, from the corrected one within 1e-5.
- whisper-large-v3's ``loss_fn`` and gradients
  (``_torch_serving.check_loss_and_grads``; qwen2-vl-2b's are in
  ``tests/test_torch_serve.py``): loss within 1e-5 relative (measured
  0), every gradient leaf within 1e-5 + 1e-4 |g| (measured worst |diff|
  1.0e-6, of gradients up to 1.4).
- ``batch_shapes`` / ``make_batch`` and ``make_decode_cache`` against
  the reference's shapes and dtypes, every family; ``get_adapter``
  still refuses encdec and vlm.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import (check_loss_and_grads, compiled, configs,
                            reference_fns,
                            rope_reference_keys, run_against_reference,
                            serving_batch, weights)
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import InputShape as JaxInputShape
from repro.models import registry as jax_registry
from repro_torch.configs import SHAPES, InputShape
from repro_torch.convert import _flat_items
from repro_torch.core import modelspec
from repro_torch.models import registry

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

ALL_ARCHS = ("smollm-360m", "gemma3-27b", "olmoe-1b-7b", "zamba2-7b",
             "xlstm-1.3b", "whisper-large-v3", "qwen2-vl-2b")


@pytest.mark.parametrize("arch,s,fields", [
    ("olmoe-1b-7b", 12, None),
    ("zamba2-7b", 12, dict(num_layers=5)),      # 2 groups and a tail
    ("xlstm-1.3b", 12, None),                   # a group and a tail
    ("whisper-large-v3", 4, None)])
def test_family_serving_matches_reference(arch, s, fields):
    run_against_reference(arch, b=2, s=s, steps=4, cap=s + 4, fields=fields)


def test_reference_encdec_prefill_keys_are_unrotated():
    """The reference's decode step from its own prefill cache disagrees
    with its teacher-forced decoder forward; from the cache with RoPE
    applied to the keys (what the port caches) it agrees."""
    jcfg, _ = configs("whisper-large-v3")
    jp, _ = weights(jcfg, 0)
    s = 4
    data = serving_batch(jcfg, np.random.default_rng(7), 2, s, 1)
    toks = jnp.asarray(data["tokens"])
    frames = jnp.asarray(data["frames"])
    pre, dec = reference_fns(jcfg, s + 4)
    _, cache = pre(jp, {"frames": frames, "tokens": toks[:, :s]})
    enc = jax_registry.get_model("encdec")
    h = compiled(lambda p: enc.decode_seq(jcfg, p, toks, enc.encode(
        jcfg, p, frames))[:, s] @ enc.head_matrix(jcfg, p), jp)(jp)
    want = np.asarray(h)
    gaps = [float(np.abs(np.asarray(dec(jp, c, toks[:, s:])[0]) - want)
                  .max()) for c in (cache, rope_reference_keys(cache))]
    assert gaps[0] > 1e-2 and gaps[1] < 1e-5, gaps


def test_encdec_loss_and_grads_match_reference():
    check_loss_and_grads("whisper-large-v3")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batches_and_decode_caches_match_reference_shapes(arch):
    jcfg, cfg = configs(arch)
    shape, jshape = SHAPES["decode_32k"], JAX_SHAPES["decode_32k"]
    want = jax_registry.batch_shapes(jcfg, jshape, batch_override=3)
    got = registry.batch_shapes(cfg, shape, batch_override=3)
    assert sorted(got) == sorted(want)
    batch = registry.make_batch(cfg, InputShape("s", 64, 3, "decode"),
                                torch.Generator().manual_seed(0))
    jbatch = jax.eval_shape(lambda: jax_registry.make_batch(
        jcfg, JaxInputShape("s", 64, 3, "decode"), jax.random.PRNGKey(0)))
    for name, (shp, dt) in got.items():
        assert tuple(want[name].shape) == shp
        assert str(want[name].dtype) == str(dt).removeprefix("torch.")
        assert batch[name].shape == (1,) + tuple(jbatch[name].shape)
        assert batch[name].dtype == dt
    ref_cache = jax.eval_shape(lambda: jax_registry.make_decode_cache(
        jcfg, 3, 64))
    cache = registry.make_decode_cache(cfg, 3, 64)
    ref_flat = dict(_flat_items(ref_cache))
    assert sorted(cache) == sorted(ref_flat)
    for name, v in cache.items():
        lead = () if name == "len" else (1,)          # the worker axis
        assert v.shape == lead + tuple(ref_flat[name].shape), name
        assert str(ref_flat[name].dtype) == str(v.dtype).removeprefix(
            "torch."), name
    for family in ("encdec", "vlm"):
        with pytest.raises(ValueError):
            modelspec.get_adapter(f"{family}:d=16")
