"""Activation checkpointing in the port (``models/layers.remat``): a memory
policy that leaves every number as it is. Each family's smoke config
(dense, moe, hybrid, xlstm; bf16 leaves, the flash path's plain version
at head width 64 where the family attends) computes the same loss and
gradients, bit for bit on the CPU, under ``remat`` "none", "dots",
"block" and "full"; the engines train the same fleet bit for bit under
"block" and "none"; the models run the reference's wrap points (every
block under the policy: a layer's forward runs again in the backward
pass, the flash path's attention too); an unknown policy or dtype raises
``ValueError``; and every ported architecture's published config (bf16
leaves, remat "block") builds an adapter at its published widths (depth
and vocabulary cut: the reference's parameter count and leaf dtypes,
from ``jax.eval_shape``) and computes a finite loss and gradient at
smoke widths with the published dtype and policy.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_parity import TINY_LM, port_config
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import engine, fused, modelspec
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.experiment import setup_experiment
from repro_torch.core.topology import make_base_topology
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import registry

torch.set_num_threads(1)

ARCHS = ("smollm-360m", "olmoe-1b-7b", "zamba2-7b", "xlstm-1.3b")
POLICIES = ("none", "dots", "block", "full")


def _loss_and_grads(cfg, seed: int = 0):
    adapter = modelspec.RegistryAdapter(cfg, 16, 8, f"remat-{cfg.remat}")
    params = adapter.init(torch.Generator().manual_seed(seed))
    flat = adapter.flatten({k: v[None].expand(2, *v.shape)
                            for k, v in params.items()})
    flat = flat.detach().requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 3, 16)))
    loss = adapter.loss(adapter.views(flat), tokens, None)
    (g,) = torch.autograd.grad(loss.sum(), flat)
    return loss.detach(), g


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_are_bit_equal(arch):
    """Loss [W] and the [W, P] gradient under each policy equal "none"'s
    bit for bit (bf16 leaves; the flash path on for the attention
    families, its plain version on the CPU)."""
    flash = dict(use_flash_kernel=True, head_dim=64) \
        if arch != "xlstm-1.3b" else {}
    base = replace(get_smoke_config(arch), dtype="bfloat16", **flash)
    want = _loss_and_grads(replace(base, remat="none"))
    for policy in POLICIES[1:]:
        got = _loss_and_grads(replace(base, remat=policy))
        assert torch.equal(got[0], want[0]), policy
        assert torch.equal(got[1], want[1]), policy
        assert bool(torch.isfinite(got[1]).all())


def test_block_recomputes_each_layer_in_the_backward_pass(monkeypatch):
    """Under "block" each attention layer's forward runs twice in a
    gradient pass (the backward recomputes the block), once under
    "none" and once without a gradient."""
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    base = replace(get_smoke_config("smollm-360m"), dtype="bfloat16",
                   use_flash_kernel=True, head_dim=64)
    for policy, want in (("none", 1), ("block", 2), ("dots", 2)):
        calls.clear()
        _loss_and_grads(replace(base, remat=policy))
        assert len(calls) == want * base.num_layers, policy
    calls.clear()
    adapter = modelspec.RegistryAdapter(replace(base, remat="block"), 16, 8,
                                        "nograd")
    params = {k: v[None] for k, v in
              adapter.init(torch.Generator().manual_seed(0)).items()}
    with torch.no_grad():
        adapter.loss(params, torch.zeros(1, 2, 16, dtype=torch.long), None)
    assert len(calls) == base.num_layers


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
def test_engine_run_is_the_same_under_block(engine_name):
    """D-PSGD on a bf16 TINY_LM for 2 rounds: under "block" the records
    and the final parameters equal "none"'s exactly."""
    tiny = modelspec.get_adapter(TINY_LM)
    cfg = port_config(model=TINY_LM, algorithm="dpsgd", tau_init=2,
                      tau_max=2, num_workers=4)
    hists = []
    for policy in ("none", "block"):
        adapter = modelspec.RegistryAdapter(
            replace(tiny.cfg, dtype="bfloat16", remat=policy),
            tiny.seq_len, tiny.num_classes, f"tiny-{policy}")
        train, tx, ty, shards, cluster = setup_experiment(
            cfg, rounds=2, device="cpu", non_iid_p=0.4, spread=3.0)
        strategy = make_strategy(cfg, make_base_topology(
            cfg.num_workers, cfg.base_topology, cfg.seed))
        run = {"reference": engine.run_dfl,
               "fused": fused.run_dfl_fused}[engine_name]
        hists.append(run(train, tx, ty, shards, cluster, cfg, strategy,
                         rounds=2, adapter=adapter, device="cpu"))
    a, b = (h.as_arrays() for h in hists)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in hists[0].final_params.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, hists[1].final_params[k]), k


def test_unknown_policies_and_dtypes_raise():
    cfg = get_smoke_config("smollm-360m")
    for bad in (dict(remat="sometimes"), dict(dtype="float64"),
                dict(dtype="int8")):
        with pytest.raises(ValueError, match="unknown"):
            L.check_trainable(replace(cfg, **bad))
        with pytest.raises(ValueError, match="unknown"):
            modelspec.RegistryAdapter(replace(cfg, **bad), 16, 8, "bad")
    for policy in POLICIES:
        for dtype in ("float32", "bfloat16", "float16"):
            L.check_trainable(replace(cfg, remat=policy, dtype=dtype))
    dtypes = registry.leaf_dtypes(replace(get_smoke_config("zamba2-7b"),
                                          dtype="bfloat16"))
    assert dtypes["mamba/mamba/a_log"] == torch.float32
    assert dtypes["mamba/mamba/in_proj"] == torch.bfloat16


# the architectures the DFL engines train (encdec and vlm serve only)
TRAINED_ARCHS = [a for a in ARCH_IDS
                 if get_config(a).family in modelspec.DFL_FAMILIES]


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_published_configs_run_as_published(arch):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import registry as jax_registry
    published = get_config(arch)
    assert (published.dtype, published.remat) == ("bfloat16", "block")
    cut = dict(num_layers=2, vocab_size=512)
    adapter = modelspec.RegistryAdapter(replace(published, **cut), 16, 8,
                                        f"{arch}-published")
    shapes = jax.eval_shape(lambda: jax_registry.init_params(
        replace(jax_config(arch), **cut), jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = {"/".join(str(getattr(p, "key", p)) for p in path):
            str(leaf.dtype) for path, leaf in leaves}
    assert {l.name: l.dtype for l in adapter.leaf_offsets()} == want
    assert adapter.param_count == sum(
        int(np.prod(leaf.shape)) for _, leaf in leaves)
    small = replace(get_smoke_config(arch), dtype=published.dtype,
                    remat=published.remat)
    loss, g = _loss_and_grads(small)
    assert bool(torch.isfinite(loss).all()) and bool(
        torch.isfinite(g).all())
