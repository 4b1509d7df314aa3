"""The port's registry slice against the reference JAX package, module by
module, on seeded numpy inputs:

- ``make_token_data``: bit-exact;
- the leaf-offset tables of the dense smoke configs (with and without
  gemma3's local/global groups, a tail, tied embeddings): the sorted
  ``"/"``-joined names are the reference's ``jax.tree`` order, with the
  same offsets and shapes; the canonical spec strings agree;
- ``convert`` round trips, one worker and worker-stacked;
- ``dense.loss_fn``'s loss and gradients from the reference's weights,
  the reference with ``use_flash_kernel=True`` (its Pallas kernel in
  interpret mode) at ``tests/test_flash_integration.py``'s sizes (d 128,
  head_dim 64, S 128), the port through ``ops.flash_attention`` (its
  plain version on the CPU) — that file's tolerances: loss 2e-4,
  gradients 5e-3;
- ``ref.flash_attention_ref`` against the Pallas ``flash_attention_fwd``
  in interpret mode and against the reference's ``ops.flash_attention``
  (ragged S = 100, where the reference pads and forces the causal mask),
  at the reference's flash tolerance 2e-5;
- ``ref.consensus_dist_ref`` against the reference's
  ``ops.consensus_dist`` in interpret mode, 1e-6 relative.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import modelspec as jax_modelspec
from repro.data import synthetic as jax_synthetic
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_fwd
from repro.models import registry as jax_registry
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import modelspec
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.models import dense, registry

# the driver runs one test file per xdist worker: keep each on one core
torch.set_num_threads(1)

DENSE_ARCHS = ("smollm-360m", "internlm2-20b", "gemma3-27b",
               "nemotron-4-340b")
FLASH_TOL = 2e-5


@pytest.mark.parametrize("n,s,v,classes,seed", [(64, 16, 64, 8, 0),
                                                (50, 9, 257, 3, 4)])
def test_make_token_data_bit_exact(n, s, v, classes, seed):
    a = jax_synthetic.make_token_data(n, s, v, num_classes=classes,
                                      seed=seed)
    b = synthetic.make_token_data(n, s, v, num_classes=classes, seed=seed)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert a.num_classes == b.num_classes


def _layout_configs():
    """(id, config fields over the smoke config) for the layout tables."""
    cases = [(arch, {}) for arch in DENSE_ARCHS]
    cases += [("gemma3-27b-ungrouped", dict(global_every=0)),
              ("gemma3-27b-tail", dict(num_layers=5)),
              ("smollm-360m-untied", dict(tie_embeddings=False)),
              ("internlm2-20b-tied", dict(tie_embeddings=True))]
    return cases


def _arch(case_id: str) -> str:
    return next(a for a in DENSE_ARCHS if case_id.startswith(a))


@pytest.mark.parametrize("case_id,fields", _layout_configs(),
                         ids=[c for c, _ in _layout_configs()])
def test_leaf_offsets_match_reference(case_id, fields):
    jcfg = dataclasses.replace(jax_smoke_config(_arch(case_id)), **fields)
    tcfg = dataclasses.replace(get_smoke_config(_arch(case_id)),
                               remat="none", **fields)
    jad = jax_modelspec.RegistryAdapter(jcfg, 16, 8, "ref")
    tad = modelspec.RegistryAdapter(tcfg, 16, 8, "port")
    want = [(l.name, l.start, l.size, l.shape) for l in jad.leaf_offsets()]
    got = [(l.name, l.start, l.size, l.shape) for l in tad.leaf_offsets()]
    assert got == want
    assert tad.param_count == jad.param_count
    # the port's init draws the same leaves, shapes included
    init = tad.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {name: shape for name, _, _, shape in want}


@pytest.mark.parametrize("spec", [
    "dense:d=32,layers=2,heads=2,kv=1,ff=64,vocab=64,seq=16",
    "dense:d_model=24,l=3,heads=3,kv=3,d_ff=40,vocab=40,classes=4",
    "dense"])
def test_canonical_spec_matches_reference(spec):
    a = jax_modelspec.get_adapter(spec)
    b = modelspec.get_adapter(spec)
    assert b.spec == a.spec
    assert b.param_count == a.param_count
    assert (b.seq_len, b.num_classes) == (a.seq_len, a.num_classes)


def _jax_params(arch: str, seed: int, **fields):
    cfg = dataclasses.replace(jax_smoke_config(arch), **fields)
    return cfg, jax_registry.init_params(cfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
def test_convert_round_trip(stacked):
    cfg, p = _jax_params("gemma3-27b", 0, num_layers=4)
    if stacked:
        p = jax.tree.map(lambda v: jnp.stack([v, 2 * v, -v]), p)
    flat = params_from_jax(p)
    jax_leaves = jax.tree_util.tree_flatten_with_path(p)[0]
    assert list(flat) == [jax_modelspec._leaf_name(path)
                          for path, _ in jax_leaves]
    for (path, leaf), (name, t) in zip(jax_leaves, flat.items()):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    back = params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, p))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, np.asarray(b))
    if stacked:
        # the port's [W, P] rows are the reference's flattened rows
        tcfg = dataclasses.replace(get_smoke_config("gemma3-27b"),
                                   num_layers=4, remat="none")
        adapter = modelspec.RegistryAdapter(tcfg, 16, 8, "port")
        want = np.concatenate([np.asarray(l).reshape(3, -1)
                               for l in jax.tree.leaves(p)], axis=1)
        np.testing.assert_array_equal(adapter.flatten(flat).numpy(), want)


FLASH_SHAPE = dict(d_model=128, num_heads=2, num_kv_heads=2, head_dim=64)


@pytest.mark.parametrize("arch,fields", [
    ("smollm-360m", {}), ("gemma3-27b", dict(sliding_window=64)),
    ("nemotron-4-340b", {})], ids=["smollm", "gemma3-window64",
                                   "nemotron-relu2"])
def test_dense_loss_and_grads_match_reference_flash(arch, fields,
                                                    monkeypatch):
    """The reference's flash path (Pallas in interpret mode, custom VJP
    through its jnp attention) against the port's (the flash Function,
    its plain version on the CPU), from the reference's weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **FLASH_SHAPE,
                               **fields, use_flash_kernel=True)
    tcfg = dataclasses.replace(get_smoke_config(arch), **FLASH_SHAPE,
                               **fields, use_flash_kernel=True,
                               remat="none")
    p = jax_registry.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :-1]),
             "labels": jnp.asarray(tokens[:, 1:])}
    loss_j, grads_j = jax.value_and_grad(
        lambda q: jax_registry.loss_fn(jcfg, q, batch)[0])(p)

    adapter = modelspec.RegistryAdapter(tcfg, 129, 8, "port")
    flat = adapter.flatten({k: v[None] for k, v in
                            params_from_jax(p).items()})
    flat.requires_grad_(True)
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    loss_t = adapter.loss(adapter.views(flat), torch.from_numpy(tokens[None]),
                          None)
    (g,) = torch.autograd.grad(loss_t.sum(), flat)
    # every layer went through the flash entry point, with its window
    assert [c["window"] for c in calls] == \
        [w for _, _, w in dense.layer_order(tcfg)]
    np.testing.assert_allclose(float(loss_t.detach()[0]), float(loss_j),
                               rtol=2e-4, atol=2e-4)
    got = adapter.unflatten(g)
    for name, want in params_from_jax(grads_j).items():
        np.testing.assert_allclose(got[name][0].numpy(), want.numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=name)


def _qkv(rng, b, s, hq, hkv, hd, sk=None):
    sk = s if sk is None else sk
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("hd,causal,window", [(64, True, 0), (64, True, 64),
                                              (64, False, 0),
                                              (128, True, 0)])
def test_flash_attention_ref_matches_pallas_kernel(hd, causal, window):
    rng = np.random.default_rng(hd + window)
    q, k, v = _qkv(rng, 2, 256, 4, 2, hd)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    want = flash_attention_fwd(tr(q), tr(k), tr(v), causal=causal,
                               window=window, block_q=128, block_k=128,
                               interpret=True)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL,
                               rtol=FLASH_TOL)


@pytest.mark.parametrize("s,causal,window", [(100, True, 0),
                                             (100, False, 0),
                                             (100, True, 30),
                                             (15, True, 0)])
def test_flash_attention_matches_reference_ops(s, causal, window):
    """The models' layout through both packages' entry points, ragged S:
    the reference pads to 128 and forces the causal mask over its padded
    keys, which the port's mask rule follows."""
    rng = np.random.default_rng(s + window)
    q, k, v = _qkv(rng, 2, s, 6, 2, 64)
    want = np.asarray(jax_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    forced = causal or s % 128 != 0
    np.testing.assert_array_equal(
        got.numpy(), ref.flash_attention_ref(tq, tk, tv, causal=forced,
                                             window=window).numpy())


@pytest.mark.parametrize("k,length", [(4, 2 ** 17), (7, 10_000)])
def test_consensus_dist_ref_matches_reference(k, length):
    rng = np.random.default_rng(length)
    x = rng.normal(size=length).astype(np.float32)
    u = (x + 0.1 * rng.normal(size=(k, length))).astype(np.float32)
    want = np.asarray(jax_ops.consensus_dist(jnp.asarray(x), jnp.asarray(u),
                                             interpret=True))
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    got = ref.consensus_dist_ref(tx, tu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ops.consensus_dist(tx, tu).numpy(), got)


def test_registry_reports_unported_families():
    for arch in ("olmoe-1b-7b", "zamba2-7b", "xlstm-1.3b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_smoke_config(arch)
    for family in ("moe", "hybrid", "xlstm"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            modelspec.get_adapter(f"{family}:d=16")
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            registry.get_model(family)
    with pytest.raises(ValueError):
        modelspec.get_adapter("encdec:d=16")


@pytest.mark.parametrize("spec,stable", [
    ("dense:d=32,layers=2,heads=2,kv=1,ff=32,vocab=32,seq=12", True),
    ("dense:d=16,layers=2,heads=2,kv=1,ff=32,vocab=32,seq=8", False)],
    ids=["tiny-lm", "d16-seq8"])
def test_reference_sensitivity_of_the_engine_tests_lm(spec, stable):
    """Why the engine tests' tiny LM (``_torch_parity.TINY_LM``) has its
    size: a 1e-7 relative perturbation of the reference's own
    initialisation stays below 1e-3 of its parameters after 5 D-PSGD
    rounds at that size, but passes 1e-2 at d 16 with 8-token sequences,
    where float noise alone would decide a comparison of two packages."""
    from _torch_parity import CFG_KW, DATA_KW, TINY_LM, jax_init
    from repro.configs.base import FedHPConfig as JaxConfig
    from repro.core import engine as jax_engine
    from repro.core import experiment as jax_experiment
    from repro.core.algorithms import make_strategy as jax_make_strategy
    from repro.core.topology import make_base_topology as jax_base_topology
    assert (spec == TINY_LM) == stable
    cfg = JaxConfig(**CFG_KW, model=spec, algorithm="dpsgd")
    rng = np.random.default_rng(1)
    finals = []
    for eps in (0.0, 1e-7):
        train, tx, ty, shards, cluster = jax_experiment.setup_experiment(
            cfg, rounds=5, **DATA_KW)
        init = jax.tree.map(
            lambda v: (v * (1 + eps * rng.normal(size=v.shape)))
            .astype(np.float32), jax_init(cfg.seed, cfg.num_workers,
                                          model=spec))
        strategy = jax_make_strategy(cfg, jax_base_topology(
            cfg.num_workers, cfg.base_topology, cfg.seed))
        finals.append(jax_engine.run_dfl(
            train, tx, ty, shards, cluster, cfg, strategy, rounds=5,
            init_params=init).final_params)
    spread = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                       / np.abs(np.asarray(a)).max())
                 for a, b in zip(jax.tree.leaves(finals[0]),
                                 jax.tree.leaves(finals[1])))
    assert spread < 1e-3 if stable else spread > 1e-2, spread
