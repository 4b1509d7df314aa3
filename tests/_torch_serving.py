"""Shared helpers of the serving tests (``tests/test_torch_serve*.py``):
the reference's weights carried across to the port, the reference's
jitted prefill and decode step, and leaf-by-leaf comparison of logits
and caches."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jax_layers
from repro.models import registry as jax_registry
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.convert import _flat_items, params_from_jax
from repro_torch.models import registry

# XLA's CPU compiler at its cheapest: the reference's functions here run
# once or a few times at smoke sizes, where compiling dominates (about
# 3x faster than the default options)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def compile_on_first_call(fn):
    """``fn`` compiled (``compiled``) for the arguments of its first call,
    whose shapes every later call keeps."""
    exe = []

    def call(*args):
        if not exe:
            exe.append(compiled(fn, *args))
        return exe[0](*args)

    return call


# the modality losses' bounds: the loss relative, each gradient leaf
# elementwise |port - ref| <= GRAD_ATOL + GRAD_RTOL |ref|
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# f32 bounds of the port's serving against the reference, elementwise:
# |port - ref| <= F32_ATOL + F32_RTOL |ref| (logits and every cache leaf;
# the worst measured on the smoke configs is stated in each test file)
F32_ATOL = F32_RTOL = 1e-5


def configs(arch: str, **fields):
    """(the reference's, the port's) smoke config of ``arch`` with
    ``fields`` replaced."""
    return (dataclasses.replace(jax_smoke_config(arch), **fields),
            dataclasses.replace(get_smoke_config(arch), **fields))


@functools.lru_cache(maxsize=None)
def weights(jcfg, seed: int):
    """(the reference's init, the same weights as the port's [1, ...]
    leaves), once a process for each config and seed (callers copy what
    they write)."""
    key = jax.random.PRNGKey(seed)
    if jcfg.dtype == "float32":
        jp = compiled(lambda k: jax_registry.init_params(jcfg, k), key)(key)
    else:
        # the reference's init draws every leaf in f32 and casts it to
        # its storage dtype: its f32 init cast leaf by leaf (one compile
        # fewer)
        f32 = weights(dataclasses.replace(jcfg, dtype="float32"), seed)[0]
        dtypes = jax.eval_shape(lambda: jax_registry.init_params(jcfg, key))
        jp = jax.tree.map(lambda v, sd: v.astype(sd.dtype), f32, dtypes)
    return jp, {k: v[None] for k, v in params_from_jax(jp).items()}


def port_batch(batch: dict) -> dict:
    """numpy [B, ...] leaves -> the port's [1, B, ...] tensors."""
    return {k: torch.from_numpy(np.array(v))[None] for k, v in
            batch.items()}


def serving_batch(jcfg, rng: np.random.Generator, b: int, s: int,
                  extra: int) -> dict:
    """numpy inputs: ``tokens`` [B, s + extra] (the prompt and the tokens
    the decode steps are fed), and for encdec ``frames`` [B, 8 s, d]."""
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s + extra))
           .astype(np.int32)}
    if jcfg.family == "encdec":
        out["frames"] = (rng.normal(size=(b, 8 * s, jcfg.d_model))
                         .astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def reference_fns(jcfg, cap: int):
    """The reference's jitted (prefill(params, batch), decode(params,
    cache, tokens [B, 1]))."""
    pre = compile_on_first_call(
        lambda p, bt: jax_registry.run_prefill(jcfg, p, bt, max_len=cap))
    dec = compile_on_first_call(
        lambda p, c, t: jax_registry.decode_step(jcfg, p, c, t))
    return pre, dec


def rope_reference_keys(cache: dict) -> dict:
    """The reference's encdec cache with its self-attention keys rotated
    (RoPE at theta 1e4, by slot = position): its prefill stores them
    unrotated (models/encdec.py of the port)."""
    cap = cache["k"].shape[2]
    return dict(cache, k=jax_layers.apply_rope(cache["k"], jnp.arange(cap),
                                               1e4))


def compare(port: torch.Tensor, ref, what: str, atol: float = F32_ATOL,
            rtol: float = F32_RTOL) -> float:
    """Hold ``port`` [1, ...] to ``ref`` [...] elementwise; return the
    max |diff|."""
    got = port.detach().float().numpy()
    if isinstance(ref, torch.Tensor):
        ref = ref.float().numpy()
    want = np.asarray(ref, np.float32)[None]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)
    return float(np.abs(got - want).max()) if got.size else 0.0


def compare_cache(port: dict, ref: dict, what: str, **tol) -> float:
    """Every leaf of the port's flat cache against the reference's tree
    (the same ``"/"``-joined names), ``len`` exactly."""
    ref_flat = params_from_jax(jax.device_get(ref))
    assert sorted(port) == sorted(ref_flat), (sorted(port), sorted(ref_flat))
    assert int(port["len"]) == int(ref_flat["len"])
    worst = 0.0
    for name, v in port.items():
        if name != "len":
            assert v.dtype == ref_flat[name].dtype, (name, v.dtype)
            worst = max(worst, compare(v, ref_flat[name],
                                       f"{what} cache {name}", **tol))
    return worst


def run_against_reference(arch: str, *, b: int, s: int, steps: int,
                          cap: int, seed: int = 0, fields=None,
                          **tol) -> dict:
    """Prefill ``s`` tokens (encdec: over 8 s frames) into a cache of
    capacity ``cap`` in both packages from the reference's weights, then
    ``steps`` decode steps fed the same tokens; logits and every cache
    leaf held after each. Returns the worst |diff| of logits and
    caches."""
    jcfg, cfg = configs(arch, **(fields or {}))
    jp, tp = weights(jcfg, seed)
    data = serving_batch(jcfg, np.random.default_rng(seed + 100), b, s,
                         steps)
    toks = data.pop("tokens")
    batch = dict(data, tokens=toks[:, :s])
    pre, dec = reference_fns(jcfg, cap)
    jl, jc = pre(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    if cfg.family == "encdec":
        jc = rope_reference_keys(jc)
    tl, tc = registry.run_prefill(cfg, tp, port_batch(batch), max_len=cap)
    worst = {"logits": compare(tl, jl, f"{arch} prefill logits", **tol),
             "cache": compare_cache(tc, jc, f"{arch} prefill", **tol)}
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = dec(jp, jc, jnp.asarray(tok))
        tl, tc2 = registry.decode_step(cfg, tp, tc,
                                       torch.from_numpy(tok)[None])
        assert tc2 is tc                      # written in place
        worst["logits"] = max(worst["logits"], compare(
            tl, jl, f"{arch} step {i} logits", **tol))
        worst["cache"] = max(worst["cache"], compare_cache(
            tc, jc, f"{arch} step {i}", **tol))
    return worst


def check_loss_and_grads(arch: str) -> None:
    """``arch``'s smoke config: the port's ``loss_fn`` and gradients
    against the reference's, from the reference's weights, on a batch of
    the port's ``make_batch`` (encdec: frames; vlm: vision embeddings
    prepended and M-RoPE positions)."""
    jcfg, cfg = configs(arch)
    jp, tp = weights(jcfg, 0)
    tb = registry.make_batch(cfg, InputShape("t", 64, 2, "train"),
                             torch.Generator().manual_seed(2))
    jb = {k: jnp.asarray(v[0].numpy()) for k, v in tb.items()}
    loss_j, grads_j = compiled(jax.value_and_grad(
        lambda p: jax_registry.loss_fn(jcfg, p, jb)[0]), jp)(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss_t = registry.loss_fn(cfg, leaves, tb)[0][0]
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(grads_j))
    for name, g in zip(leaves, grads_t):
        np.testing.assert_allclose(g[0].numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{arch} grad {name}")



def bf16_runs(arch: str, *, b: int, s: int, steps: int, cap: int,
              seed: int = 0, fields=None, reference_bf16: bool = True):
    """``arch`` in bf16 from the reference's bf16 weights: prefill ``s``
    tokens (encdec: over 8 s frames) into a cache of capacity ``cap``,
    then ``steps`` decode steps fed the same tokens, in the port, in the
    reference (unless ``reference_bf16`` is False) and in the reference
    at f32 on the same bf16-valued weights. Returns, for the logits and
    every cache leaf after each: (what, port, reference bf16 or None,
    reference f32), f32 [...] tensors; each port cache leaf has the
    reference's dtype."""
    jcfg, cfg = configs(arch, **dict(fields or {}, dtype="bfloat16"))
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp, tp = weights(jcfg, seed)
    jp32 = jax.tree.map(lambda v: v.astype(jnp.float32), jp)
    data = serving_batch(jcfg, np.random.default_rng(seed + 100), b, s,
                         steps)
    toks = data.pop("tokens")
    batch = dict(data, tokens=toks[:, :s])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    refs = {"f32": (jp32,) + reference_fns(jcfg32, cap)}
    if reference_bf16:
        refs["bf16"] = (jp,) + reference_fns(jcfg, cap)
    state = {}
    for name, (p, pre, _) in refs.items():
        state[name] = pre(p, jb)
        if cfg.family == "encdec":
            state[name] = (state[name][0], rope_reference_keys(state[name][1]))
    tl, tc = registry.run_prefill(cfg, tp, port_batch(batch), max_len=cap)
    ref_dtypes = {k: str(v.dtype) for k, v in _flat_items(jax.eval_shape(
        lambda: jax_registry.make_decode_cache(jcfg, b, cap)))}
    out = []

    def record(what):
        flat = {n: (torch.from_numpy(np.asarray(lg).astype(np.float32)),
                    params_from_jax(jax.device_get(c)))
                for n, (lg, c) in state.items()}
        r16 = flat.get("bf16")
        for name in ["logits"] + [k for k in tc if k != "len"]:
            got = tl[0] if name == "logits" else tc[name][0]
            want = {n: (lg if name == "logits" else c[name])
                    for n, (lg, c) in flat.items()}
            if name != "logits":
                assert str(got.dtype) == f"torch.{ref_dtypes[name]}", name
            out.append((f"{what} {name}", got.float().clone(),
                        want["bf16"].float() if r16 else None,
                        want["f32"].float()))

    record("prefill")
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        for name, (p, _, dec) in refs.items():
            state[name] = dec(p, state[name][1], jnp.asarray(tok))
        tl, tc = registry.decode_step(cfg, tp, tc,
                                      torch.from_numpy(tok)[None])
        record(f"step {i}")
    return out
