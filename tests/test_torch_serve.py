"""The port's serving layers and dense-family serving against the
reference JAX package, on the CPU, from the reference's weights
(``convert.params_from_jax``) at the smoke configs, f32 unless named.

- ``layers.decode_attention`` (rolling and full caches, a wrapped
  rolling slot and the full cache's ``min(len, cap - 1)`` slot),
  ``layer_norm``, ``sinusoidal_positions``, ``apply_mrope`` and
  ``registry.mrope_positions_for`` (bit-equal) against the reference's.
- ``registry.run_prefill``'s logits and every cache leaf, then 4
  ``decode_step``s fed the same tokens, logits and cache after each:
  smollm-360m; gemma3-27b's groups with a tail (window 32, ``global_every``
  3, 4 layers) over a 40-token prompt and 8 steps, so the rolling slots
  wrap; smollm-360m's full cache of capacity 10 over an 8-token prompt
  and 4 steps, so the last two steps write slot ``min(len, cap - 1)``;
  qwen2-vl-2b's text serving. Elementwise ``|port - ref| <= 1e-5 + 1e-5 |ref|``
  (``_torch_serving.F32_ATOL`` / ``F32_RTOL``); measured worst |diff|,
  smollm / gemma3 / qwen2-vl: logits 6.3e-7 / 5.6e-6 / 9.2e-7, caches
  2.3e-6 / 4.6e-6 / 2.4e-6.
- qwen2-vl-2b's ``loss_fn`` (vision embeddings prepended, M-RoPE) and
  gradients (``_torch_serving.check_loss_and_grads``): loss within 1e-5
  relative (measured 1.7e-7), every gradient leaf within 1e-5 + 1e-4 |g|
  (measured worst |diff| 1.9e-7).
- One bf16 prefill and 2 steps (smollm-360m at ``dtype="bfloat16"``,
  an 8-token prompt in a cache of 10), within ``|diff| <= 5e-2 + 2e-2
  |ref|``: over 6 seeds the logits part by at most 6.9e-3 and the caches
  by 3.5e-2 (layer 2's k / v, after one layer of bf16 products), the two
  packages' bf16 rounding (XLA on the CPU keeps f32 through fused
  chains, torch rounds each op; ``tests/test_torch_bf16.py``).
- The teacher-forced check of the port against its own forward, every
  family: prefill a prompt, decode tokens fed from a fixed sequence, and
  each step's logits against ``registry.forward_logits`` at that
  position, within 1e-5 of the largest logit magnitude (measured 2.5e-7
  to 2.4e-6, zamba2 the largest); MoE at a capacity where no token
  drops (the test's docstring says why).
- ``python -m repro_torch.launch.serve --smoke --device cpu``: one family
  of each kind prints the reference's three lines; ``--production``
  raises.

The other families' serving and the encdec / vlm losses are in
``tests/test_torch_serve_families.py``.
"""
from __future__ import annotations

import ast
import contextlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import (check_loss_and_grads, compare,
                            compile_on_first_call, compiled, configs,
                            run_against_reference)
from repro.models import layers as jax_layers
from repro.models import registry as jax_registry
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import registry

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BF16_ATOL, BF16_RTOL = 5e-2, 2e-2
TEACHER_RTOL = 1e-5


def _attn_params(rng, d, hq, hkv, hd):
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    return {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("window,cap,lengths", [
    (0, 12, (0, 5, 11, 12, 15)),       # full: past the capacity too
    (8, 8, (0, 3, 7, 8, 13, 20))])     # rolling: the slot wraps
def test_decode_attention_matches_reference(window, cap, lengths):
    """One step at each ``len``: the output and the cache written in
    place, against the reference's functional update."""
    rng = np.random.default_rng(1)
    b, d, hq, hkv, hd = 3, 32, 4, 2, 8
    p = _attn_params(rng, d, hq, hkv, hd)
    tp = {k: torch.from_numpy(v)[None] for k, v in p.items()}
    kw = dict(num_heads=hq, num_kv_heads=hkv, head_dim=hd, theta=1e4,
              window=window)
    step = compile_on_first_call(
        lambda x, ck, cv, n: jax_layers.decode_attention(
            p, x, ck, cv, n, positions=jnp.full((b, 1), n, jnp.int32), **kw))
    for n in lengths:
        x = rng.normal(size=(b, 1, d)).astype(np.float32)
        ck, cv = (rng.normal(size=(b, cap, hkv, hd)).astype(np.float32)
                  for _ in range(2))
        jo, jk, jv = step(jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                          jnp.int32(n))
        tk, tv = torch.from_numpy(ck)[None], torch.from_numpy(cv)[None]
        to = L.decode_attention(tp, torch.from_numpy(x)[None], tk, tv, n,
                                positions=torch.tensor([n]), **kw)
        compare(to, jo, f"out at len {n}")
        compare(tk, jk, f"k at len {n}")
        compare(tv, jv, f"v at len {n}")


def test_norms_and_positions_match_reference():
    """``layer_norm``, ``sinusoidal_positions`` and ``apply_mrope`` (a
    vision grid's streams, sections 2:1:1) against the reference's."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3 + 1
    g, bta = (rng.normal(size=24).astype(np.float32) for _ in range(2))
    pos = registry.mrope_positions_for(configs("qwen2-vl-2b")[1], 2, 40)
    q = rng.normal(size=(2, 40, 4, 32)).astype(np.float32)
    sizes = ((7, 16), (64, 64), (3, 2))

    def reference(x, g, bta, q, pos3):
        return (jax_layers.layer_norm(x, g, bta),
                [jax_layers.sinusoidal_positions(s, d) for s, d in sizes],
                jax_layers.apply_mrope(q, pos3, 1e6))

    args = (x, g, bta, q, np.moveaxis(pos.numpy(), 1, 0))
    ln, sins, mr = compiled(reference, *args)(*args)
    compare(L.layer_norm(torch.from_numpy(x)[None],
                         torch.from_numpy(g)[None],
                         torch.from_numpy(bta)[None]), ln, "layer_norm")
    for (s, dim), want in zip(sizes, sins):
        compare(L.sinusoidal_positions(s, dim)[None], want,
                f"sinusoidal {s}x{dim}")
    got = L.apply_mrope(torch.from_numpy(q), pos.movedim(1, 0), 1e6)
    compare(got[None], mr, "apply_mrope")


@pytest.mark.parametrize("b,s", [(2, 40), (1, 7), (3, 64), (1, 1)])
def test_mrope_positions_bit_equal(b, s):
    jcfg, cfg = configs("qwen2-vl-2b")
    want = np.asarray(jax_registry.mrope_positions_for(jcfg, b, s))
    got = registry.mrope_positions_for(cfg, b, s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# (id, arch, config fields, B, prompt S, decode steps, cache capacity)
DENSE_CASES = [
    ("smollm-360m-full-cache", "smollm-360m", None, 2, 8, 4, 10),
    ("gemma3-27b-wraps", "gemma3-27b", dict(num_layers=4), 2, 40, 8, 48),
    ("qwen2-vl-2b", "qwen2-vl-2b", None, 2, 12, 4, 16)]


@pytest.mark.parametrize("case,arch,fields,b,s,steps,cap", DENSE_CASES,
                         ids=[c[0] for c in DENSE_CASES])
def test_dense_serving_matches_reference(case, arch, fields, b, s, steps,
                                         cap):
    run_against_reference(arch, b=b, s=s, steps=steps, cap=cap,
                          fields=fields)


def test_vlm_loss_and_grads_match_reference():
    check_loss_and_grads("qwen2-vl-2b")


def test_dense_bf16_serving_matches_reference():
    run_against_reference("smollm-360m", b=2, s=8, steps=2, cap=10,
                          fields=dict(dtype="bfloat16"), atol=BF16_ATOL,
                          rtol=BF16_RTOL)


# (arch, config fields): every family, gemma3 past its window
TEACHER_CASES = [("smollm-360m", {}), ("gemma3-27b", dict(num_layers=4)),
                 ("olmoe-1b-7b", {}), ("zamba2-7b", {}), ("xlstm-1.3b", {}),
                 ("whisper-large-v3", {}), ("qwen2-vl-2b", {})]


@pytest.mark.parametrize("arch,fields", TEACHER_CASES,
                         ids=[c[0] for c in TEACHER_CASES])
def test_teacher_forced_decode_matches_forward(arch, fields):
    """The port's prefill and decode steps against its own training
    forward at the same positions (encdec: the decoder over the same
    frames). MoE runs at a capacity factor of E / k, where no expert
    drops a token (``moe.capacity_factor`` says why)."""
    cfg = configs(arch, **fields)[1]
    gen = torch.Generator().manual_seed(3)
    tp = {k: v[None] for k, v in registry.init_params(cfg, gen).items()}
    s, steps = (6, 5) if cfg.family == "encdec" else (36, 6)
    toks = torch.randint(0, cfg.vocab_size, (1, 2, s + steps), generator=gen)
    batch = {"tokens": toks[..., :s]}
    full = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = full["frames"] = torch.randn(
            1, 2, 8 * s, cfg.d_model, generator=gen)
    no_drops = (moe.capacity_factor(cfg.num_experts / cfg.experts_per_token)
                if cfg.family == "moe" else contextlib.nullcontext())
    with no_drops:
        want = registry.forward_logits(cfg, tp, full, start=s - 1)
        logits, cache = registry.run_prefill(cfg, tp, batch,
                                             max_len=s + steps)
        got = [logits]
        for i in range(steps):
            logits, cache = registry.decode_step(
                cfg, tp, cache, toks[..., s + i:s + i + 1])
            got.append(logits)
    scale = float(want.abs().max())
    got = torch.stack(got, dim=2)                  # positions s - 1..
    gap = float((got - want).abs().max()) / scale
    assert gap <= TEACHER_RTOL, (arch, gap)


# one architecture of each kind the CLI serves
CLI_ARCHS = ("smollm-360m", "olmoe-1b-7b", "zamba2-7b", "xlstm-1.3b",
             "whisper-large-v3", "qwen2-vl-2b")


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_serve_cli_prints_the_three_lines(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "16", "--gen", "4",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3, lines
    assert lines[0].startswith(f"arch={arch} batch=2 prompt=16 gen=4")
    assert lines[1].startswith("prefill: ") and "tok/s" in lines[1]
    ids = ast.literal_eval(lines[2].split(":", 1)[1].strip())
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)


def test_serve_module_entry_point_and_unported_mesh():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--batch", "1", "--prompt-len", "8", "--gen", "3", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == \
        "arch=smollm-360m batch=1 prompt=8 gen=3"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve.main(["--smoke", "--production", "--device", "cpu"])
