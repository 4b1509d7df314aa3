#!/usr/bin/env python3
"""The figures behind the bf16 serving bounds of
``tests/test_torch_serve_bf16.py``, over several seeds, on the CPU.

    python3 tools/serve_bf16_seeds.py [--seeds N] [--no-drops] [ARCH ...]

For each ARCH (default: olmoe-1b-7b, zamba2-7b, xlstm-1.3b,
whisper-large-v3) and seed it runs the test's case
(``_torch_serving.bf16_runs``: prefill and 2 decode steps from the
reference's bf16 weights at the smoke config) and prints, over the
logits and every cache leaf: the port's largest gap from the reference
in bf16, the reference's own bf16 error (its gap from itself in f32 on
the same weights), and the largest excess of the port's gap over twice
that error, the leaf it is at. whisper, whose reference prefill does
not trace in bf16, prints the port's gap from the reference in f32 and
the smallest atol that passes at rtol 2e-2 instead.

``--no-drops`` routes MoE at capacity factor E / k in both packages,
where no expert drops a token. For MoE it also prints, per layer of the
prefill (at the run's capacity factor), the tokens whose top-k experts
differ between the port's bf16 and f32 runs on the same weights, with
their k-th and (k + 1)-th router probabilities in bf16: the near-ties a
bf16 rounding flips. Needs the
reference JAX package; runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_serving as S  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402

CASES = {"olmoe-1b-7b": (12, None), "zamba2-7b": (12, dict(num_layers=5)),
         "xlstm-1.3b": (12, None), "whisper-large-v3": (4, None)}


@contextlib.contextmanager
def no_drops(arch: str):
    cfg = S.configs(arch)[1]
    factor = cfg.num_experts / cfg.experts_per_token
    old = jax_moe.CAPACITY_FACTOR
    jax_moe.CAPACITY_FACTOR = factor
    try:
        with moe.capacity_factor(factor):
            yield
    finally:
        jax_moe.CAPACITY_FACTOR = old


def router_flips(arch: str, s: int, seed: int) -> list[str]:
    """The prefill's tokens whose top-k experts differ between the
    port's bf16 and f32 runs on the same bf16-valued weights."""
    jcfg, cfg = S.configs(arch, dtype="bfloat16")
    tp = S.weights(jcfg, seed)[1]
    data = S.serving_batch(jcfg, np.random.default_rng(seed + 100), 2, s, 2)
    batch = S.port_batch({"tokens": data["tokens"][:, :s]})
    k = cfg.experts_per_token

    def probs(c, p):
        seen, orig = [], torch.topk

        def topk(x, n, dim=-1):
            seen.append(x.detach().float().clone())
            return orig(x, n, dim=dim)

        torch.topk = topk
        try:
            registry.run_prefill(c, p, batch, max_len=s)
        finally:
            torch.topk = orig
        return seen

    lo = probs(cfg, tp)
    hi = probs(dataclasses.replace(cfg, dtype="float32"),
               {n: v.float() for n, v in tp.items()})
    out = []
    for layer, (a, b) in enumerate(zip(lo, hi)):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        for t in range(a.shape[0]):
            top_a = set(torch.topk(a[t], k).indices.tolist())
            if top_a != set(torch.topk(b[t], k).indices.tolist()):
                v = torch.sort(a[t], descending=True).values
                out.append(f"layer {layer} token {divmod(t, s)}: "
                           f"p_k={float(v[k - 1]):.5f} "
                           f"p_k+1={float(v[k]):.5f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=list(CASES))
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--no-drops", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for arch in args.archs:
        s, fields = CASES[arch]
        with_ref = arch != "whisper-large-v3"
        def ctx():
            if args.no_drops and arch.startswith("olmoe"):
                return no_drops(arch)
            return contextlib.nullcontext()

        for seed in range(args.seeds):
            with ctx():
                runs = S.bf16_runs(arch, b=2, s=s, steps=2, cap=s + 2,
                                   seed=seed, fields=fields,
                                   reference_bf16=with_ref)
            if with_ref:
                gaps = [(w, float((p - r).abs().max()),
                         float((r - f).abs().max())) for w, p, r, f in runs]
                worst = max(gaps, key=lambda g: g[1] - 2 * g[2])
                print(f"{arch} seed={seed} port_gap="
                      f"{max(g[1] for g in gaps):.4g} reference_bf16_error="
                      f"{max(g[2] for g in gaps):.4g} excess="
                      f"{worst[1] - 2 * worst[2]:.4g} at={worst[0]!r}")
            else:
                atol = max(float(((p - f).abs() - 2e-2 * f.abs()).max())
                           for _, p, _, f in runs)
                gap = max(float((p - f).abs().max()) for _, p, _, f in runs)
                print(f"{arch} seed={seed} port_gap_from_f32={gap:.4g} "
                      f"atol_at_rtol_2e-2={atol:.4g}")
            if arch.startswith("olmoe"):
                with ctx():
                    flips = router_flips(arch, s, seed)
                for line in flips:
                    print(f"  {line}")
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
