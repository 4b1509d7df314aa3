#!/usr/bin/env python3
"""Every flash_attention call of one f32 serving prefill, each against
its plain version in f32 and in f64, on one card: the witness behind
``chip_smoke.py`` phase 5's per-call bound.

    python3 tools/flash_serving_calls.py [ARCH ...]

For each ARCH (default: every attending model of ``chip_smoke.SERVE_MODELS``)
it builds phase 5's f32 check model (published widths, the same cut
depth, seed and prompt) on the card and runs one prefill with the flash
kernel on. For each call it prints the layer, max |y| and max |q k| /
sqrt(hd) (the scores' largest magnitude), and three gaps: the kernel
against the plain version in f32 (``ref.flash_attention_ref``, what
phase 5 holds), the kernel against the plain version in f64, and the
plain f32 version against f64; with each gap its largest excess over
2e-5 + 2e-5 |y| elementwise (positive: past phase 2's bound); and at
the kernel's worst element, y and the summands' scale sum_j p_j |v_j|
(where it is far above |y|, the sum cancels). Where the kernel and the
plain f32 version stand as far from f64, the two are equally accurate
on those inputs. Needs a
CUDA device and ``nvcc``.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402


def _gap(y, want) -> str:
    """max |y - want| / its largest excess over 2e-5 + 2e-5 |want|."""
    diff = (y.double() - want).abs()
    excess = diff - (cs.FLASH_ATOL + cs.FLASH_RTOL * want.abs())
    return f"{float(diff.max()):.3e}/{float(excess.max()):+.2e}"


def _attention_f64(q, k, v, window: int):
    """The plain version's function in f64: (y [B, S, Hq, hd], the
    summands' scale sum_j p_j |v_j| of each element)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.double()) / math.sqrt(
        hd)
    mask = ref.attention_mask(s, k.shape[1], causal=True, window=window,
                              device=q.device)
    w = torch.softmax(torch.where(mask, scores, -1e300), dim=-1)
    y = torch.einsum("bhgst,bthd->bshgd", w, v.double())
    scale = torch.einsum("bhgst,bthd->bshgd", w, v.double().abs())
    return (y.reshape(b, s, hq, hd), scale.reshape(b, s, hq, hd),
            float(scores.abs().max()))


def report(arch: str, b: int, prompt: int, fields) -> None:
    cfg = cs._serve_cfg(arch, "float32", fields)
    params, g = cs._serve_params(cfg, cs.SERVE_SEED)
    batch, cap = serve.prompt_batch(cfg, b, prompt, cs.TEACHER_STEPS, g)
    orig, layer = ops.flash_attention, [0]

    def holding(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        window = kw.get("window", 0)
        y32 = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        y64, scale, max_score = _attention_f64(q, k, v, window)
        worst = (out.double() - y64).abs().flatten().argmax()
        print(f"  {arch} call={layer[0]} window={window} "
              f"shape={tuple(q.shape)} max_y={float(y64.abs().max()):.3f} "
              f"max_score={max_score:.2f} "
              f"kernel_vs_f32={_gap(out, y32.double())} "
              f"kernel_vs_f64={_gap(out, y64)} "
              f"f32_vs_f64={_gap(y32, y64)} "
              f"at_kernel_worst: y={float(y64.flatten()[worst]):.4f} "
              f"sum_p_abs_v={float(scale.flatten()[worst]):.4f}",
              flush=True)
        del y64, scale
        layer[0] += 1
        return out

    ops.flash_attention = holding
    try:
        registry.run_prefill(cfg, params, batch, max_len=cap)
    finally:
        ops.flash_attention = orig
    del params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    archs = sys.argv[1:] if argv is None else argv
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.py
    ops.build()
    for arch, b, prompt, _, fields in cs.SERVE_MODELS:
        cfg = cs._serve_cfg(arch, "float32", fields)
        if (not archs or arch in archs) and registry.attention_calls(cfg):
            report(arch, b, prompt, fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())
