"""Serving entry point: batched prefill and a greedy decode loop for any
registry architecture — the port of ``repro.launch.serve``. It serves one
replica (W = 1) on one device.

At smoke scale on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-vl-2b --smoke --batch 2 --prompt-len 32 --gen 8 \
        --device cpu

Without ``--device`` it runs on the card, where ``registry.init_params``
builds a published config there (random weights from ``--seed``). The
reference's ``--production`` and ``--multi-pod`` meshes (launch/train's
``(data, model)`` mesh) wait for ROADMAP.md queue 1, item 4: given, they
raise.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.encdec import dec_len


def prompt_batch(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
                 generator: torch.Generator) -> tuple[dict, int]:
    """The reference's prompts, drawn from ``generator`` on its device:
    ``batch`` random prompts of ``prompt_len`` tokens, or for encdec
    8 x ``prompt_len`` random frames and a max(prompt_len // 8, 1)-token
    prompt. Returns ([1, B, ...] leaves, the cache capacity: the
    decoder's length and ``gen``)."""
    dev = generator.device
    if cfg.family == "encdec":
        frames = torch.randn(1, batch, prompt_len * 8, cfg.d_model,
                             generator=generator, device=dev)
        prompt = torch.randint(0, cfg.vocab_size,
                               (1, batch, max(prompt_len // 8, 1)),
                               generator=generator, device=dev)
        return ({"frames": frames.to(L.dtype_of(cfg.dtype)),
                 "tokens": prompt}, dec_len(prompt_len * 8) + gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, batch, prompt_len),
                           generator=generator, device=dev)
    return {"tokens": prompt}, prompt_len + gen


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params: dict, batch: dict, gen: int,
             cap: int) -> dict:
    """Greedy decoding: prefill ``batch`` into a cache of capacity
    ``cap``, then ``gen`` - 1 decode steps, each fed the last argmax.
    Returns {"tokens": [W, B, gen], "prefill_s", "decode_s" (wall
    seconds, each ended by a device sync), "prefill_logits" [W, B, V],
    "cache"}."""
    dev = batch["tokens"].device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = registry.run_prefill(cfg, params, batch, max_len=cap)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)[..., None]
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = registry.decode_step(cfg, params, cache, tok)
        tok = torch.argmax(logits, dim=-1)[..., None]
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(out, dim=-1), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0,
            "prefill_logits": prefill_logits, "cache": cache}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--production", action="store_true",
                    help="the reference's production mesh: not ported "
                    "(the (data, model) mesh, ROADMAP.md queue 1, item 4); "
                    "raises")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production, the multi-pod mesh: not "
                    "ported; raises")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card otherwise")
    args = ap.parse_args(argv)
    if args.production or args.multi_pod:
        raise NotImplementedError(
            "--production / --multi-pod need the (data, model) mesh, which "
            "is not ported to repro_torch yet (ROADMAP.md queue 1, item 4)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = {k: v[None] for k, v in registry.init_params(cfg, gen).items()}
    b, t = args.batch, args.prompt_len
    batch, cap = prompt_batch(cfg, b, t, args.gen, gen)
    run = generate(cfg, params, batch, args.gen, cap)

    print(f"arch={cfg.name} batch={b} prompt={t} gen={args.gen}")
    print(f"prefill: {run['prefill_s']:.2f}s; decode: {run['decode_s']:.2f}s "
          f"({(args.gen - 1) * b / max(run['decode_s'], 1e-9):.1f} tok/s)")
    print("generated ids (first row):", run["tokens"][0, 0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
