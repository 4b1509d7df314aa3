"""A model, in plain torch on the CPU, of the arithmetic of flash
attention's bf16 tile instance (``csrc/flash_attention_bf16.cu``): what
its wgmma products, online softmax and rescaling compute, tile by tile,
without its layout. ``tests/test_torch_flash_bf16_model.py`` holds it to
``ref.flash_attention_ref``."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

# the instance's key tile per head width (kKeys64 ... kKeys192)
TILE_KEYS = {64: 128, 112: 128, 128: 128, 192: 64}
NEG_INF = -1e30


def flash_bf16_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int, split_p: bool = True,
                     keys: int | None = None) -> torch.Tensor:
    """bf16 q [B, S, Hq, hd], k and v [B, Sk, Hkv, hd] -> bf16 [B, S, Hq,
    hd], as the kernel computes it: per key tile of ``keys`` keys
    (``TILE_KEYS[hd]``), s = q k^T of the exact bf16 values in f32, the
    -1e30 mask, the running max m of s, p = 2^(s c - m c) (s c - m c in
    one rounding, m c taken as 0 while m is -1e30) and alpha = 2^((m_old
    - m) c) with c = hd^-0.5 log2(e); p split hi = bf16(p), lo =
    bf16(p - hi), the tile's p v = hi v + lo v summed from zero in f32,
    then acc = alpha acc + p v and l = alpha l + sum(p); the output
    bf16(acc / l) once. ``split_p=False`` takes p as one bf16 (hi v
    alone): the control that loses the function."""
    b, s, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    keys = keys or TILE_KEYS[hd]
    g = hq // hkv
    qf = q.float().permute(0, 2, 1, 3)                       # [B, Hq, S, hd]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    # the kernel's f32 scale (ops passes hd ** -0.5) times f32 log2(e)
    c = torch.tensor(hd ** -0.5, dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    allowed = ref.attention_mask(s, sk, causal=causal, window=window,
                                 device=q.device) if causal or window \
        else torch.ones(s, sk, dtype=torch.bool)
    m = torch.full((b, hq, s, 1), NEG_INF)
    l = torch.zeros(b, hq, s, 1)
    acc = torch.zeros(b, hq, s, hd)
    for j0 in range(0, sk, keys):
        kt, vt = kf[:, :, j0:j0 + keys], vf[:, :, j0:j0 + keys]
        sc = qf @ kt.transpose(-1, -2)
        sc = torch.where(allowed[:, j0:j0 + keys], sc, NEG_INF)
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mn) * c)
        # the kernel's FFMA s c - mc, one rounding (an f64 product of
        # two f32 values is exact), with mc 0 on a row that has reached
        # no key yet
        mc = torch.where(mn == NEG_INF, 0.0, mn * c)
        p = torch.exp2((sc.double() * c.double() - mc.double()).float())
        hi = p.bfloat16().float()
        part = hi @ vt
        if split_p:
            part = (p - hi).bfloat16().float() @ vt + part
        acc = acc * alpha + part
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mn
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)
