"""The arithmetic of flash attention's bf16 tile instance, modelled on
the CPU (``tests/_torch_flash_model.py``), against the plain version.

The instance multiplies p by V on bf16 tensor cores with p split into
two bf16 halves (hi = bf16(p), lo = bf16(p - hi)), each key tile's
product summed from zero and added to the output on the CUDA cores. The
model does the same at the kernel's key tiles (128 keys at hd 64, 112
and 128, 64 at hd 192) and is held, like the kernel on the card, to
``ref.flash_attention_ref`` (the f32 composition rounded to bf16 once)
within one bf16 ulp per element, or 2e-5 near 0 (measured: none past
it, 0.21-0.22% of the elements one ulp apart). Its control takes p as
one bf16 and must trip that bound (measured: 10.8-11.5% of the elements
past it, 38-39% apart): the split is what keeps the function. Inputs are
unit normals from a numpy seed, rounded to bf16.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_flash_model import flash_bf16_model
from repro_torch.kernels import ref

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

ATOL = 2e-5
# (S, Hq, Hkv, hd): S <= 1,024, the registry's GQA groups cut to 1-2 KV
# heads
SHAPES = [(1024, 3, 1, 64), (512, 2, 1, 112), (512, 2, 2, 128),
          (512, 2, 1, 192)]
MASKS = {"causal": (True, 0), "window": (True, 200)}


def _inputs(s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, s, h, hd),
                                                 dtype=np.float32))
            .to(torch.bfloat16) for h in (hq, hkv, hkv)]


def _past_bound(y, want) -> torch.Tensor:
    """Elements of y further from want than one bf16 ulp (or ATOL), or
    not finite."""
    return ~((y.float() - want.float()).abs()
             <= ref.bf16_ulp(want).clamp_min(ATOL))


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("s,hq,hkv,hd", SHAPES)
def test_split_p_keeps_one_ulp(s, hq, hkv, hd, mask):
    causal, window = MASKS[mask]
    q, k, v = _inputs(s, hq, hkv, hd, seed=s + hd)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    y = flash_bf16_model(q, k, v, causal=causal, window=window)
    assert y.dtype == torch.bfloat16 and y.shape == want.shape
    assert not bool(_past_bound(y, want).any())


@pytest.mark.parametrize("s,hq,hkv,hd", SHAPES)
def test_one_bf16_p_trips_the_bound(s, hq, hkv, hd):
    q, k, v = _inputs(s, hq, hkv, hd, seed=s + hd)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    y = flash_bf16_model(q, k, v, causal=True, window=0, split_p=False)
    # a tenth of the elements or so at these sizes: not a rare tie
    assert float(_past_bound(y, want).float().mean()) > 0.01
