"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against, and what ``ops`` runs on tensors
the caller placed on the CPU."""
from __future__ import annotations

import torch


def gossip_mix_ref(x: torch.Tensor, u: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x: [B, L]; u: [K, L]; w: [B, K] -> y[b] = x[b] + sum_k w[b, k]
    (u[k] - x[b]), f32, accumulated for k ascending with one rounding per
    subtract, multiply and add — the kernel's exact arithmetic order, so
    the two agree bit for bit (an identity row of ``w`` is an exact
    no-op)."""
    acc = x
    for k in range(u.shape[0]):
        acc = acc + w[:, k:k + 1] * (u[k] - x)
    return acc
