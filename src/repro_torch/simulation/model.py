"""The synthetic 3-layer classifier trained by the DFL simulation (the
port of ``repro.simulation.model``), written for a whole fleet at once.

Parameters are a dict of worker-stacked tensors ``[W, ...]`` (``w1``
``[W, D, H]``, ``b1`` ``[W, H]``, ...); every function maps a batch per
worker ``x`` ``[W, *batch, D]`` to per-worker results ``[W]``, with the
matrix products as ``torch.baddbmm`` over the worker axis. A batch that
every worker shares is passed as ``x.expand(W, ...)`` (no copy).
"""
from __future__ import annotations

import math

import torch


def init_classifier(generator: torch.Generator, dim: int, hidden: int,
                    num_classes: int) -> dict[str, torch.Tensor]:
    """ONE worker's parameters on the CPU: normal weights scaled by
    1/sqrt(fan_in), zero biases (the reference's init law; the draws come
    from ``generator``, not from ``jax.random``)."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    s1 = 1.0 / math.sqrt(dim)
    s2 = 1.0 / math.sqrt(hidden)
    return {
        "w1": normal(dim, hidden) * s1,
        "b1": torch.zeros(hidden),
        "w2": normal(hidden, hidden) * s2,
        "b2": torch.zeros(hidden),
        "w3": normal(hidden, num_classes) * s2,
        "b3": torch.zeros(num_classes),
    }


def logits(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [W, *batch, D] -> [W, *batch, C]."""
    w = x.shape[0]
    h = x.reshape(w, -1, x.shape[-1])
    h = torch.relu(torch.baddbmm(params["b1"].unsqueeze(1), h, params["w1"]))
    h = torch.relu(torch.baddbmm(params["b2"].unsqueeze(1), h, params["w2"]))
    z = torch.baddbmm(params["b3"].unsqueeze(1), h, params["w3"])
    return z.reshape(*x.shape[:-1], z.shape[-1])


def classifier_loss(params: dict[str, torch.Tensor], x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Per-worker softmax cross-entropy ``mean(logsumexp(z) - z[gold])``.

    y: [W, *batch] int64. The gold logit follows the reference's
    ``take_along_axis(logits, y[:, None], axis=-1)[:, 0]`` exactly: for
    one batch dim that is z[n, y[n]]; for a two-dim batch [G, N] (the
    engines' full eval stack) it broadcasts to z[g, 0, y[g, n]] — the
    measurement semantics FedHP's decisions were tuned against."""
    z = logits(params, x)
    logz = torch.logsumexp(z, dim=-1)
    if y.dim() == 2:
        gold = z.gather(-1, y.unsqueeze(-1)).squeeze(-1)
    elif y.dim() == 3:
        gold = z[:, :, 0, :].gather(-1, y)
    else:
        raise ValueError(f"labels must be [W, N] or [W, G, N], "
                         f"got {tuple(y.shape)}")
    return (logz - gold).reshape(x.shape[0], -1).mean(dim=1)


def accuracy(params: dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Per-worker top-1 accuracy; x: [W, N, D], y: [W, N] -> [W]."""
    hit = logits(params, x).argmax(dim=-1) == y
    return hit.to(torch.float32).mean(dim=-1)
