"""SGD, momentum SGD and AdamW, and learning-rate schedules, as pure
(init, update) pairs over parameter dicts (flat ``{name: tensor}`` or
nested): the port of ``repro.optim.optimizers``.

``update(grads, state, params) -> (updates, new_state)``; apply with
``apply_updates(params, updates)``. The arithmetic is master math in f32
(gradients, moments and updates), and the updates are cast to each
parameter's dtype at the end, as the reference's ``_cast_like`` does: a
bf16 parameter gets a bf16 update. Steps count in an int32 tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]   # step -> lr

F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    """An optimizer: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, state)``."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (a dict, nested or not) and the
    matching leaves of ``rest``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's ``jax.tree`` order: sorted keys,
    level by level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=F32)


def exponential_decay(init_lr: float, decay: float,
                      steps_per_decay: int = 1) -> Schedule:
    """Paper Sec. V-C: lr_0 * decay^(step / steps_per_decay), in f32."""
    def sched(step):
        exponent = torch.as_tensor(step).to(F32) / steps_per_decay
        return init_lr * torch.pow(torch.tensor(decay, dtype=F32), exponent)
    return sched


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def sgd(lr) -> Optimizer:
    """Plain SGD — the paper's DSGD local update (Eq. 3). State = step
    only."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": _step0()}

    def update(grads, state, params=None):
        eta = sched(state["step"])
        updates = tree_map(lambda g: -eta * g.to(F32), grads)
        return _cast_like(updates, params), {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum_sgd(lr, momentum: float = 0.9,
                 nesterov: bool = False) -> Optimizer:
    """SGD with an f32 momentum buffer (Nesterov's form on request)."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": _step0(),
                "m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                    device=p.device),
                              params)}

    def update(grads, state, params=None):
        eta = sched(state["step"])
        m = tree_map(lambda mm, g: momentum * mm + g.to(F32), state["m"],
                     grads)
        if nesterov:
            upd = tree_map(lambda mm, g: -(eta * (momentum * mm
                                                  + g.to(F32))), m, grads)
        else:
            upd = tree_map(lambda mm: -eta * mm, m)
        return _cast_like(upd, params), {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments and bias correction; the learning rate is
    the schedule's at the step before the update."""
    sched = _as_schedule(lr)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"step": _step0(), "m": tree_map(z, params),
                "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = sched(state["step"])
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.to(F32),
                     state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(
            g.to(F32)), state["v"], grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32), step.to(F32))
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32), step.to(F32))

        def upd(mm, vv, p):
            mhat = mm / bc1
            vhat = vv / bc2
            return -eta * (mhat / (torch.sqrt(vhat) + eps)
                           + weight_decay * p.to(F32))
        updates = tree_map(upd, m, v, params)
        return _cast_like(updates, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def _cast_like(updates, params):
    if params is None:
        return updates
    return tree_map(lambda u, p: u.to(p.dtype), updates, params)


def apply_updates(params, updates):
    """params + updates, each in its parameter's dtype."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm of every leaf together, summed leaf by leaf in the
    reference's leaf order."""
    total = torch.zeros((), dtype=F32)
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(F32))).cpu()
    return torch.sqrt(total)
