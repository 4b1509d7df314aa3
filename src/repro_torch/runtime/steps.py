"""DFL train and serve steps — the port of ``repro.runtime.steps``.

``make_train_step`` is the paper's round engine over a worker mesh: each
worker holds its own replica — a row of the fleet's flat [W, P] f32
matrix in the reference's leaf order (``modelspec.RegistryAdapter``'s
layout; a bf16 leaf's columns hold bf16 values) — runs tau_i masked
local SGD steps on its [b / W] share of the global batch (Eq. 3: step k
updates worker i while k < tau_i; masked steps run and change nothing),
then gossips along the round topology's matchings (Eq. 5,
``collectives.gossip_fn``; with ``compressed`` the int8 codec a leaf,
``collectives.gossip_compressed_fn``). The topology and tau_max are
fixed when the step is built, as the reference compiles one step per
(topology, tau_max).

It reproduces the reference's arithmetic where the result depends on
it: each SGD write is p − (lr·mask·g) with the update rounded to the
leaf's dtype before the subtraction and the result rounded again (two
roundings on a bf16 leaf, as the reference's ``(lr * mask * g).astype(
p.dtype)``); the reported loss is the mean over all tau_max steps,
masked ones included; the compressed gossip starts each round from a
zero residual (the reference's ``err`` is zeros every round); the
gossip on a bf16 leaf, compressed or not, rounds each matching's term
and sum to bf16, as the reference's does (``gossip_mix``'s bf16-rounded
form). The W workers' gradients
run in groups of ``workers_per_pass`` (the reference ``vmap``s all W),
so a full-width step fits one card.

``make_prefill_step`` / ``make_decode_step`` are single-replica serving
steps over ``registry.run_prefill`` / ``registry.decode_step`` (the
port's [1, ...] leaves: W = 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import modelspec
from repro_torch.core import topology as topo
from repro_torch.models import registry
from repro_torch.runtime import collectives, sharding

META = torch.device("meta")


@dataclass
class StepBundle:
    """Everything the launcher needs for one (arch, shape, mesh) cell:
    ``fn`` the step, ``abstract_args`` its arguments as tensors on the
    ``meta`` device (shape and dtype, no storage: the reference's
    ``ShapeDtypeStruct``s), and ``layout`` the flat parameter layout of a
    train step (a ``RegistryAdapter``: ``flatten`` / ``unflatten`` /
    ``views``; None for the serving steps).

    The reference's ``in_shardings`` / ``out_shardings`` have no
    counterpart: a worker's replica and its batch live whole on one
    device (a model axis of size > 1 raises, ROADMAP.md queue 1 item 4),
    so there is nothing to place. Nor has its ``donate_argnums``, a hint
    to XLA: here the train step updates its parameter matrix in place
    and the decode step its cache, whatever the caller keeps."""

    fn: Callable
    abstract_args: tuple
    layout: Any = None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_layout(cfg: ModelConfig, shape: InputShape):
    """The flat [W, P] layout of ``cfg``'s leaves, sized for ``shape``'s
    sequences (its ``workers_per_pass`` budgets S tokens a sequence)."""
    return modelspec.RegistryAdapter(cfg, shape.seq_len + 1, 0,
                                     f"{cfg.name}@{shape.name}")


def loss_and_grad(cfg: ModelConfig, layout, flat: torch.Tensor,
                  batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-worker losses [W] and gradients [W, P] of ``registry.loss_fn``
    on each worker's batch ([W, b_w, ...] leaves): autograd on the sum of
    the independent per-worker losses, in groups of ``workers_per_pass``
    workers."""
    n = flat.shape[0]
    step = layout.workers_per_pass(batch["tokens"])
    grads = torch.empty_like(flat)
    losses = []
    with torch.enable_grad():
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            p = flat[lo:hi].detach().requires_grad_(True)
            part, _ = registry.loss_fn(
                cfg, layout.cast_params(layout.views(p)),
                {k: v[lo:hi] for k, v in batch.items()})
            (g,) = torch.autograd.grad(part.sum(), p)
            grads[lo:hi] = g
            losses.append(part.detach())
            del p, part, g
    return torch.cat(losses), grads


def make_train_step(cfg: ModelConfig, mesh, shape: InputShape, *,
                    adj: np.ndarray | None = None, tau_max: int = 1,
                    mixing: str = "uniform", compressed: bool = False,
                    measure_distances: bool = False) -> StepBundle:
    """Build the FedHP round step for this cell:
    ``fn(params, batch, taus, lr) -> (params, loss, aux)``.

    params: the flat [W, P] f32 matrix (``bundle.layout.flatten`` of
    worker-stacked leaves), updated in place; batch: {name: [W, b_w,
    ...]}, with a tau dim after W ([W, tau_max, b_w, ...]) when tau_max >
    1 (an ``expand``ed view when every step takes the same batch); taus:
    [W] int; lr: the f32 learning rate (0-d tensor or float); loss: the
    0-d f32 mean over workers and tau_max steps; aux: {"neighbor_dists":
    [M]} with ``measure_distances`` (worker 0's distance to its partner
    in each matching). adj: the round topology (default: a ring)."""
    worker_axes = sharding.worker_axes_in_mesh(cfg, mesh)
    w = sharding.mesh_workers(mesh, worker_axes)
    if adj is None:
        adj = _default_adj(w)
    mixfn = (topo.mixing_matrix_metropolis if mixing == "metropolis"
             else topo.mixing_matrix_uniform)
    mix = mixfn(adj) if w > 1 else np.ones((1, 1))
    pairs = collectives.matchings_as_pairs(adj) if w > 1 else []
    wt = (collectives.matching_weight_tables(adj, mix) if w > 1
          else np.zeros((0, 1), np.float32))
    layout = train_layout(cfg, shape)

    # --- abstract arguments ----------------------------------------------
    params_sds = torch.empty(w, layout.param_count, device=META)
    split = sharding.split_batch_shapes(
        registry.batch_shapes(cfg, shape), w)
    batch_sds = {k: torch.empty((s[0], tau_max, *s[1:]) if tau_max > 1
                                else s, dtype=dt, device=META)
                 for k, (s, dt) in split.items()}
    taus_sds = torch.empty(w, dtype=torch.int32, device=META)
    lr_sds = torch.empty((), device=META)

    gossip = (collectives.gossip_fn(mesh, worker_axes, pairs, wt,
                                    measure_distances=measure_distances,
                                    narrow_spans=layout.narrow_spans())
              if w > 1 and pairs else None)
    gossip_c = (collectives.gossip_compressed_fn(
                    mesh, worker_axes, pairs, wt,
                    leaf_spans=[(l.start, l.stop)
                                for l in layout.leaf_offsets()],
                    narrow_spans=layout.narrow_spans())
                if compressed and w > 1 and pairs else None)

    def local_steps(flat, batch, taus, lr):
        tot = torch.zeros((), device=flat.device)
        for k in range(tau_max):
            bk = {n: v[:, k] for n, v in batch.items()} if tau_max > 1 \
                else batch
            mask = (taus > k).to(torch.float32)            # Eq. 3, masked
            loss, g = loss_and_grad(cfg, layout, flat, bk)
            flat.sub_(layout.round_leaves_(g.mul_((lr * mask)[:, None])))
            layout.round_leaves_(flat)
            tot = tot + loss.mean()
            del g               # before the next step allocates its own
        return flat, tot / tau_max

    def train_step(params, batch, taus, lr):
        dev = params.device
        taus = torch.as_tensor(taus, device=dev)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        params, loss = local_steps(params, batch, taus, lr)
        aux = {}
        if gossip_c is not None:
            params, _ = gossip_c(params, None, 0)
        elif gossip is not None:
            if measure_distances:
                params, aux["neighbor_dists"] = gossip(params)
            else:
                params = gossip(params)
        return params, loss, aux

    return StepBundle(fn=train_step,
                      abstract_args=(params_sds, batch_sds, taus_sds, lr_sds),
                      layout=layout)


def _default_adj(w: int) -> np.ndarray:
    return topo.ring_topology(w) if w > 1 else np.zeros((1, 1), np.int8)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _meta_params(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    dtypes = registry.leaf_dtypes(cfg)
    return {k: torch.empty((1, *s), dtype=dtypes[k], device=META)
            for k, s in registry.leaf_shapes(cfg).items()}


def make_prefill_step(cfg: ModelConfig, mesh,
                      shape: InputShape) -> StepBundle:
    """``fn(params, batch) -> logits [1, B, V]``: prefill of one replica
    ([1, ...] leaves) on ``shape``'s batch (its ``batch_shapes`` without
    the labels)."""
    bs = {k: torch.empty((1, *s), dtype=dt, device=META)
          for k, (s, dt) in registry.batch_shapes(cfg, shape).items()
          if k != "labels"}

    def prefill_step(params, batch):
        logits, _ = registry.run_prefill(cfg, params, batch)
        return logits

    return StepBundle(fn=prefill_step, abstract_args=(_meta_params(cfg), bs))


def make_decode_step(cfg: ModelConfig, mesh,
                     shape: InputShape) -> StepBundle:
    """``fn(params, cache, tokens) -> (logits, cache)``: ONE new token
    [1, B, 1] against a cache of capacity ``shape.seq_len``
    (``registry.make_decode_cache``), written in place."""
    b = shape.global_batch
    cache = registry.make_decode_cache(cfg, b, shape.seq_len, device=META)
    tok = torch.empty((1, b, 1), dtype=torch.int32, device=META)

    def decode_step(params, cache, tokens):
        return registry.decode_step(cfg, params, cache, tokens)

    return StepBundle(fn=decode_step,
                      abstract_args=(_meta_params(cfg), cache, tok))


def make_step(cfg: ModelConfig, mesh, shape: InputShape,
              **train_kw) -> StepBundle:
    """The step of ``shape``'s kind: train, prefill or decode."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape, **train_kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    return make_decode_step(cfg, mesh, shape)
