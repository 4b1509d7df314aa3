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
(topology, tau_max). On a mesh with a model axis of m > 1 slots a
worker's replica lives over its slots (``modelspec.SlotAdapter``, one
[W, P_slot] matrix a slot): under ``within_worker="dp"`` each slot holds
the whole replica and takes its share of the worker's batch, the
gradient summed over the slots; under ``"tp"`` each slot holds its
pieces by the spec rules and the forward runs over them
(``registry.loss_fn_pieces``: the dense, moe, hybrid and xlstm
families); the gossip runs a slot at a time.

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
    counterpart: a train step's model-axis slots are its arguments' own
    devices (one matrix a slot, ``layout.flatten_slots``), and a serving
    step runs one replica whole. Nor has its ``donate_argnums``, a hint
    to XLA: here the train step updates its parameter matrices in place
    and the decode step its cache, whatever the caller keeps."""

    fn: Callable
    abstract_args: tuple
    layout: Any = None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_layout(cfg: ModelConfig, shape: InputShape, mesh=None):
    """The flat layout of ``cfg``'s leaves a slot of ``mesh``'s model axis
    (``modelspec.SlotAdapter``; ``mesh=None`` or a model extent of 1: the
    whole replica's [W, P] layout), sized for ``shape``'s sequences (its
    ``workers_per_pass`` budgets S tokens a sequence)."""
    m = 1 if mesh is None else sharding.model_extent(cfg, mesh)
    splits = sharding.leaf_splits(cfg, mesh, registry.leaf_shapes(cfg)) \
        if m > 1 else {}
    return modelspec.SlotAdapter(cfg, shape.seq_len + 1,
                                 f"{cfg.name}@{shape.name}", splits, m)


def loss_and_grad(cfg: ModelConfig, layout, flat: torch.Tensor,
                  batch: dict, count=None) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-worker losses [W] and gradients [W, P] of ``registry.loss_fn``
    on each worker's batch ([W, b_w, ...] leaves): autograd on the sum of
    the independent per-worker losses, in groups of ``workers_per_pass``
    workers (``count`` [W]: the token counts the loss sums divide by,
    default each batch's own)."""
    n = flat.shape[0]
    step = layout.workers_per_pass(batch["tokens"])
    grads = torch.empty_like(flat) if step < n else None
    losses = []
    with torch.enable_grad():
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            p = flat[lo:hi].detach().requires_grad_(True)
            part, _ = registry.loss_fn(
                cfg, layout.cast_params(layout.views(p)),
                {k: v[lo:hi] for k, v in batch.items()},
                count=None if count is None else count[lo:hi])
            (g,) = torch.autograd.grad(part.sum(), p)
            if grads is None:          # one pass: its gradient is the whole
                grads = g
            else:
                grads[lo:hi] = g
            losses.append(part.detach())
            del p, part, g
    return torch.cat(losses), grads


def token_counts(batch: dict) -> torch.Tensor:
    """Each worker's count of the tokens its loss averages over ([W] f32:
    the ``loss_mask``'s sum, else b_w x S) — the count
    ``chunked_softmax_xent`` returns."""
    if "loss_mask" in batch:
        return batch["loss_mask"].float().sum(dim=(1, 2))
    lab = batch["labels"]
    return torch.full((lab.shape[0],), float(lab[0].numel()),
                      device=lab.device)


def loss_and_grad_slots(cfg: ModelConfig, layout, flats, batch: dict
                        ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Per-worker losses [W] (on slot 0's device) and each slot's gradient
    [W, P_slot] of a worker's replica held over its ``layout.model``
    model-axis slots (``flats[j]`` slot j's matrix on its device; the
    batch [W, b_w, ...] on slot 0's).

    ``within_worker="dp"``: slot j runs the whole forward and backward of
    its replica on rows [j b_w / m, (j + 1) b_w / m) of each worker's
    batch, its loss sum divided by the worker's token count over all the
    slots (``token_counts``), so the slots' losses add up to the worker's
    and their gradients to the worker's gradient, which every slot then
    holds (an all-reduce over the model axis: the sum in slot order on
    slot 0's device, copied to each slot).

    ``within_worker="tp"``: one forward and backward over the slots'
    pieces (``registry.loss_fn_pieces``) in ``workers_per_pass`` groups;
    each slot's gradient is that of its pieces, and the columns of the
    leaves every slot holds whole (``layout.whole_spans``) take slot 0's,
    the one gradient of those leaves."""
    home, m = flats[0].device, layout.model
    n = flats[0].shape[0]
    if cfg.within_worker == "dp":
        share = batch["tokens"].shape[1] // m
        count = token_counts(batch)
        losses = torch.zeros(n, device=home)
        total = None
        for j, flat in enumerate(flats):
            dev = flat.device
            part = {k: v[:, j * share:(j + 1) * share].to(dev)
                    for k, v in batch.items()}
            loss, g = loss_and_grad(cfg, layout, flat, part, count.to(dev))
            losses += loss.to(home)
            if total is None:
                total = g
            else:
                total += g.to(home)
            del g
        return losses, [total] + [total.to(f.device, copy=True)
                                  for f in flats[1:]]
    step = layout.workers_per_pass(batch["tokens"])
    grads = [torch.empty_like(f) for f in flats] if step < n else None
    losses = []
    with torch.enable_grad():
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            ps = [f[lo:hi].detach().requires_grad_(True) for f in flats]
            part, _ = registry.loss_fn_pieces(
                cfg, [layout.cast_params(layout.views(p)) for p in ps],
                {k: v[lo:hi] for k, v in batch.items()})
            gs = torch.autograd.grad(part.sum(), ps)
            if grads is None:
                grads = list(gs)
            else:
                for grad, g in zip(grads, gs):
                    grad[lo:hi] = g
            losses.append(part.detach())
            del ps, part, gs
    for grad in grads[1:]:
        for a, b in layout.whole_spans():
            grad[:, a:b] = grads[0][:, a:b].to(grad.device)
    return torch.cat(losses), grads


def make_train_step(cfg: ModelConfig, mesh, shape: InputShape, *,
                    adj: np.ndarray | None = None, tau_max: int = 1,
                    mixing: str = "uniform", compressed: bool = False,
                    measure_distances: bool = False) -> StepBundle:
    """Build the FedHP round step for this cell:
    ``fn(params, batch, taus, lr) -> (params, loss, aux)``.

    params: the flat [W, P] f32 matrix (``bundle.layout.flatten`` of
    worker-stacked leaves), updated in place — or, on a mesh whose model
    axis has m > 1 slots, a tuple of the m slots' [W, P_slot] matrices
    (``bundle.layout.flatten_slots``), each on its slot's device (the
    step runs each slot's work where its matrix lives); batch: {name:
    [W, b_w, ...]}, with a tau dim after W ([W, tau_max, b_w, ...]) when
    tau_max > 1 (an ``expand``ed view when every step takes the same
    batch), on slot 0's device; taus: [W] int; lr: the f32 learning rate
    (0-d tensor or float); loss: the 0-d f32 mean over workers and
    tau_max steps; aux: {"neighbor_dists": [M]} with
    ``measure_distances`` (worker 0's distance to its partner in each
    matching, summed over the model axis as the reference's: a leaf
    every slot holds whole counts once a slot). adj: the round topology
    (default: a ring)."""
    worker_axes = sharding.worker_axes_in_mesh(cfg, mesh)
    w = sharding.mesh_workers(mesh, worker_axes)
    layout = train_layout(cfg, shape, mesh)
    m = layout.model
    if adj is None:
        adj = _default_adj(w)
    mixfn = (topo.mixing_matrix_metropolis if mixing == "metropolis"
             else topo.mixing_matrix_uniform)
    mix = mixfn(adj) if w > 1 else np.ones((1, 1))
    pairs = collectives.matchings_as_pairs(adj) if w > 1 else []
    wt = (collectives.matching_weight_tables(adj, mix) if w > 1
          else np.zeros((0, 1), np.float32))

    # --- abstract arguments ----------------------------------------------
    slots = [torch.empty(w, layout.param_count, device=META)
             for _ in range(m)]
    params_sds = tuple(slots) if m > 1 else slots[0]
    split = sharding.split_batch_shapes(
        registry.batch_shapes(cfg, shape), w)
    for k, (s, _) in split.items():
        sharding.batch_slots(cfg, mesh, k, s)       # raises where refused
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

    def local_steps(flats, batch, taus, lr):
        tot = torch.zeros((), device=flats[0].device)
        for k in range(tau_max):
            bk = {n: v[:, k] for n, v in batch.items()} if tau_max > 1 \
                else batch
            mask = (taus > k).to(torch.float32)            # Eq. 3, masked
            if m == 1:
                loss, g = loss_and_grad(cfg, layout, flats[0], bk)
                grads = [g]
            else:
                loss, grads = loss_and_grad_slots(cfg, layout, flats, bk)
            for flat, g in zip(flats, grads):
                scale = (lr * mask).to(flat.device)[:, None]
                flat.sub_(layout.round_leaves_(g.mul_(scale)))
                layout.round_leaves_(flat)
            tot = tot + loss.mean()
            del g, grads        # before the next step allocates its own
        return tot / tau_max

    def train_step(params, batch, taus, lr):
        flats = list(params) if m > 1 else [params]
        dev = flats[0].device
        taus = torch.as_tensor(taus, device=dev)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        loss = local_steps(flats, batch, taus, lr)
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
