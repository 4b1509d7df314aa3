"""Model-zoo registry (the port of ``repro.models.registry``): family ->
module with a uniform training interface over worker-stacked parameters

    init(cfg, generator) -> one worker's {name: tensor}
    leaf_shapes(cfg) -> {name: shape}
    leaf_dtypes(cfg) -> {name: storage dtype}
    loss_fn(cfg, params, batch) -> (per-worker loss [W], metrics)
    attention_calls(cfg) -> attention layers one forward pass runs

The token families dense, moe, hybrid and xlstm are ported; encdec and
vlm raise ``NotImplementedError`` naming the ROADMAP.md item that brings
them (queue 1, item 4, with the serving entry points).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, hybrid, moe, xlstm
from repro_torch.models import layers as L

_FAMILY = {"dense": dense, "moe": moe, "hybrid": hybrid, "xlstm": xlstm}
# the reference's other families, still to port
_UNPORTED = ("vlm", "encdec")


def get_model(family: str):
    """The module implementing ``family``."""
    if family in _UNPORTED:
        raise NotImplementedError(
            f"model family {family!r} is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 4)")
    if family not in _FAMILY:
        raise KeyError(f"unknown model family {family!r}")
    return _FAMILY[family]


def init_params(cfg: ModelConfig, generator):
    """One worker's parameters of ``cfg``'s family, drawn in f32 and cast
    to each leaf's storage dtype (``leaf_dtypes``), as the reference's
    initialisers do."""
    dtypes = leaf_dtypes(cfg)
    return {k: v.to(dtypes[k]) for k, v in
            get_model(cfg.family).init(cfg, generator).items()}


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes of ``cfg``'s family."""
    return get_model(cfg.family).leaf_shapes(cfg)


def leaf_dtypes(cfg: ModelConfig) -> dict[str, torch.dtype]:
    """Each leaf's storage dtype: ``cfg.dtype``, except the leaves the
    family keeps in f32 (its module's ``F32_LEAVES``, by the leaf's last
    name: the MoE router, the Mamba2 decays, dt biases and skips, the
    xLSTM gates and the sLSTM recurrence), as the reference's
    initialisers store them."""
    L.check_trainable(cfg)
    model = get_model(cfg.family)
    dt = L.dtype_of(cfg.dtype)
    return {name: (torch.float32 if name.rsplit("/", 1)[-1]
                   in model.F32_LEAVES else dt)
            for name in model.leaf_shapes(cfg)}


def loss_fn(cfg: ModelConfig, params, batch):
    """Per-worker training loss of ``cfg``'s family."""
    return get_model(cfg.family).loss_fn(cfg, params, batch)


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers (flash-attention launches with
    ``use_flash_kernel``) one forward pass of ``cfg``'s family runs."""
    return get_model(cfg.family).attention_calls(cfg)
