"""Model-zoo registry (the port of ``repro.models.registry``): family ->
module with a uniform training interface over worker-stacked parameters

    init(cfg, generator) -> one worker's {name: tensor}
    leaf_shapes(cfg) -> {name: shape}
    loss_fn(cfg, params, batch) -> (per-worker loss [W], metrics)
    attention_calls(cfg) -> attention layers one forward pass runs

The token families dense, moe, hybrid and xlstm are ported; encdec and
vlm raise ``NotImplementedError`` naming the ROADMAP.md item that brings
them (queue 1, item 4, with the serving entry points).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, hybrid, moe, xlstm

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
    """One worker's parameters of ``cfg``'s family."""
    return get_model(cfg.family).init(cfg, generator)


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes of ``cfg``'s family."""
    return get_model(cfg.family).leaf_shapes(cfg)


def loss_fn(cfg: ModelConfig, params, batch):
    """Per-worker training loss of ``cfg``'s family."""
    return get_model(cfg.family).loss_fn(cfg, params, batch)


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers (flash-attention launches with
    ``use_flash_kernel``) one forward pass of ``cfg``'s family runs."""
    return get_model(cfg.family).attention_calls(cfg)
