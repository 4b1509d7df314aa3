"""Architecture registry: ``arch`` id -> (CONFIG, smoke_config), and the
(arch, shape) cells — the port of ``repro.configs``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    FedHPConfig,
    InputShape,
    ModelConfig,
    RunConfig,
)

_ARCH_MODULES: dict[str, str] = {
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    """The published config of ``arch``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """The reduced same-family config of ``arch`` for CPU tests."""
    return _module(arch).smoke_config()


def arch_shape_cells(include_skipped: bool = False):
    """All (arch, shape name, shape) cells of the published configs; an
    architecture's ``skip_shapes`` are left out unless requested."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not include_skipped and name in cfg.skip_shapes:
                continue
            cells.append((arch, name, shape))
    return cells
