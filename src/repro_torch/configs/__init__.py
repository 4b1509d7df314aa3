"""Architecture registry: ``arch`` id -> (CONFIG, smoke_config), the
port of ``repro.configs``. The four dense architectures are ported; the
other six raise ``NotImplementedError`` naming the ROADMAP.md item that
brings their family."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import FedHPConfig, ModelConfig  # noqa: F401

_ARCH_MODULES: dict[str, str] = {
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
}

# the reference's other architectures, by the family that is not ported
_UNPORTED: dict[str, str] = {
    "kimi-k2-1t-a32b": "moe", "olmoe-1b-7b": "moe",
    "whisper-large-v3": "encdec", "zamba2-7b": "hybrid",
    "xlstm-1.3b": "xlstm", "qwen2-vl-2b": "vlm",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} ({_UNPORTED[arch]} family) is not ported to "
            "repro_torch yet (ROADMAP.md queue 1, item 8)")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(_ARCH_MODULES) + sorted(_UNPORTED)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    """The published config of ``arch``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """The reduced same-family config of ``arch`` for CPU tests."""
    return _module(arch).smoke_config()
