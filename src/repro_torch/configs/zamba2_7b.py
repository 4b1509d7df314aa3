"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,             # mamba2 blocks
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,                # shared-attention-block FFN
    vocab_size=32000,
    ssm_state=64,
    ssm_every=6,               # shared attn block invoked every 6 mamba blocks
    act="silu",
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    notes="long_500k RUNS: Mamba2 constant-size state decode (sub-quadratic).",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_every=2, dtype="float32")
