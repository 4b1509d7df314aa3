"""Qwen2-VL-2B backbone — M-RoPE, dynamic resolution; vision frontend STUBBED
(input_specs supplies precomputed patch embeddings). [arXiv:2409.12191; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    mrope=True,
    act="silu",
    tie_embeddings=True,
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    within_worker="dp",
    skip_shapes=("long_500k",),
    notes="M-RoPE (temporal/h/w section rotary). Vision patch embeds are a "
          "stub input. long_500k skipped: pure full attention.",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32")
