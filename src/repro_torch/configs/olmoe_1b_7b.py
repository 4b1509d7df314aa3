"""OLMoE-1B-7B — MoE, 64 experts top-8. [arXiv:2409.02060; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                 # per-expert hidden dim
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    rope_theta=10_000.0,
    act="silu",
    worker_axes=("pod", "data"),
    tp_axes=("model",),        # EP over model axis: 64e/16 = 4 per chip
    skip_shapes=("long_500k",),
    notes="long_500k skipped: pure full attention.",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=256, num_experts=8, experts_per_token=2,
        dtype="float32")
