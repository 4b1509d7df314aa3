"""InternLM2-20B — dense GQA transformer. [arXiv:2403.17297; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    act="silu",
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    skip_shapes=("long_500k",),
    notes="GQA kv=8. long_500k skipped: pure full attention (DESIGN.md §4).",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32")
