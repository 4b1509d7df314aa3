"""SmolLM-360M — llama-arch small dense GQA. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=True,
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    within_worker="dp",
    skip_shapes=("long_500k",),
    notes="long_500k skipped: pure full attention. head_dim=64; 15 heads "
          "pad to 16 for TP=16 (one padded head).",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32")
