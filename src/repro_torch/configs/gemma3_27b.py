"""Gemma3-27B — dense GQA, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    sliding_window=1024,
    global_every=6,            # 5 local : 1 global
    rope_theta=1_000_000.0,
    act="gelu",
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    notes="long_500k RUNS: sliding-window majority; 1-in-6 global layers keep "
          "a seq-sharded 500k cache (DESIGN.md §4).",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, sliding_window=32,
        global_every=3, dtype="float32")
