"""xLSTM-1.3B — sLSTM + mLSTM blocks (d_ff=0: projection inside blocks).
[arXiv:2405.04517; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                    # no FFN: mLSTM blocks carry their own up-proj
    vocab_size=50304,
    slstm_every=7,             # xLSTM[7:1]: 1 sLSTM block per 7 blocks
    act="silu",
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    notes="long_500k RUNS: recurrent matrix-memory state decode "
          "(sub-quadratic).",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        vocab_size=256, slstm_every=2, dtype="float32")
