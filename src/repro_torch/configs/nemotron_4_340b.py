"""Nemotron-4-340B — dense GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    rope_theta=10_000.0,
    act="relu2",               # squared ReLU, non-gated MLP
    worker_axes=("pod",),      # 341B params: one DFL worker per pod
    fsdp_axes=("data",),
    tp_axes=("model",),
    skip_shapes=("long_500k",),
    notes="341B: worker=pod, FSDP(data)xTP(model). long_500k skipped: pure "
          "full attention.",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, dtype="float32",
        worker_axes=("pod", "data"), fsdp_axes=())
