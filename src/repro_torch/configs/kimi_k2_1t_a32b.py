"""Kimi K2 — trillion-param MoE, 384 experts top-8. [arXiv:2501.kimi2; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                 # per-expert hidden dim
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    rope_theta=50_000.0,
    act="silu",
    worker_axes=("pod",),      # ~1T params: one DFL worker per pod
    fsdp_axes=("data",),
    tp_axes=("model",),        # EP over model axis: 384e / 16 = 24/chip col
    skip_shapes=("long_500k",),
    notes="worker=pod; experts sharded over (data,model)=256 chips. DSGD is "
          "stateless => params-only state (2TB bf16) fits a 4TB pod. "
          "long_500k skipped: pure full attention.",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=256, num_experts=8, experts_per_token=2,
        num_shared_experts=1, dtype="float32",
        worker_axes=("pod", "data"), fsdp_axes=())
