"""Whisper-large-v3 backbone — enc-dec transformer; conv frontend STUBBED
(input_specs supplies precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,             # 32 enc + 32 dec
    encoder_layers=32,
    decoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    act="gelu",
    worker_axes=("pod", "data"),
    tp_axes=("model",),
    within_worker="dp",
    skip_shapes=("long_500k",),
    notes="Enc-dec: seq_len = encoder frames; decoder length = seq_len//8. "
          "decode_* uses self-cache seq//8 + cross-attn over seq frames. "
          "long_500k skipped: pure full attention. Conv frontend is a stub.",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, decoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        dtype="float32")
