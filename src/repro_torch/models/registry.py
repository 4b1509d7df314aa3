"""Model-zoo registry (the port of ``repro.models.registry``): family ->
module with a uniform interface over worker-stacked parameters

    init(cfg, generator, dtypes) -> one worker's {name: tensor}
    leaf_shapes(cfg) -> {name: shape}
    leaf_dtypes(cfg) -> {name: storage dtype}
    loss_fn(cfg, params, batch) -> (per-worker loss [W], metrics)
    attention_calls(cfg) -> attention layers one forward pass runs
    prefill(cfg, params, ...) -> (logits [W, B, V], cache)
    decode_step(cfg, params, cache, tokens) -> (logits [W, B, V], cache)
    init_cache(cfg, batch, max_len[, ...]) -> cache

Family ``vlm`` reuses the dense module (M-RoPE and prepended patch
embeddings are dense-model features; batches carry precomputed patch
embeddings) and serves text only, as the reference does. Serving runs
one replica: W = 1, the reference's single model with the worker axis
added. The DFL engines take the token families only
(``core/modelspec.get_adapter`` refuses encdec and vlm).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import dense, encdec, hybrid, moe, xlstm
from repro_torch.models import layers as L

_FAMILY = {"dense": dense, "moe": moe, "vlm": dense, "encdec": encdec,
           "hybrid": hybrid, "xlstm": xlstm}
# the families whose replica the round step runs over a model axis, by
# ``within_worker``: "tp" through their ``loss_fn_pieces``, "dp" through
# ``loss_fn(count=)`` (``runtime/sharding.model_extent`` refuses the rest)
MODEL_AXIS_FAMILIES = {"tp": ("dense", "moe", "hybrid", "xlstm"),
                       "dp": ("dense", "encdec", "vlm")}

VLM_VISION_FRACTION = 8       # S_vis = seq_len // 8


def get_model(family: str):
    """The module implementing ``family``."""
    if family not in _FAMILY:
        raise KeyError(f"unknown model family {family!r}")
    return _FAMILY[family]


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """One worker's parameters of ``cfg``'s family, drawn on the
    generator's device by the reference's init laws: each leaf is drawn
    in f32 and cast to its storage dtype (``leaf_dtypes``), a stack's
    blocks one at a time into stacked leaves allocated once, so a model
    is built on the card with no host copy and no second stack (on the
    CPU the values are those of drawing everything in f32 and casting
    after)."""
    dtypes = leaf_dtypes(cfg)
    with torch.device(generator.device):
        return get_model(cfg.family).init(cfg, generator, dtypes)


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes of ``cfg``'s family."""
    return get_model(cfg.family).leaf_shapes(cfg)


def leaf_dtypes(cfg: ModelConfig) -> dict[str, torch.dtype]:
    """Each leaf's storage dtype: ``cfg.dtype``, except the leaves the
    family keeps in f32 (its module's ``F32_LEAVES``, by the leaf's last
    name: the MoE router, the Mamba2 decays, dt biases and skips, the
    xLSTM gates and the sLSTM recurrence), as the reference's
    initialisers store them."""
    L.check_trainable(cfg)
    model = get_model(cfg.family)
    dt = L.dtype_of(cfg.dtype)
    return {name: (torch.float32 if name.rsplit("/", 1)[-1]
                   in model.F32_LEAVES else dt)
            for name in model.leaf_shapes(cfg)}


def loss_fn(cfg: ModelConfig, params, batch, count=None):
    """Per-worker training loss of ``cfg``'s family; ``count`` [W] (the
    families the model axis runs in dp: dense, vlm and encdec) divides
    the loss sum in place of the batch's token count."""
    if count is None:
        return get_model(cfg.family).loss_fn(cfg, params, batch)
    return get_model(cfg.family).loss_fn(cfg, params, batch, count=count)


def loss_fn_pieces(cfg: ModelConfig, slots: list, batch):
    """Per-worker training loss of a replica split over its model-axis
    slots (the family module's ``loss_fn_pieces``; the dense, moe,
    hybrid and xlstm families)."""
    if cfg.family not in MODEL_AXIS_FAMILIES["tp"]:
        raise NotImplementedError(f"the {cfg.family} family over a model "
                                  "axis (ROADMAP.md queue 1, item 4.4)")
    return get_model(cfg.family).loss_fn_pieces(cfg, slots, batch)


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers (flash-attention launches with
    ``use_flash_kernel``) one forward pass of ``cfg``'s family runs."""
    return get_model(cfg.family).attention_calls(cfg)


# ---------------------------------------------------------------------------
# Batch construction (shapes shared with the reference's input specs)
# ---------------------------------------------------------------------------

def batch_shapes(cfg: ModelConfig, shape: InputShape,
                 batch_override: int = 0) -> dict[str, tuple]:
    """One worker's train-batch leaves for (cfg, shape): {name: (shape,
    dtype)}."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    dt = L.dtype_of(cfg.dtype)
    i32 = torch.int32
    if cfg.family == "encdec":
        t = encdec.dec_len(s)
        return {"frames": ((b, s, cfg.d_model), dt),
                "tokens": ((b, t), i32), "labels": ((b, t), i32)}
    if cfg.family == "vlm":
        sv = s // VLM_VISION_FRACTION
        st = s - sv
        # batch-leading [B, 3, S]; dense.loss_fn moves the stream axis
        return {"tokens": ((b, st), i32), "labels": ((b, st), i32),
                "vision_embeds": ((b, sv, cfg.d_model), dt),
                "mrope_positions": ((b, 3, s), i32)}
    return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}


def make_batch(cfg: ModelConfig, shape: InputShape,
               generator: torch.Generator, batch_override: int = 0, *,
               num_workers: int = 1) -> dict:
    """A random batch of ``batch_shapes`` for each of ``num_workers``
    workers ([W, ...] leaves), on the generator's device, drawn in
    sorted-name order from ``generator`` (the reference draws from
    ``jax.random``): ids uniform in [0, vocab), embeddings 0.02 normal
    in the leaf dtype, ``mrope_positions`` from
    ``mrope_positions_for``."""
    dev = generator.device
    out = {}
    for name, (shp, dt) in sorted(batch_shapes(cfg, shape,
                                               batch_override).items()):
        full = (num_workers, *shp)
        if name == "mrope_positions":
            out[name] = mrope_positions_for(cfg, shp[0], shp[2]) \
                .to(dev).expand(full)
        elif dt == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, full,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(full, generator=generator,
                                    device=dev).to(dt) * 0.02
    return out


def mrope_positions_for(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    """Simple (t, h, w) position streams [B, 3, S] int32: a square-ish
    vision grid for the first S // 8 positions, then sequential text ids
    on all three streams (the reference's, bit-equal)."""
    sv = s // VLM_VISION_FRACTION
    side = max(int(np.sqrt(max(sv, 1))), 1)
    idx = np.arange(s)
    t = np.where(idx < sv, 0, idx - sv + 1)
    h = np.where(idx < sv, np.minimum(idx // side, side - 1), idx - sv + 1)
    w = np.where(idx < sv, idx % side, idx - sv + 1)
    pos = torch.from_numpy(np.stack([t, h, w]).astype(np.int32))
    return pos[None].expand(b, 3, s)


# ---------------------------------------------------------------------------
# Serving entry points (uniform across families)
# ---------------------------------------------------------------------------

def prefill_kwargs(cfg: ModelConfig, batch: dict) -> dict:
    """The batch leaves prefill reads."""
    if cfg.family == "encdec":
        return {"frames": batch["frames"], "tokens": batch["tokens"]}
    return {"tokens": batch["tokens"]}


def run_prefill(cfg: ModelConfig, params: dict, batch: dict,
                max_len: int = 0):
    """Prefill of ``cfg``'s family on a batch of [W, B, ...] leaves ->
    (the last position's logits [W, B, V] f32, the cache of capacity
    ``max_len``, the prompt's length when 0)."""
    return get_model(cfg.family).prefill(
        cfg, params, **prefill_kwargs(cfg, batch), max_len=max_len)


def make_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                      num_workers: int = 1, device=None) -> dict:
    """A zero cache for a decode step at ``seq_len``: capacity exactly
    ``seq_len`` (a seq_len - 1 context and the new token); encdec's
    decoder at ``dec_len(seq_len)`` over ``seq_len`` frames."""
    m = get_model(cfg.family)
    kw = dict(num_workers=num_workers, device=device)
    if cfg.family == "encdec":
        return m.init_cache(cfg, batch, encdec.dec_len(seq_len), seq_len,
                            **kw)
    if cfg.family == "xlstm":
        return m.init_cache(cfg, batch, **kw)
    return m.init_cache(cfg, batch, seq_len, **kw)


@torch.no_grad()
def forward_logits(cfg: ModelConfig, params: dict, batch: dict,
                   start: int = 0) -> torch.Tensor:
    """The training forward's f32 logits [W, B, S - start, V] at positions
    ``start``.. of the batch's tokens [W, B, S] (encdec: the decoder's,
    attending to the batch's frames; vlm: text only) — what prefill and
    decode steps fed the same tokens reproduce, position by position."""
    if cfg.family == "encdec":
        h = encdec.decode_seq(cfg, params, batch["tokens"],
                              encdec.encode(cfg, params, batch["frames"]))
    else:
        h = get_model(cfg.family).forward(cfg, params, batch["tokens"])
        if cfg.family == "moe":                  # (hidden states, aux)
            h = h[0]
    return dense.logits_at(cfg, params, h[:, :, start:])


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One-token decode of ``cfg``'s family: tokens [W, B, 1] -> (logits
    [W, B, V] f32, the cache, written in place)."""
    return get_model(cfg.family).decode_step(cfg, params, cache, tokens)
