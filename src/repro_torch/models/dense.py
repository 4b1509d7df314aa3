"""Dense decoder-only GQA transformer (internlm2, nemotron-4, smollm,
gemma3): the port of ``repro.models.dense``'s training forward, for a
fleet of W workers at once.

Parameters are a flat dict of ``"/"``-joined leaf names — the
reference's nested pytree paths, e.g. ``"blocks/attn/wq"`` — each leaf
worker-stacked ``[W, ...]`` with the reference's stacked layer axes:
``blocks/...`` ``[W, L, ...]``, or for gemma3's 5:1 local:global pattern
``local/...`` ``[W, G, L_local, ...]``, ``global/...`` ``[W, G, ...]``
and ``tail/...`` ``[W, tail, ...]`` (groups of local sliding-window
layers each followed by one global layer, then the leftover local
layers). The layers run as a Python loop over those stacks, in the
reference's scan order.

Leaves are stored in ``cfg.dtype`` (none stays f32) and every block
runs under ``cfg.remat`` (``remat_block``).

Serving (``prefill``, ``decode_step``, ``init_cache``) waits for
ROADMAP.md queue 1, item 4.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# leaves stored in f32 whatever cfg.dtype says (registry.leaf_dtypes)
F32_LEAVES = frozenset()


def _group_shape(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_groups, locals_per_group, tail_locals)."""
    if not cfg.global_every:
        return 0, 0, 0
    ge = cfg.global_every
    return cfg.num_layers // ge, ge - 1, cfg.num_layers % ge


def _stacks(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Each block stack's name and its stacked layer axes."""
    if not cfg.global_every:
        return {"blocks": (cfg.num_layers,)}
    g, lpg, tail = _group_shape(cfg)
    out = {"global": (g,), "local": (g, lpg)}
    if tail:
        out["tail"] = (tail,)
    return out


def block_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One attention + MLP block's leaf shapes (also the hybrid family's
    shared blocks)."""
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    out = {"attn/wk": (d, kvd), "attn/wo": (qd, d), "attn/wq": (d, qd),
           "attn/wv": (d, kvd), "ln1": (d,), "ln2": (d,),
           "mlp/w_down": (ff, d), "mlp/w_up": (d, ff)}
    if cfg.act in ("silu", "gelu"):
        out["mlp/w_gate"] = (d, ff)
    return out


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes by ``"/"``-joined name."""
    out = {"embed": (cfg.vocab_size, cfg.d_model), "ln_f": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for stack, axes in _stacks(cfg).items():
        for leaf, shape in block_shapes(cfg).items():
            out[f"{stack}/{leaf}"] = axes + shape
    return out


def init_attention_half(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One worker's block norms and attention, by the reference's init
    laws: the part a dense and a MoE block share, drawn first."""
    d = cfg.d_model
    blk = {"ln1": torch.zeros(d), "ln2": torch.zeros(d)}
    attn = L.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    blk.update({f"attn/{k}": v for k, v in attn.items()})
    return blk


def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One worker's attention + MLP block, by the reference's init laws."""
    blk = init_attention_half(gen, cfg)
    mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act)
    blk.update({f"mlp/{k}": v for k, v in mlp.items()})
    return blk


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """One worker's parameters, drawn from ``generator`` (the
    reference's init laws: normal / sqrt(fan_in) weights, 0.02 normal
    embeddings, zero norm gains)."""
    d = cfg.d_model
    p = {"embed": L.embed_init(generator, (cfg.vocab_size, d)),
         "ln_f": torch.zeros(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (d, cfg.vocab_size))
    for stack, axes in _stacks(cfg).items():
        p.update(L.stack_blocks(stack, axes,
                                lambda: init_block(generator, cfg)))
    return p


def layer_order(cfg: ModelConfig):
    """The forward's layers in the reference's scan order: (stack, index
    into its layer axes, sliding window)."""
    if not cfg.global_every:
        for i in range(cfg.num_layers):
            yield "blocks", (i,), cfg.sliding_window
        return
    g, lpg, tail = _group_shape(cfg)
    for gi in range(g):
        for j in range(lpg):
            yield "local", (gi, j), cfg.sliding_window
        yield "global", (gi,), 0
    for j in range(tail):
        yield "tail", (j,), cfg.sliding_window


def block(cfg: ModelConfig, bp: dict, x, positions, *, window: int):
    """x + attn(norm(x)), then + mlp(norm(.)), with one block's
    worker-stacked leaves ``bp``."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    h = L.multi_head_attention(
        L.sub(bp, "attn"), h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        positions=positions, theta=cfg.rope_theta, causal=True,
        window=window,
        attn_fn=L.pick_attn_fn(cfg, causal=True, window=window))
    x = x + h
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.apply_mlp(L.sub(bp, "mlp"), h, cfg.act)


def remat_block(cfg: ModelConfig, bp: dict, x, positions, *, window: int):
    """``block`` under the activation-checkpoint policy ``cfg.remat``:
    the reference wraps each block (a group's local and global blocks,
    the tail's, the plain stack's, and the hybrid family's shared
    blocks) this way."""
    return L.remat(lambda h, p: block(cfg, p, h, positions, window=window),
                   cfg)(x, bp)


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers one forward pass runs (every layer attends)."""
    return cfg.num_layers


def activation_floats(cfg: ModelConfig, seq_len: int) -> int:
    """The floats one token's forward keeps for the backward pass, about:
    per layer the norms' inputs and outputs, q, k and v before and after
    RoPE, the attention output and the MLP's four [d_ff]
    intermediates."""
    return cfg.num_layers * attention_block_floats(cfg, cfg.d_ff)


def attention_block_floats(cfg: ModelConfig, d_ff: int) -> int:
    """``activation_floats`` of one attention + MLP block (MLP width
    ``d_ff``; 0 for the attention half alone)."""
    hd = cfg.resolved_head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return 8 * cfg.d_model + 3 * qd + 3 * kvd + 4 * d_ff


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full forward to final hidden states: tokens [W, B, S] int ->
    [W, B, S, D]."""
    L.check_trainable(cfg)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    for stack, idx, window in layer_order(cfg):
        x = remat_block(cfg, L.layer(params, stack, idx), x, positions,
                        window=window)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def head_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """The [W, D, V] output projection (the embedding's transpose when
    tied)."""
    return (params["embed"].transpose(1, 2) if cfg.tie_embeddings
            else params["lm_head"])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Per-worker next-token loss: batch ``tokens`` and ``labels`` [W, B,
    S] (optional ``loss_mask``) -> (loss [W], {"tokens": count [W]})."""
    h = forward(cfg, params, batch["tokens"])
    loss, cnt = L.chunked_softmax_xent(h, head_matrix(cfg, params),
                                       batch["labels"].long(),
                                       batch.get("loss_mask"))
    return loss, {"tokens": cnt}
