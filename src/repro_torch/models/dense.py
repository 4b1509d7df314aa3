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

Serving (``prefill``, ``decode_step``, ``init_cache``) waits for
ROADMAP.md queue 1, item 10.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_BLOCK_LEAVES = ("attn/wk", "attn/wo", "attn/wq", "attn/wv", "ln1", "ln2",
                 "mlp/w_down", "mlp/w_gate", "mlp/w_up")


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


def _block_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
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
        for leaf, shape in _block_shapes(cfg).items():
            out[f"{stack}/{leaf}"] = axes + shape
    return out


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
        n = 1
        for a in axes:
            n *= a
        blocks = []
        for _ in range(n):
            blk = {"ln1": torch.zeros(d), "ln2": torch.zeros(d)}
            attn = L.init_attention(generator, d, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.resolved_head_dim)
            mlp = L.init_mlp(generator, d, cfg.d_ff, cfg.act)
            blk.update({f"attn/{k}": v for k, v in attn.items()})
            blk.update({f"mlp/{k}": v for k, v in mlp.items()})
            blocks.append(blk)
        for leaf in blocks[0]:
            p[f"{stack}/{leaf}"] = torch.stack(
                [blk[leaf] for blk in blocks]).reshape(
                    axes + tuple(blocks[0][leaf].shape))
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


def _block(cfg: ModelConfig, bp: dict, x, positions, *, window: int):
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    h = L.multi_head_attention(
        {k[len("attn/"):]: v for k, v in bp.items() if k.startswith("attn/")},
        h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        theta=cfg.rope_theta, causal=True, window=window,
        attn_fn=L.pick_attn_fn(cfg, causal=True, window=window))
    x = x + h
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    mlp = {k[len("mlp/"):]: v for k, v in bp.items() if k.startswith("mlp/")}
    return x + L.apply_mlp(mlp, h, cfg.act)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full forward to final hidden states: tokens [W, B, S] int ->
    [W, B, S, D]."""
    L.check_trainable(cfg)
    wn, _, s = tokens.shape
    embed = params["embed"]
    rows = torch.arange(wn, device=tokens.device)[:, None, None]
    x = embed[rows, tokens.long()]
    positions = torch.arange(s, device=tokens.device)
    for stack, idx, window in layer_order(cfg):
        bp = {leaf: params[f"{stack}/{leaf}"][(slice(None),) + idx]
              for leaf in _BLOCK_LEAVES if f"{stack}/{leaf}" in params}
        x = _block(cfg, bp, x, positions, window=window)
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
