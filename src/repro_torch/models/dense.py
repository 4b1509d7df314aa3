"""Dense decoder-only GQA transformer (internlm2, nemotron-4, smollm,
gemma3, and qwen2-vl's text backbone): the port of
``repro.models.dense``, for a fleet of W workers at once.

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
runs under ``cfg.remat`` (``remat_block``). The vlm family's training
forward prepends patch embeddings (``extra_embeds``) and rotates by
M-RoPE; its loss counts the text positions only.

Serving: ``prefill`` fills a KV cache — ``k`` / ``v`` ``[W, L, B, cap,
Hkv, hd]``, or for gemma3's groups rolling ``local_k`` / ``local_v``
``[W, G, L_local, B, window, ...]`` and ``tail_k`` / ``tail_v`` of the
window and full ``global_k`` / ``global_v`` ``[W, G, B, cap, ...]`` —
plus ``len`` (a 0-d int32 tensor), named as the reference's cache tree.
Its self-attention takes ``layers.pick_attn_fn`` where the training
forward does (the flash kernel with ``use_flash_kernel``; the
reference's prefill always runs the plain composition, the same function
within the kernel's tolerance). ``decode_step`` writes each layer's new
K / V into the cache in place and returns the same dict (the reference
returns a new tree); it reads ``len`` as a Python int, one host sync a
step. Serving runs under ``torch.no_grad``.
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


def init(cfg: ModelConfig, generator: torch.Generator,
         dtypes: dict) -> dict:
    """One worker's parameters, drawn from ``generator`` (the
    reference's init laws: normal / sqrt(fan_in) weights, 0.02 normal
    embeddings, zero norm gains), each cast to ``dtypes[name]``
    as it is drawn."""
    d = cfg.d_model
    p = {"embed": L.embed_init(generator, (cfg.vocab_size, d)),
         "ln_f": torch.zeros(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (d, cfg.vocab_size))
    p = L.cast_leaves(p, dtypes)
    for stack, axes in _stacks(cfg).items():
        p.update(L.stack_blocks(stack, axes,
                                lambda: init_block(generator, cfg), dtypes))
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


def block_kv(cfg: ModelConfig, bp: dict, x, positions, *, window: int,
             mrope_positions=None):
    """x + attn(norm(x)), then + mlp(norm(.)), with one block's
    worker-stacked leaves ``bp``; also returns the attention's
    post-rotation k and v [W * B, S, Hkv, hd] (what prefill caches)."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    h, k, v = L.multi_head_attention(
        L.sub(bp, "attn"), h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        positions=positions, theta=cfg.rope_theta, causal=True,
        window=window, mrope_positions=mrope_positions,
        attn_fn=L.pick_attn_fn(cfg, causal=True, window=window),
        return_kv=True)
    x = x + h
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.apply_mlp(L.sub(bp, "mlp"), h, cfg.act), k, v


def block(cfg: ModelConfig, bp: dict, x, positions, *, window: int,
          mrope_positions=None):
    """``block_kv``'s output alone."""
    return block_kv(cfg, bp, x, positions, window=window,
                    mrope_positions=mrope_positions)[0]


def remat_block(cfg: ModelConfig, bp: dict, x, positions, *, window: int,
                mrope_positions=None):
    """``block`` under the activation-checkpoint policy ``cfg.remat``:
    the reference wraps each block (a group's local and global blocks,
    the tail's, the plain stack's, and the hybrid family's shared
    blocks) this way."""
    return L.remat(lambda h, p: block(cfg, p, h, positions, window=window,
                                      mrope_positions=mrope_positions),
                   cfg)(x, bp)


def attention_half_pieces(cfg: ModelConfig, bps: list, x, positions, *,
                          window: int):
    """x + attn(norm(x)) over a worker's model-axis slots (``bps[j]`` one
    block's leaves on slot j, x [W, B, S, D] on slot 0's device): the
    norm reads slot 0's copy, the attention runs on each slot's heads
    (``layers.attention_pieces``), or once on slot 0's copy where the
    rule keeps the heads whole — the part a dense and a MoE block
    share."""
    hd = cfg.resolved_head_dim
    attn = [L.sub(bp, "attn") for bp in bps]
    h = L.rms_norm(x, bps[0]["ln1"], cfg.norm_eps)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=hd, positions=positions, theta=cfg.rope_theta,
              window=window,
              attn_fn=L.pick_attn_fn(cfg, causal=True, window=window))
    if attn[0]["wq"].shape[-1] == cfg.num_heads * hd:
        return x + L.multi_head_attention(attn[0], h, causal=True, **kw)
    return x + L.attention_pieces(
        attn, h, kv_whole=attn[0]["wk"].shape[-1] == cfg.num_kv_heads * hd,
        **kw)


def block_pieces(cfg: ModelConfig, bps: list, x, positions, *,
                 window: int):
    """``block`` over a worker's model-axis slots (tensor parallelism by
    the spec rules): ``bps[j]`` one block's leaves on slot j ([W, ...]
    pieces on its device), x [W, B, S, D] on slot 0's. The norms read
    slot 0's copy (every slot holds them whole); the attention runs on
    each slot's heads (``attention_half_pieces``) and the MLP on each
    slot's d_ff columns, column-parallel in and row-parallel out, the
    slots' outputs added (``layers.slot_sum``). A part whose leaves the
    rule keeps whole (heads or d_ff that do not divide m) runs once, on
    slot 0's copy."""
    home = x.device
    x = attention_half_pieces(cfg, bps, x, positions, window=window)
    h = L.rms_norm(x, bps[0]["ln2"], cfg.norm_eps)
    mlp = [L.sub(bp, "mlp") for bp in bps]
    if mlp[0]["w_up"].shape[-1] == cfg.d_ff:
        return x + L.apply_mlp(mlp[0], h, cfg.act)
    # under remat its recompute, which stops at the block's last saved
    # activation (the last slot's w_down input), redoes the other slots'
    # w_down products: m - 1 of them a block, which the unsplit block skips
    return x + L.slot_sum([L.apply_mlp(mp, h.to(mp["w_up"].device), cfg.act)
                           for mp in mlp], home)


def loss_fn_pieces(cfg: ModelConfig, slots: list, batch: dict):
    """``loss_fn`` of a worker's replica held over its model-axis slots
    (``within_worker="tp"``): ``slots[j]`` slot j's leaves {name: [W,
    *piece]} in their storage dtypes on its device (``core/modelspec.
    SlotAdapter``'s views), a piece where the spec rules split the leaf
    and the whole leaf where they keep it whole; the batch [W, B, S] on
    slot 0's device, whole (every slot reads it). The embedding and the
    head split over the vocabulary (``layers.embed_pieces``, the loss's
    logsumexp over the slots' pieces), each block by ``block_pieces``
    under ``cfg.remat``. A leaf every slot holds whole is read from slot
    0's copy, so its gradient lands there once (the caller copies it to
    the other slots). Returns (loss [W], {"tokens": count [W]}) on slot
    0's device."""
    L.check_trainable(cfg)
    tokens = batch["tokens"]
    x = L.embed_slots(slots, tokens, cfg.vocab_size)
    positions = torch.arange(tokens.shape[2], device=tokens.device)
    for stack, idx, window in layer_order(cfg):
        x = L.remat(lambda h, ps, w=window: block_pieces(
            cfg, ps, h, positions, window=w), cfg)(
            x, [L.layer(p, stack, idx) for p in slots])
    h = L.rms_norm(x, slots[0]["ln_f"], cfg.norm_eps)
    loss, cnt = L.xent_slots(slots, h, batch, vocab_size=cfg.vocab_size,
                             tie_embeddings=cfg.tie_embeddings)
    return loss, {"tokens": cnt}


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers one forward pass runs (every layer attends; on a
    model axis, the layers each slot runs on its own heads)."""
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


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            mrope_positions=None, extra_embeds=None):
    """Full forward to final hidden states: tokens [W, B, S] int ->
    [W, B, S', D]. The vlm inputs: ``extra_embeds`` [W, B, S_vis, D]
    (patch embeddings, prepended: S' = S_vis + S) and
    ``mrope_positions`` [3, W, B, S'] (M-RoPE in place of RoPE; the
    reference passes them to the ungrouped stack only)."""
    L.check_trainable(cfg)
    x = L.embed(params["embed"], tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=2)
    wn, b, s = x.shape[:3]
    positions = torch.arange(s, device=tokens.device)
    mp = None
    if mrope_positions is not None and not cfg.global_every:
        mp = mrope_positions.reshape(3, wn * b, s)
    for stack, idx, window in layer_order(cfg):
        x = remat_block(cfg, L.layer(params, stack, idx), x, positions,
                        window=window, mrope_positions=mp)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def head_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """The [W, D, V] output projection (the embedding's transpose when
    tied)."""
    return (params["embed"].transpose(1, 2) if cfg.tie_embeddings
            else params["lm_head"])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, count=None):
    """Per-worker next-token loss: batch ``tokens`` and ``labels`` [W, B,
    S] (optional ``loss_mask``) -> (loss [W], {"tokens": count [W]}).
    A vlm batch adds ``vision_embeds`` [W, B, S_vis, D] and
    ``mrope_positions`` [W, B, 3, S_vis + S]; the loss reads the text
    positions only. ``count`` [W]: the token count the loss sum is
    divided by (``layers.chunked_softmax_xent``; default the batch's
    own)."""
    mp = batch.get("mrope_positions")
    if mp is not None:                    # stored batch-leading [.., 3, S]
        mp = torch.movedim(mp, -2, 0)
    h = forward(cfg, params, batch["tokens"], mrope_positions=mp,
                extra_embeds=batch.get("vision_embeds"))
    if "vision_embeds" in batch:
        h = h[:, :, batch["vision_embeds"].shape[2]:]
    loss, cnt = L.chunked_softmax_xent(h, head_matrix(cfg, params),
                                       batch["labels"].long(),
                                       batch.get("loss_mask"), count=count)
    return loss, {"tokens": cnt}


def logits_at(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """f32 logits of final hidden states h [W, B, S, D] -> [W, B, S, V]
    (every family's head: the embedding's transpose when tied, else
    ``lm_head``)."""
    return L.matmul(h, head_matrix(cfg, params)).float()


# ---------------------------------------------------------------------------
# Serving: prefill and single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               num_workers: int = 1, device=None) -> dict:
    """A zero cache of capacity ``max_len`` (the window for sliding-window
    layers) in ``cfg.dtype``, ``len`` 0."""
    dt = L.dtype_of(cfg.dtype)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    w = cfg.sliding_window or max_len

    def kv(*axes):
        return torch.zeros((num_workers, *axes, hkv, hd), dtype=dt,
                           device=device)

    if cfg.global_every:
        g, lpg, tail = _group_shape(cfg)
        cache = {"local_k": kv(g, lpg, batch, w),
                 "local_v": kv(g, lpg, batch, w),
                 "global_k": kv(g, batch, max_len),
                 "global_v": kv(g, batch, max_len)}
        if tail:
            cache["tail_k"] = kv(tail, batch, w)
            cache["tail_v"] = kv(tail, batch, w)
    else:
        cache = {"k": kv(cfg.num_layers, batch, w),
                 "v": kv(cfg.num_layers, batch, w)}
    cache["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def layer_cache(cache: dict, stack: str, idx: tuple[int, ...]):
    """One layer's (k, v) cache views [W, B, C, Hkv, hd]."""
    pre = "" if stack == "blocks" else f"{stack}_"
    at = (slice(None),) + idx
    return cache[pre + "k"][at], cache[pre + "v"][at]


def fill_cache(dst: torch.Tensor, kv: torch.Tensor, rolling: bool) -> None:
    """Write a prompt's k or v [W, B, S, ...] into one layer's cache view
    ``dst`` [W, B, C, ...] in place: a full cache takes positions 0..S-1
    in its first S slots; a rolling one (C the window) the last C
    positions, position p in slot p mod C (the reference's
    ``_to_window_cache``), or all S in the first slots while S < C."""
    s, c = kv.shape[2], dst.shape[2]
    if rolling and s >= c:
        dst.copy_(torch.roll(kv[:, :, s - c:], shifts=s % c, dims=2))
    else:
        dst[:, :, :s] = kv


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int = 0):
    """Prefill: tokens [W, B, S] -> (the last position's logits [W, B, V]
    f32, the cache filled for S positions, of capacity ``max_len``, S
    when 0; pass S + the tokens to generate)."""
    wn, b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, num_workers=wn,
                       device=tokens.device)
    positions = torch.arange(s, device=tokens.device)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = L.embed(params["embed"], tokens)
    for stack, idx, window in layer_order(cfg):
        x, k, v = block_kv(cfg, L.layer(params, stack, idx), x, positions,
                           window=window)
        for dst, src in zip(layer_cache(cache, stack, idx), (k, v)):
            fill_cache(dst, src.reshape(wn, b, s, hkv, hd), bool(window))
    x = L.rms_norm(x[:, :, -1:], params["ln_f"], cfg.norm_eps)
    cache["len"].fill_(s)
    return logits_at(cfg, params, x)[:, :, 0], cache


def decode_attention_half(cfg: ModelConfig, bp: dict, x, ck, cv, n: int,
                          pos, window: int = 0):
    """One token's x + attn(norm(x)) against one layer's cache views
    (``layers.decode_attention``, written in place) — the part a dense,
    a MoE and a shared hybrid block share."""
    a = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    return x + L.decode_attention(
        L.sub(bp, "attn"), a, ck, cv, n, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        positions=pos, theta=cfg.rope_theta, window=window)


def decode_block(cfg: ModelConfig, bp: dict, x, ck, cv, n: int, pos,
                 window: int = 0):
    """``decode_attention_half``, then + mlp(norm(.))."""
    x = decode_attention_half(cfg, bp, x, ck, cv, n, pos, window)
    m = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.apply_mlp(L.sub(bp, "mlp"), m, cfg.act)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One-token decode: tokens [W, B, 1] -> (logits [W, B, V] f32, the
    cache), the new K / V written into ``cache`` in place and ``len``
    advanced by one."""
    n = int(cache["len"])
    x = L.embed(params["embed"], tokens)
    pos = torch.tensor([n], device=x.device)
    for stack, idx, window in layer_order(cfg):
        x = decode_block(cfg, L.layer(params, stack, idx), x,
                         *layer_cache(cache, stack, idx), n, pos, window)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["len"] += 1
    return logits_at(cfg, params, x)[:, :, 0], cache
