"""Zamba2-style hybrid: a Mamba2 backbone with shared attention blocks —
the port of ``repro.models.hybrid``, for a fleet of W workers at once.

``num_layers`` Mamba2 blocks; after every ``ssm_every`` of them one of
TWO shared attention + MLP blocks fires (parameters reused across
invocations, alternating A / B by group parity), then the tail Mamba2
blocks. Leaves, worker-stacked as in ``models/dense.py``: ``mamba/...``
``[W, G, ssm_every, ...]``, ``shared/...`` ``[W, 2, ...]`` (both shared
blocks are leaves even when one group runs only block A: the unused one
gets a zero gradient, but it still gossips and counts in P) and
``tail/...`` ``[W, tail, ...]``.

Every block, Mamba2 or shared, runs under ``cfg.remat``.

Serving's cache, named as the reference's tree: ``mamba/state`` ``[W,
G, ssm_every, B, H, n, p]`` (f32) and ``mamba/conv`` ``[W, G, ssm_every,
B, 3, C]``, ``tail/state`` and ``tail/conv`` ``[W, tail, ...]``, a full
KV cache ``attn_k`` / ``attn_v`` ``[W, G, B, cap, Hkv, hd]`` per shared
block invocation (parameters shared, caches not) and ``len``; updated
in place (``models/dense.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models import ssm

NUM_SHARED = 2
# leaves stored in f32 whatever cfg.dtype says: the Mamba2 blocks' decay
# rates, dt biases and skips (registry.leaf_dtypes)
F32_LEAVES = ssm.F32_LEAVES


def _group_shape(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_groups, mamba_per_group, tail_mamba)."""
    if not cfg.ssm_every:
        return 0, 0, cfg.num_layers
    g = cfg.num_layers // cfg.ssm_every
    return g, cfg.ssm_every, cfg.num_layers - g * cfg.ssm_every


def _mamba_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    out = {"ln": (cfg.d_model,)}
    out.update({f"mamba/{k}": v for k, v in
                ssm.mamba2_shapes(cfg.d_model, cfg.ssm_state).items()})
    return out


def _stacks(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], dict]]:
    """Each block stack's name, stacked layer axes and block leaf shapes."""
    g, mpg, tail = _group_shape(cfg)
    out = {}
    if g:
        out["mamba"] = ((g, mpg), _mamba_shapes(cfg))
        out["shared"] = ((NUM_SHARED,), dense.block_shapes(cfg))
    if tail:
        out["tail"] = ((tail,), _mamba_shapes(cfg))
    return out


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes by ``"/"``-joined name."""
    out = {"embed": (cfg.vocab_size, cfg.d_model), "ln_f": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for stack, (axes, shapes) in _stacks(cfg).items():
        for leaf, shape in shapes.items():
            out[f"{stack}/{leaf}"] = axes + shape
    return out


def _init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    blk = {"ln": torch.zeros(cfg.d_model)}
    blk.update({f"mamba/{k}": v for k, v in
                ssm.init_mamba2(gen, cfg.d_model, cfg.ssm_state).items()})
    return blk


def init(cfg: ModelConfig, generator: torch.Generator,
         dtypes: dict) -> dict:
    """One worker's parameters, drawn from ``generator`` (the reference's
    init laws), each cast to ``dtypes[name]``."""
    d = cfg.d_model
    p = {"embed": L.embed_init(generator, (cfg.vocab_size, d)),
         "ln_f": torch.zeros(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (d, cfg.vocab_size))
    p = L.cast_leaves(p, dtypes)
    make = {"mamba": _init_mamba_block, "shared": dense.init_block,
            "tail": _init_mamba_block}
    for stack, (axes, _) in _stacks(cfg).items():
        p.update(L.stack_blocks(stack, axes,
                                lambda: make[stack](generator, cfg), dtypes))
    return p


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers one forward pass runs: one shared block a group."""
    return _group_shape(cfg)[0]


def activation_floats(cfg: ModelConfig, seq_len: int) -> int:
    """The floats one token's forward keeps for the backward pass, about:
    every Mamba2 block's (``ssm.mamba2_floats``) and every group's shared
    attention + MLP block's (``dense.attention_block_floats``)."""
    g = _group_shape(cfg)[0]
    return (cfg.num_layers * ssm.mamba2_floats(cfg.d_model, cfg.ssm_state,
                                                seq_len)
            + g * dense.attention_block_floats(cfg, cfg.d_ff))


def _mamba_block(cfg: ModelConfig, bps: list, h):
    """h + Mamba2(norm(h)) over a worker's model-axis slots (``bps[j]``
    one block's leaves on slot j; ``ssm.mamba2_pieces``)."""
    x = L.rms_norm(h, bps[0]["ln"], cfg.norm_eps)
    return h + ssm.mamba2_pieces([L.sub(bp, "mamba") for bp in bps], x,
                                 cfg.ssm_state)


def forward_pieces(cfg: ModelConfig, slots: list, tokens: torch.Tensor):
    """The forward of a worker's replica held over its model-axis slots
    (``dense.loss_fn_pieces``' layout: ``slots[j]`` slot j's leaves, one
    slot for an unsplit replica; tokens [W, B, S] on slot 0's device):
    the embedding over the vocabulary pieces (``layers.embed_slots``),
    each Mamba2 block by ``ssm.mamba2_pieces`` and each shared block (a
    dense block with full attention) by ``dense.block_pieces``, every
    block under ``cfg.remat``; a leaf every slot holds whole (the norms,
    ``a_log``, ``dt_bias``, ...) is read from slot 0's copy. Returns the
    final hidden states [W, B, S, D] on slot 0's device."""
    L.check_trainable(cfg)
    x = L.embed_slots(slots, tokens, cfg.vocab_size)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    mamba = L.remat(lambda h, bps: _mamba_block(cfg, bps, h), cfg)
    shared = L.remat(lambda h, bps: dense.block_pieces(
        cfg, bps, h, positions, window=0), cfg)
    for stack, idx, gi in _mamba_layers(cfg):
        x = mamba(x, [L.layer(p, stack, idx) for p in slots])
        if gi is not None:
            x = shared(x, [L.layer(p, "shared", (gi % NUM_SHARED,))
                           for p in slots])
    return L.rms_norm(x, slots[0]["ln_f"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full forward to final hidden states: tokens [W, B, S] int ->
    [W, B, S, D]."""
    return forward_pieces(cfg, [params], tokens)


def loss_fn_pieces(cfg: ModelConfig, slots: list, batch: dict):
    """``loss_fn`` of a worker's replica held over its model-axis slots
    (``forward_pieces``, the head over the vocabulary pieces by
    ``layers.xent_slots``) -> (loss [W], {"tokens": count [W]}) on slot
    0's device."""
    h = forward_pieces(cfg, slots, batch["tokens"])
    loss, cnt = L.xent_slots(slots, h, batch, vocab_size=cfg.vocab_size,
                             tie_embeddings=cfg.tie_embeddings)
    return loss, {"tokens": cnt}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Per-worker next-token loss: batch ``tokens`` and ``labels`` [W, B,
    S] (optional ``loss_mask``) -> (loss [W], {"tokens": count [W]})."""
    return loss_fn_pieces(cfg, [params], batch)


# ---------------------------------------------------------------------------
# Serving: prefill and single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               num_workers: int = 1, device=None) -> dict:
    """A zero cache: Mamba2 states and contexts for every block, a KV
    cache of capacity ``max_len`` for every shared-block invocation,
    ``len`` 0."""
    dt = L.dtype_of(cfg.dtype)
    g, mpg, tail = _group_shape(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {}
    for stack, lead in (("mamba", (g, mpg)), ("tail", (tail,))):
        if lead[0]:
            m = ssm.init_mamba2_cache(batch, cfg.d_model, cfg.ssm_state, dt,
                                      lead=(num_workers, *lead),
                                      device=device)
            cache.update({f"{stack}/{k}": v for k, v in m.items()})
    if g:
        for kv in ("attn_k", "attn_v"):
            cache[kv] = torch.zeros((num_workers, g, batch, max_len, hkv,
                                     hd), dtype=dt, device=device)
    cache["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _mamba_layers(cfg: ModelConfig):
    """The Mamba2 blocks in the reference's order, each with the shared
    block invocation that follows it (its group index, else None):
    (stack, index, group after)."""
    g, mpg, tail = _group_shape(cfg)
    for gi in range(g):
        for j in range(mpg):
            yield "mamba", (gi, j), (gi if j == mpg - 1 else None)
    for j in range(tail):
        yield "tail", (j,), None


def _mamba_cache(cache: dict, stack: str, idx: tuple[int, ...]):
    at = (slice(None),) + idx
    return cache[f"{stack}/state"][at], cache[f"{stack}/conv"][at]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int = 0):
    """Prefill: tokens [W, B, S] -> (the last position's logits [W, B, V]
    f32, the cache: every Mamba2 block's final state and context, and
    the shared blocks' K / V for S positions, of capacity ``max_len``, S
    when 0)."""
    wn, b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, num_workers=wn,
                       device=tokens.device)
    positions = torch.arange(s, device=tokens.device)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = L.embed(params["embed"], tokens)
    for stack, idx, gi in _mamba_layers(cfg):
        bp = L.layer(params, stack, idx)
        a = L.rms_norm(x, bp["ln"], cfg.norm_eps)
        x = x + ssm.prefill_mamba2(L.sub(bp, "mamba"), a, cfg.ssm_state,
                                   *_mamba_cache(cache, stack, idx))
        if gi is not None:
            x, k, v = dense.block_kv(
                cfg, L.layer(params, "shared", (gi % NUM_SHARED,)), x,
                positions, window=0)
            for kv, src in (("attn_k", k), ("attn_v", v)):
                dense.fill_cache(cache[kv][:, gi],
                                 src.reshape(wn, b, s, hkv, hd), False)
    x = L.rms_norm(x[:, :, -1:], params["ln_f"], cfg.norm_eps)
    cache["len"].fill_(s)
    return dense.logits_at(cfg, params, x)[:, :, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One-token decode: tokens [W, B, 1] -> (logits [W, B, V] f32, the
    cache advanced in place)."""
    n = int(cache["len"])
    x = L.embed(params["embed"], tokens)
    pos = torch.tensor([n], device=x.device)
    for stack, idx, gi in _mamba_layers(cfg):
        bp = L.layer(params, stack, idx)
        a = L.rms_norm(x, bp["ln"], cfg.norm_eps)
        x = x + ssm.decode_mamba2(L.sub(bp, "mamba"), a,
                                  *_mamba_cache(cache, stack, idx),
                                  cfg.ssm_state)
        if gi is not None:
            x = dense.decode_block(
                cfg, L.layer(params, "shared", (gi % NUM_SHARED,)), x,
                cache["attn_k"][:, gi], cache["attn_v"][:, gi], n, pos)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["len"] += 1
    return dense.logits_at(cfg, params, x)[:, :, 0], cache
