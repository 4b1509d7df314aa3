"""Mixture-of-Experts decoder (olmoe-1b-7b, kimi-k2-1t-a32b): the port of
``repro.models.moe``, for a fleet of W workers at once.

Routing is the reference's sort-based "dropped" capacity MoE, per
worker: each worker routes its own T = B * S tokens (capacity C =
ceil(k T / E * 1.25) from that T), its token -> expert assignments are
sorted by expert id (a stable sort, as ``jnp.argsort``), packed into
its own ``[E * C + 1, d]`` buffer — the last row takes every write past
capacity and is sliced away — and contracted with its own experts
``[E, d, d_ff]`` in one batched product over (worker, expert). Overflow
tokens are dropped and scattered back as zeros.

Leaves are stored in ``cfg.dtype`` but the router (f32); the dispatch
buffers take the activations' dtype and every block runs under
``cfg.remat``.

Parameters are the flat dict of ``"/"``-joined leaf names of
``models/dense.py``, worker-stacked ``[W, ...]``; ``blocks/...`` carry
the stacked layer axis ``[W, L, ...]`` and the layers run as a Python
loop in the reference's scan order.

Serving keeps the dense family's cache (``k`` / ``v`` ``[W, L, B, cap,
Hkv, hd]`` and ``len``, written in place, ``models/dense.py``); a decode
step routes its B tokens with capacity ``capacity(B, E, k)``, as the
reference does.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25
# leaves stored in f32 whatever cfg.dtype says: the router, whose product
# the reference takes in f32 (registry.leaf_dtypes)
F32_LEAVES = frozenset({"router"})


# ---------------------------------------------------------------------------
# MoE FFN layer
# ---------------------------------------------------------------------------

def _ffn_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d, e = cfg.d_model, cfg.num_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    out = {"router": (d, e), "w_down": (e, dff, d), "w_gate": (e, d, dff),
           "w_up": (e, d, dff)}
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * dff
        out.update({"shared/w_down": (sff, d), "shared/w_up": (d, sff)})
        if cfg.act in ("silu", "gelu"):
            out["shared/w_gate"] = (d, sff)
    return out


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One worker's router, experts and (with ``num_shared_experts``) its
    shared expert MLP, by ``"/"``-joined name."""
    d, e = cfg.d_model, cfg.num_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": L.dense_init(gen, (d, e), scale=0.02),
         "w_gate": L.dense_init(gen, (e, d, dff)),
         "w_up": L.dense_init(gen, (e, d, dff)),
         "w_down": L.dense_init(gen, (e, dff, d))}
    if cfg.num_shared_experts:
        mlp = L.init_mlp(gen, d, cfg.num_shared_experts * dff, cfg.act)
        p.update({f"shared/{k}": v for k, v in mlp.items()})
    return p


@contextlib.contextmanager
def capacity_factor(factor: float):
    """Route with ``factor`` in place of ``CAPACITY_FACTOR`` while the
    block runs. At E / k no expert drops a token: what a check needs
    that compares two routings of the same tokens, since a decode step
    routes its B tokens with C(B) and the training forward all B S with
    C(B S), so at 1.25 the two drop different tokens by design (the
    reference's)."""
    global CAPACITY_FACTOR
    old, CAPACITY_FACTOR = CAPACITY_FACTOR, factor
    try:
        yield
    finally:
        CAPACITY_FACTOR = old


def capacity(tokens: int, num_experts: int, k: int) -> int:
    """Expert capacity C = max(1, ceil(k T / E * CAPACITY_FACTOR))."""
    return max(1, math.ceil(k * tokens / num_experts * CAPACITY_FACTOR))


def apply_moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  experts_fn=None, shared_fn=None):
    """x [W, B, S, d] -> ([W, B, S, d], aux loss [W]).

    ``cfg.moe_shard_groups`` G > 0 routes each worker's tokens within G
    independent groups of T / G tokens (capacity per group), when G
    divides T = B * S; the aux loss is the groups' mean. ``experts_fn``
    and ``shared_fn`` replace the expert products and the shared expert
    (``_moe_ffn_flat``; ``moe_ffn_pieces``)."""
    wn, b, s, d = x.shape
    groups = cfg.moe_shard_groups
    kw = dict(experts_fn=experts_fn, shared_fn=shared_fn)
    if groups and (b * s) % groups == 0:
        y, aux = _moe_ffn_flat(p, x.reshape(wn, groups, (b * s) // groups,
                                            d), cfg, **kw)
        return y.reshape(wn, b, s, d), aux.mean(dim=1)
    y, aux = _moe_ffn_flat(p, x.reshape(wn, 1, b * s, d), cfg, **kw)
    return y.reshape(wn, b, s, d), aux[:, 0]


def expert_products(p: dict, h: torch.Tensor, act: str) -> torch.Tensor:
    """The experts' FFN on their rows of the dispatch buffer: h [W, E', R,
    d] the rows of E' experts, ``p``'s ``w_gate`` / ``w_up`` [W, E', d,
    d_ff] and ``w_down`` [W, E', d_ff, d] -> [W, E', R, d], one batched
    product over (worker, expert)."""
    wn, e, r, d = h.shape
    dff = p["w_gate"].shape[-1]
    f = L.act_fn(act)
    h = h.reshape(wn * e, r, d)
    a = f(torch.bmm(h, p["w_gate"].reshape(wn * e, d, dff))) \
        * torch.bmm(h, p["w_up"].reshape(wn * e, d, dff))
    return torch.bmm(a, p["w_down"].reshape(wn * e, dff, d)) \
        .reshape(wn, e, r, d)


def _moe_ffn_flat(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  experts_fn=None, shared_fn=None):
    """Routing groups x [W, G, T, d] (each group of each worker routes its
    own T tokens) -> (y [W, G, T, d], aux loss [W, G]). ``experts_fn(h)``
    maps the dispatch buffer h [W, E, G C, d] (each expert's rows, a
    worker's groups side by side) to the experts' outputs, by default
    ``expert_products`` of ``p``'s; ``shared_fn(x)`` the shared expert's
    output on the tokens x [W, G T, d], by default ``p``'s
    ``shared/*`` MLP where it has one."""
    wn, ng, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = capacity(t, e, k)
    n = wn * ng
    xw = x.reshape(wn, ng * t, d)

    logits = L.matmul(xw.to(torch.float32), p["router"])     # [W, G T, E]
    probs = torch.softmax(logits, dim=-1).reshape(n, t, e)
    gate, eidx = torch.topk(probs, k, dim=-1)                 # [N, T, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style); ce is a count and
    # carries no gradient, which flows through me
    me = probs.mean(dim=1)                                    # [N, E]
    flat_e = eidx.reshape(n, t * k)
    ce = torch.zeros(n, e, dtype=probs.dtype, device=x.device).scatter_add_(
        1, flat_e, torch.ones(flat_e.shape, dtype=probs.dtype,
                              device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce, dim=-1)

    # ---- pack: sort assignments by expert, drop beyond capacity ----
    sidx = torch.argsort(flat_e, dim=-1, stable=True)         # [N, T k]
    sorted_e = torch.gather(flat_e, 1, sidx)
    experts = torch.arange(e, device=x.device).expand(n, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts)         # [N, E]
    pos = (torch.arange(t * k, device=x.device)
           - torch.gather(seg_start, 1, sorted_e))
    keep = pos < c
    slot = torch.where(keep, sorted_e * c + torch.clamp(pos, 0, c - 1),
                       e * c)
    src_tok = sidx // k                                       # origin token
    xf = x.reshape(n, t, d)
    rows = torch.gather(xf, 1, src_tok[..., None].expand(n, t * k, d))
    buf = torch.zeros(n, e * c + 1, d, dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(n, t * k, d), rows)

    # ---- expert computation: one batched product over (worker, expert),
    # a worker's groups side by side in its experts' rows ----
    h = (buf[:, :e * c].reshape(wn, ng, e, c, d).transpose(1, 2)
         .reshape(wn, e, ng * c, d))
    o = (expert_products(p, h, cfg.act) if experts_fn is None
         else experts_fn(h))                                  # [W, E, G C, d]
    o = o.reshape(wn, e, ng, c, d).transpose(1, 2).reshape(n, e * c, d)

    # ---- unpack: gather back, unsort, combine with gates ----
    of = torch.cat([o, torch.zeros(n, 1, d, dtype=o.dtype,
                                   device=o.device)], dim=1)
    back = torch.where(keep, slot, e * c)                     # dropped -> 0
    y_rep = torch.gather(of, 1, back[..., None].expand(n, t * k, d))
    y_unsorted = torch.zeros(n, t * k, d, dtype=x.dtype, device=x.device)
    y_unsorted = y_unsorted.scatter(1, sidx[..., None].expand(n, t * k, d),
                                    y_rep)
    y = (y_unsorted.reshape(n, t, k, d)
         * gate[..., None].to(x.dtype)).sum(dim=2)

    if shared_fn is not None:
        y = y + shared_fn(xw).reshape(n, t, d)
    elif "shared/w_up" in p:
        y = y + L.apply_mlp(L.sub(p, "shared"), xw, cfg.act).reshape(n, t, d)
    return y.reshape(wn, ng, t, d), aux.reshape(wn, ng)


def moe_ffn_pieces(ps: list, x: torch.Tensor, cfg: ModelConfig):
    """``apply_moe_ffn`` over a worker's model-axis slots (expert
    parallelism by the spec rules): ``ps[j]`` slot j's MoE leaves ([W,
    ...] on its device), x [W, B, S, d] on slot 0's. The routing — the
    softmax, top-k, the aux loss, the stable sort, the capacity and the
    dispatch buffer — runs once, on slot 0's whole ``router``. Slot j
    runs the products of its experts [j E / m, (j + 1) E / m) on their
    rows of the buffer (a contiguous block: the assignments are sorted by
    expert id), and the outputs are joined in expert order (an
    all-gather: each expert's output is computed once), then unpacked
    and combined on slot 0. The shared expert is column-parallel in and
    row-parallel out, the slots' outputs added (``layers.slot_sum``).
    A part whose leaves the rule keeps whole (experts or a shared d_ff
    that do not divide m) runs once, on slot 0's copy."""
    home, p0 = x.device, ps[0]
    experts_fn = shared_fn = None
    if p0["w_gate"].shape[1] != cfg.num_experts:
        per = p0["w_gate"].shape[1]

        def experts_fn(h):
            return torch.cat([expert_products(
                p, h[:, j * per:(j + 1) * per].to(p["w_gate"].device),
                cfg.act).to(home) for j, p in enumerate(ps)], dim=1)
    dff = cfg.moe_d_ff or cfg.d_ff
    if "shared/w_up" in p0 and \
            p0["shared/w_up"].shape[-1] != cfg.num_shared_experts * dff:
        def shared_fn(xs):
            return L.slot_sum([L.apply_mlp(
                L.sub(p, "shared"), xs.to(p["shared/w_up"].device), cfg.act)
                for p in ps], home)
    return apply_moe_ffn(p0, x, cfg, experts_fn=experts_fn,
                         shared_fn=shared_fn)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _block_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    out = {"attn/wk": (d, kvd), "attn/wo": (qd, d), "attn/wq": (d, qd),
           "attn/wv": (d, kvd), "ln1": (d,), "ln2": (d,)}
    out.update({f"moe/{k}": v for k, v in _ffn_shapes(cfg).items()})
    return out


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes by ``"/"``-joined name."""
    out = {"embed": (cfg.vocab_size, cfg.d_model), "ln_f": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for leaf, shape in _block_shapes(cfg).items():
        out[f"blocks/{leaf}"] = (cfg.num_layers,) + shape
    return out


def _block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    blk = dense.init_attention_half(gen, cfg)
    blk.update({f"moe/{k}": v for k, v in init_moe_ffn(gen, cfg).items()})
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
    p.update(L.stack_blocks("blocks", (cfg.num_layers,),
                            lambda: _block_init(generator, cfg), dtypes))
    return p


def _block_kv(cfg: ModelConfig, bp: dict, x, positions):
    """(x + attn + moe, the aux loss, the attention's post-RoPE k and
    v [W * B, S, Hkv, hd])."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    h, k, v = L.multi_head_attention(
        L.sub(bp, "attn"), h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        positions=positions, theta=cfg.rope_theta, causal=True,
        attn_fn=L.pick_attn_fn(cfg, causal=True, window=0), return_kv=True)
    x = x + h
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    y, aux = apply_moe_ffn(L.sub(bp, "moe"), h, cfg)
    return x + y, aux, k, v


def _block(cfg: ModelConfig, bps: list, x, positions):
    """One block over a worker's model-axis slots (``bps[j]`` its leaves
    on slot j; one slot holds the whole block): the attention half by
    ``dense.attention_half_pieces``, the norms from slot 0's copy, the
    FFN by ``moe_ffn_pieces`` -> (x, the aux loss [W])."""
    x = dense.attention_half_pieces(cfg, bps, x, positions, window=0)
    h = L.rms_norm(x, bps[0]["ln2"], cfg.norm_eps)
    y, aux = moe_ffn_pieces([L.sub(bp, "moe") for bp in bps], h, cfg)
    return x + y, aux


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers one forward pass runs (one a block)."""
    return cfg.num_layers


def activation_floats(cfg: ModelConfig, seq_len: int) -> int:
    """The floats one token's forward keeps for the backward pass, about:
    per layer the attention half of a dense block, the router's logits
    and probabilities, its k gathered rows, their outputs back and the
    unsorted copy, and about 1.25 k expert slots (the [E, C, d] buffer,
    the expert outputs and the three [E, C, d_ff] products), plus the
    shared expert's four intermediates."""
    d, e, k = cfg.d_model, cfg.num_experts, cfg.experts_per_token
    dff = cfg.moe_d_ff or cfg.d_ff
    slots = math.ceil(CAPACITY_FACTOR * k)
    per_layer = (dense.attention_block_floats(cfg, 0) + 2 * e + 3 * k * d
                 + slots * (2 * d + 3 * dff)
                 + 4 * cfg.num_shared_experts * dff)
    return cfg.num_layers * per_layer


def forward_pieces(cfg: ModelConfig, slots: list, tokens: torch.Tensor):
    """The forward of a worker's replica held over its model-axis slots
    (``dense.loss_fn_pieces``' layout: ``slots[j]`` slot j's leaves, one
    slot for an unsplit replica; tokens [W, B, S] on slot 0's device):
    the embedding over the vocabulary pieces (``layers.embed_slots``),
    each block by ``_block`` under ``cfg.remat``; a leaf every slot holds
    whole (the router, the norms) is read from slot 0's copy. Returns
    (final hidden states [W, B, S, D], the layers' mean aux loss [W]) on
    slot 0's device."""
    L.check_trainable(cfg)
    x = L.embed_slots(slots, tokens, cfg.vocab_size)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    block = L.remat(lambda h, bps: _block(cfg, bps, h, positions), cfg)
    auxes = []
    for i in range(cfg.num_layers):
        x, aux = block(x, [L.layer(p, "blocks", (i,)) for p in slots])
        auxes.append(aux)
    return (L.rms_norm(x, slots[0]["ln_f"], cfg.norm_eps),
            torch.stack(auxes).mean(dim=0))


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """tokens [W, B, S] int -> (final hidden states [W, B, S, D], the
    layers' mean aux loss [W])."""
    return forward_pieces(cfg, [params], tokens)


def loss_fn_pieces(cfg: ModelConfig, slots: list, batch: dict):
    """``loss_fn`` of a worker's replica held over its model-axis slots
    (``forward_pieces``, the head over the vocabulary pieces by
    ``layers.xent_slots``) -> (loss + 0.01 x the aux loss [W],
    {"tokens", "aux_loss"}) on slot 0's device."""
    h, aux = forward_pieces(cfg, slots, batch["tokens"])
    loss, cnt = L.xent_slots(slots, h, batch, vocab_size=cfg.vocab_size,
                             tie_embeddings=cfg.tie_embeddings)
    return loss + 0.01 * aux, {"tokens": cnt, "aux_loss": aux}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Per-worker next-token loss plus 0.01 x the aux loss: batch
    ``tokens`` and ``labels`` [W, B, S] -> (loss [W], {"tokens": count
    [W], "aux_loss": [W]})."""
    return loss_fn_pieces(cfg, [params], batch)


# ---------------------------------------------------------------------------
# Serving: prefill and single-token decode
# ---------------------------------------------------------------------------

init_cache = dense.init_cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int = 0):
    """Prefill: tokens [W, B, S] -> (the last position's logits [W, B, V]
    f32, the cache filled for S positions, of capacity ``max_len``, S
    when 0)."""
    wn, b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, num_workers=wn,
                       device=tokens.device)
    positions = torch.arange(s, device=tokens.device)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.num_layers):
        x, _, k, v = _block_kv(cfg, L.layer(params, "blocks", (i,)), x,
                               positions)
        for dst, src in zip(dense.layer_cache(cache, "blocks", (i,)),
                            (k, v)):
            dense.fill_cache(dst, src.reshape(wn, b, s, hkv, hd), False)
    x = L.rms_norm(x[:, :, -1:], params["ln_f"], cfg.norm_eps)
    cache["len"].fill_(s)
    return dense.logits_at(cfg, params, x)[:, :, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One-token decode: tokens [W, B, 1] -> (logits [W, B, V] f32, the
    cache written in place)."""
    n = int(cache["len"])
    x = L.embed(params["embed"], tokens)
    pos = torch.tensor([n], device=x.device)
    for i in range(cfg.num_layers):
        bp = L.layer(params, "blocks", (i,))
        x = dense.decode_attention_half(
            cfg, bp, x, *dense.layer_cache(cache, "blocks", (i,)), n, pos)
        m = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + apply_moe_ffn(L.sub(bp, "moe"), m, cfg)[0]
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["len"] += 1
    return dense.logits_at(cfg, params, x)[:, :, 0], cache
