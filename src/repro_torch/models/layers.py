"""Building blocks of the registry models (the port of
``repro.models.layers``), written for a whole fleet at once.

Every parameter carries a leading worker axis ``[W, ...]`` — they are
views into the engines' flat ``[W, P]`` matrix — and activations carry
it too, ``[W, B, S, ...]``. The worker axis is the batch of every matrix
product (``torch.bmm``) and is folded into the batch of the attention,
which does not depend on the weights. Initialisers draw ONE worker's
leaves from a ``torch.Generator`` on its device (not ``jax.random``:
the tests carry the reference's weights across instead).

Leaves are stored in the config's ``dtype`` (``dtype_of``; a few
recurrence leaves stay f32, as in the reference) and activations follow
the leaves' dtype; the norms, RoPE, the softmax of the attention and the
loss compute in f32 and cast back, as the reference does.

Serving's single-token ``decode_attention`` writes the new token's K / V
into the cache tensors in place (the reference's functional update
copies the cache; see its docstring).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops, ref


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
REMAT_POLICIES = ("none", "dots", "block", "full")


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name."""
    return _DTYPES[name]


def check_trainable(cfg) -> None:
    """Raise ``ValueError`` for a leaf dtype or an activation-checkpoint
    policy that neither package knows."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}; known: "
                         f"{sorted(_DTYPES)}")
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; known: "
                         f"{REMAT_POLICIES}")


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------

# set while ``matmul`` runs its product, so the "dots" policy can tell a
# weight product from the other batched products
_weight_product = False


def _save_weight_products(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.bmm.default and _weight_product:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(f, cfg):
    """``f`` under the activation-checkpoint policy ``cfg.remat`` (the
    reference's ``layers.remat``): ``"none"`` keeps every activation;
    ``"block"`` and ``"full"`` save nothing inside ``f`` and recompute it
    in the backward pass (``nothing_saveable``); ``"dots"`` saves the
    outputs of the weight products — ``matmul``'s ``torch.bmm``, x @ W
    batched over the worker axis only — and recomputes the rest. That is
    the port's counterpart of ``dots_with_no_batch_dims_saveable``: for
    one worker, the reference's x @ W has no batch dimension, while the
    attention's score and value products (batched over sequences and
    heads) and MoE's expert products (batched over experts) have one
    there as here, so neither package saves those. Every policy computes
    the same numbers; they differ in memory and recomputation only. Under
    ``torch.no_grad`` ``f`` runs as it is."""
    if cfg.remat == "none":
        return f
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Initializers (one worker)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float | None = None):
    """Normal weights scaled by 1/sqrt(fan_in), fan_in = shape[0]."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(*shape, generator=gen) * std


def embed_init(gen: torch.Generator, shape):
    """Normal embeddings with standard deviation 0.02."""
    return torch.randn(*shape, generator=gen) * 0.02


def cast_leaves(p: dict, dtypes: dict) -> dict:
    """Each leaf cast to its storage dtype ``dtypes[name]``."""
    return {k: v.to(dtypes[k]) for k, v in p.items()}


def stack_blocks(stack: str, axes: tuple[int, ...], make,
                 dtypes: dict) -> dict:
    """prod(axes) blocks drawn by ``make()`` (one worker's ``{leaf:
    tensor}``), in order, stacked along the stack's layer axes:
    ``{"<stack>/<leaf>": [*axes, ...]}``. Each block is written into
    stacked leaves allocated once, in the leaf's storage dtype
    ``dtypes["<stack>/<leaf>"]``, so the peak is the stack plus one
    block as drawn."""
    n = math.prod(axes)
    out = {}
    for i in range(n):
        for leaf, v in make().items():
            name = f"{stack}/{leaf}"
            if i == 0:
                out[name] = torch.empty((n,) + tuple(v.shape),
                                        dtype=dtypes[name], device=v.device)
            out[name][i] = v
    return {k: v.reshape(axes + v.shape[1:]) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Leaf selection
# ---------------------------------------------------------------------------

def sub(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix/``, named without the prefix."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + "/")}


def layer(params: dict, stack: str, idx: tuple[int, ...]) -> dict:
    """One block of a stack: the ``stack/...`` leaves [W, *axes, ...] at
    the layer index ``idx`` -> {leaf: [W, ...]}, views."""
    return {k: v[(slice(None),) + idx] for k, v in sub(params,
                                                        stack).items()}


# ---------------------------------------------------------------------------
# Fleet math
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each worker's rows of its own table: table [W, V, D], tokens [W,
    ...] int -> [W, ..., D]."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    rows = rows.reshape(-1, *([1] * (tokens.dim() - 1)))
    return table[rows, tokens.long()]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [W, ..., din] @ w [W, din, dout] -> [W, ..., dout], one batched
    product over the worker axis, in the promoted type of the two (as
    ``jnp.matmul``: a bf16 activation by an f32 leaf is an f32
    product)."""
    global _weight_product
    wn = x.shape[0]
    dt = torch.promote_types(x.dtype, w.dtype)
    _weight_product = True
    try:
        y = torch.bmm(x.reshape(wn, -1, x.shape[-1]).to(dt), w.to(dt))
    finally:
        _weight_product = False
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _per_worker(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """[W, d] -> [W, 1, ..., 1, d] against an [W, ..., d] activation."""
    return p.reshape(p.shape[0], *([1] * (ndim - 2)), p.shape[-1])


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x [W, ..., d], gamma [W, d]: x / rms(x) * (1 + gamma), in f32,
    cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + _per_worker(gamma, x.dim()).float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x [W, ..., d], gamma and beta [W, d]: (x - mean) / sqrt(var + eps)
    * gamma + beta (the population variance), in f32, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * _per_worker(gamma, x.dim()).float()
            + _per_worker(beta, x.dim()).float()).to(dt)


def act_fn(name: str):
    """silu, gelu (the tanh form, as ``jax.nn.gelu``) or relu2."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                      # nemotron squared ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The [hd / 2] inverse frequencies theta^(-2i / hd), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [S] int -> x rotated by position
    (the reference's half-split rotation), in f32, cast back to x's
    dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = (positions.to(torch.float32)[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int] = (2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x [..., S, H, hd]; positions3 [3, ...,
    S] int, the (t, h, w) position streams. The hd / 2 frequency slots
    split into (t, h, w) sections in the ratio ``sections``, each rotated
    by its own stream (the reference's half-split rotation), in f32, cast
    back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    tot = sum(sections)
    b0 = half * sections[0] // tot
    b1 = half * (sections[0] + sections[1]) // tot
    inv = rope_freqs(hd, theta, x.device)
    sect = torch.zeros(half, dtype=torch.long, device=x.device)
    sect[b0:b1] = 1
    sect[b1:] = 2
    pos = torch.movedim(positions3, 0, -1)[..., sect]      # [..., S, half]
    ang = (pos.to(torch.float32) * inv)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings [seq_len, dim], f32: sin then
    cos of pos / 10000^(i / max(dim / 2 - 1, 1))."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device),
                          idx / max(dim // 2 - 1, 1))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int) -> dict:
    """One worker's wq / wk / wv / wo."""
    return {
        "wq": dense_init(gen, (d_model, num_heads * head_dim)),
        "wk": dense_init(gen, (d_model, num_kv_heads * head_dim)),
        "wv": dense_init(gen, (d_model, num_kv_heads * head_dim)),
        "wo": dense_init(gen, (num_heads * head_dim, d_model)),
    }


# the reference's names for the mask and the plain attention, which live
# beside the kernel as its plain version
gqa_scores_mask = ref.attention_mask
gqa_attention_ref = ref.gqa_attention


def pick_attn_fn(cfg, *, causal: bool, window: int):
    """Full-sequence attention backend: None (the plain composition) or
    the flash-attention kernel (``cfg.use_flash_kernel``), which takes
    the same post-RoPE q/k/v layout and encodes the mask by
    ``causal``/``window``."""
    if not cfg.use_flash_kernel:
        return None

    def flash(q, k, v, mask):
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    return flash


def kv_projection(p: dict, src: torch.Tensor, num_kv_heads: int,
                  head_dim: int):
    """k and v of ``src`` [W, B, S, D] by wk / wv -> [W * B, S, Hkv, hd]
    each, before any rotation."""
    wn, b, sk, _ = src.shape
    shape = (wn * b, sk, num_kv_heads, head_dim)
    return (matmul(src, p["wk"]).reshape(shape),
            matmul(src, p["wv"]).reshape(shape))


def multi_head_attention(p: dict, x: torch.Tensor, *, num_heads: int,
                         num_kv_heads: int, head_dim: int,
                         positions: torch.Tensor | None = None,
                         theta: float = 1e4, causal: bool = True,
                         window: int = 0, mrope_positions=None, kv_x=None,
                         attn_fn=None, return_kv: bool = False, kv=None):
    """Full-sequence GQA attention of a fleet: x [W, B, S, D] with one
    layer's worker-stacked wq / wk / wv / wo -> [W, B, S, D]. The
    attention sees the W * B sequences as one batch.

    ``positions`` [S] rotates q and k (RoPE; none when None);
    ``mrope_positions`` [3, W * B, S] rotates both by M-RoPE instead.
    ``kv_x`` [W, B, Sk, D] is a cross-attention source: k and v come
    from it, only q is rotated, and no mask applies. ``return_kv`` also
    returns the post-rotation k and v [W * B, Sk, Hkv, hd] (what
    serving's prefill caches). ``kv``: the post-rotation k and v
    [W * B, S, Hkv, hd] computed elsewhere (a slot's kv heads on the
    model axis, ``attention_pieces``); then ``p`` needs only wq and wo."""
    wn, b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    sk = src.shape[2]
    q = matmul(x, p["wq"]).reshape(wn * b, s, num_heads, head_dim)
    if kv is None:
        k, v = kv_projection(p, src, num_kv_heads, head_dim)
    else:
        k, v = kv
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, theta)
        if kv is None:
            k = apply_mrope(k, mrope_positions, theta)
    elif positions is not None:
        q = apply_rope(q, positions, theta)
        if kv_x is None and kv is None:
            k = apply_rope(k, positions, theta)
    mask = None
    if kv_x is None and (causal or window):
        mask = gqa_scores_mask(s, sk, causal=causal, window=window,
                               device=x.device)
    o = (attn_fn(q, k, v, mask) if attn_fn is not None
         else gqa_attention_ref(q, k, v, mask))
    out = matmul(o.reshape(wn, b, s, num_heads * head_dim), p["wo"])
    return (out, k, v) if return_kv else out


def decode_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     positions: torch.Tensor | None = None,
                     theta: float = 1e4, window: int = 0) -> torch.Tensor:
    """Single-token decode of a fleet against a KV cache: x [W, B, 1, D];
    cache_k / cache_v [W, B, C, Hkv, hd] (C the window of a rolling
    cache, else the capacity), views into the stacked cache;
    ``cache_len`` the current length, which is the new token's absolute
    position (``positions`` [1] rotates its q and k). The new K / V go
    IN PLACE into slot ``cache_len mod C`` (rolling) or ``min(cache_len,
    C - 1)`` (full: past the capacity the last slot is overwritten), and
    the query attends to the valid slots — the first min(len + 1, C)
    (rolling) or those up to the slot (full) — by the plain composition
    (``gqa_attention_ref``), as the reference's decode step. Returns
    [W, B, 1, D]."""
    wn, b = x.shape[:2]
    cap = cache_k.shape[2]
    q = matmul(x, p["wq"]).reshape(wn * b, 1, num_heads, head_dim)
    k = matmul(x, p["wk"]).reshape(wn * b, 1, num_kv_heads, head_dim)
    v = matmul(x, p["wv"]).reshape(wn * b, 1, num_kv_heads, head_dim)
    if positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    slot = cache_len % cap if window else min(cache_len, cap - 1)
    cache_k[:, :, slot] = k.reshape(wn, b, num_kv_heads, head_dim)
    cache_v[:, :, slot] = v.reshape(wn, b, num_kv_heads, head_dim)
    idx = torch.arange(cap, device=x.device)
    valid = idx < min(cache_len + 1, cap) if window else idx <= slot
    kv_shape = (wn * b, cap, num_kv_heads, head_dim)
    o = gqa_attention_ref(q, cache_k.reshape(kv_shape),
                          cache_v.reshape(kv_shape), valid[None, :])
    return matmul(o.reshape(wn, b, 1, num_heads * head_dim), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             act: str) -> dict:
    """One worker's w_up / w_down (and w_gate for the gated acts)."""
    p = {"w_up": dense_init(gen, (d_model, d_ff)),
         "w_down": dense_init(gen, (d_ff, d_model))}
    if act in ("silu", "gelu"):           # gated variants
        p["w_gate"] = dense_init(gen, (d_model, d_ff))
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated f(x w_gate) * (x w_up) w_down, or f(x w_up) w_down."""
    f = act_fn(act)
    if "w_gate" in p:
        return matmul(f(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                      p["w_down"])
    return matmul(f(matmul(x, p["w_up"])), p["w_down"])


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_softmax_xent(h: torch.Tensor, w_emb, labels: torch.Tensor,
                         mask=None, chunk: int = 512, count=None):
    """Per-worker cross-entropy over the vocabulary in chunks along S.

    h: [W, B, S, D] final hidden states; w_emb: [W, D, V] — or, for a head
    split over the vocabulary on the model axis, the slots' pieces, a list
    of [W, D, V_j] in vocabulary order (``head_pieces``); labels: [W, B,
    S] int. The reference's chunking: max(S // chunk, 1) chunks of equal
    length, whose masked sums of logsumexp(z) - z[gold] add in chunk
    order; the logits are cast to f32. Returns (the loss sum over
    ``count`` [W] — by default the token count, the mean loss — and the
    token count [W]), f32: the model axis's dp slots pass the worker's
    count over all its slots, so that their losses add up to the
    worker's."""
    wn, b, s, _ = h.shape
    f32 = torch.float32
    if mask is None:
        mask = torch.ones(wn, b, s, dtype=f32, device=h.device)
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    if n_chunks * chunk != s:
        raise ValueError(f"sequence length {s} is not {n_chunks} chunks of "
                         f"{chunk} (the reference cannot reshape it either)")
    tot = torch.zeros(wn, dtype=f32, device=h.device)
    cnt = torch.zeros(wn, dtype=f32, device=h.device)
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        if isinstance(w_emb, torch.Tensor):
            logits = matmul(h[:, :, part], w_emb).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels[:, :, part, None]).squeeze(-1)
        else:
            logz, gold = head_pieces(h[:, :, part], w_emb, labels[:, :, part])
        mx = mask[:, :, part]
        tot = tot + ((logz - gold) * mx).sum(dim=(1, 2))
        cnt = cnt + mx.sum(dim=(1, 2))
    return tot / torch.clamp(cnt if count is None else count, min=1.0), cnt


# ---------------------------------------------------------------------------
# The model axis: a worker's replica over its slots (runtime/sharding's
# spec rules; models/dense.loss_fn_pieces)
# ---------------------------------------------------------------------------

def slot_sum(parts, home: torch.device) -> torch.Tensor:
    """The sum over the model axis of the slots' partials (the row-parallel
    products' outputs, a split embedding's rows), each moved to ``home``
    and added in slot order in f32, cast back to the partials' dtype."""
    out = parts[0].to(home, torch.float32)
    for part in parts[1:]:
        out = out + part.to(home, torch.float32)
    return out.to(parts[0].dtype)


def join_columns(ps, name: str, full: int, make, home) -> torch.Tensor:
    """``make(ps[0])`` where slot 0 holds leaf ``name`` whole (its last
    dim ``full``), else every slot's ``make(p)`` joined on ``home`` along
    the last dim, in slot order: a column-parallel product's output (or
    a leaf split on its last dim) whole on one device."""
    if ps[0][name].shape[-1] == full:
        return make(ps[0])
    return torch.cat([make(p).to(home) for p in ps], dim=-1)


def embed_pieces(tables, tokens: torch.Tensor,
                 home: torch.device) -> torch.Tensor:
    """A lookup in an embedding split over the vocabulary: slot j holds
    rows [o_j, o_j + V_j) of the table (``tables[j]`` [W, V_j, D], in
    vocabulary order); it looks up the tokens in its range, zero for the
    rest, and the rows add over the slots (``slot_sum``: one non-zero term
    a token, exact)."""
    parts, off = [], 0
    for t in tables:
        local = tokens.to(t.device).long() - off
        hit = (local >= 0) & (local < t.shape[1])
        rows = embed(t, torch.where(hit, local, 0))
        parts.append(rows * hit[..., None].to(rows.dtype))
        off += t.shape[1]
    return slot_sum(parts, home)


def head_pieces(h: torch.Tensor, heads, labels: torch.Tensor):
    """logsumexp and the gold logit of h [W, B, c, D] against an output
    projection split over the vocabulary (``heads[j]`` [W, D, V_j], in
    vocabulary order), a slot at a time on its device: the max over the
    slots' maxima (held out of the gradient, as ``jax.nn.logsumexp``
    does), the slots' sums of exp(z - max) added, and the gold logit from
    the slot whose range holds the label -> (logz, gold) [W, B, c] f32 on
    h's device."""
    home = h.device
    logits, off = [], 0
    for w in heads:
        logits.append(matmul(h.to(w.device), w).float())
    top = torch.stack([z.amax(dim=-1).to(home) for z in logits]).amax(0)
    top = top.detach()
    sumexp = slot_sum([torch.exp(z - top.to(z.device)[..., None])
                       .sum(dim=-1) for z in logits], home)
    gold = []
    for z in logits:
        local = labels.to(z.device).long() - off
        hit = (local >= 0) & (local < z.shape[-1])
        g = z.gather(-1, torch.where(hit, local, 0)[..., None]).squeeze(-1)
        gold.append(g * hit)
        off += z.shape[-1]
    return top + torch.log(sumexp), slot_sum(gold, home)


def embed_slots(slots, tokens: torch.Tensor, vocab_size: int
                ) -> torch.Tensor:
    """The embedding of ``tokens`` [W, B, S] (on slot 0's device) by a
    worker's model-axis slots (``slots[j]`` slot j's leaves {name: [W,
    ...]}): slot 0's table where every slot holds it whole, else the
    slots' vocabulary pieces (``embed_pieces``)."""
    if slots[0]["embed"].shape[1] == vocab_size:
        return embed(slots[0]["embed"], tokens)
    return embed_pieces([p["embed"] for p in slots], tokens, tokens.device)


def xent_slots(slots, h: torch.Tensor, batch: dict, *, vocab_size: int,
               tie_embeddings: bool):
    """``chunked_softmax_xent`` of final hidden states h [W, B, S, D] (on
    slot 0's device) against the head held by a worker's model-axis slots
    (the embedding's transpose when tied, else ``lm_head``): slot 0's
    where every slot holds it whole, else the slots' vocabulary pieces
    (``head_pieces``) -> (loss [W], token count [W])."""
    heads = [p["embed"].transpose(1, 2) if tie_embeddings else p["lm_head"]
             for p in slots]
    if heads[0].shape[-1] == vocab_size:
        heads = heads[0]
    return chunked_softmax_xent(h, heads, batch["labels"].long(),
                                batch.get("loss_mask"))


def attention_pieces(ps, x: torch.Tensor, *, num_heads: int,
                     num_kv_heads: int, head_dim: int, positions, theta,
                     window: int, attn_fn, kv_whole: bool) -> torch.Tensor:
    """GQA attention with its heads split over the model axis: slot j
    holds the columns of ``wq`` for its num_heads / m heads and the rows of
    ``wo`` for them (``ps[j]``, its device the leaves'), and the columns of
    ``wk`` / ``wv`` for its kv heads — or, with ``kv_whole`` (the kv heads
    do not divide m: the rule replicates them), both whole: then k and v
    are computed once from slot 0's copy on x's device and each slot takes
    the kv heads its q heads read. Each slot runs the attention on its own
    heads; the slots' row-parallel outputs add over the model axis
    (``slot_sum``). x: [W, B, S, D] on slot 0's device."""
    m, home = len(ps), x.device
    hq = num_heads // m
    group = num_heads // num_kv_heads
    if kv_whole:
        k_all, v_all = kv_projection(ps[0], x, num_kv_heads, head_dim)
        k_all = apply_rope(k_all, positions, theta)
    parts = []
    for j, p in enumerate(ps):
        dev = p["wq"].device
        kv = None
        if kv_whole:
            need = torch.arange(j * hq, (j + 1) * hq) // group
            heads = torch.unique_consecutive(need)
            if not torch.equal(need, heads.repeat_interleave(
                    hq // len(heads))):
                heads = need         # q heads straddle kv heads unevenly
            kv = (k_all.to(dev)[:, :, heads], v_all.to(dev)[:, :, heads])
        parts.append(multi_head_attention(
            p, x.to(dev), num_heads=hq,
            num_kv_heads=kv[0].shape[2] if kv else num_kv_heads // m,
            head_dim=head_dim, positions=positions.to(dev), theta=theta,
            causal=True, window=window, attn_fn=attn_fn, kv=kv))
    return slot_sum(parts, home)
