"""Whisper-style encoder-decoder backbone (whisper-large-v3): the port of
``repro.models.encdec``, for a fleet of W workers at once.

The convolutional / mel frontend is a stub, as in the reference: inputs
are precomputed frame embeddings ``[W, B, S, d]``. The encoder is
bidirectional self-attention over the frames with sinusoidal positions
and layer norms (gain 1 + ``ln*``, no bias); the decoder is causal
self-attention (RoPE) and cross-attention to the encoder's output, of
length ``dec_len(S) = S // 8``. Leaves, worker-stacked as in
``models/dense.py``: ``enc_blocks/...`` ``[W, L_enc, ...]``,
``dec_blocks/...`` ``[W, L_dec, ...]``, with the other leaves the
reference's names.

Serving: the cache holds the decoder's self-attention K / V ``k`` / ``v``
``[W, L_dec, B, cap, Hkv, hd]`` and the cross-attention K / V over all
frames ``xk`` / ``xv`` ``[W, L_dec, B, S, Hkv, hd]``, plus ``len``;
``decode_step`` writes in place (``models/dense.py``). No layer takes
the flash kernel: the reference calls none here.

One deviation from the reference: its ``prefill`` caches the prompt's
self-attention keys BEFORE RoPE while its decode steps rotate theirs,
so a decoded token scores the prompt's keys unrotated (its decode then
disagrees with its own teacher-forced forward past a one-token prompt).
The port caches the rotated keys, which its decode and its forward
agree on; the tests hold the port's cache to the reference's with RoPE
applied.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models import layers as L

DEC_RATIO = 8     # decoder_len = seq_len // DEC_RATIO
# leaves stored in f32 whatever cfg.dtype says: none
F32_LEAVES = frozenset()


def dec_len(seq_len: int) -> int:
    """The decoder length of ``seq_len`` encoder frames."""
    return max(seq_len // DEC_RATIO, 1)


def _attn_shapes(cfg: ModelConfig, name: str) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return {f"{name}/wk": (d, kvd), f"{name}/wo": (qd, d),
            f"{name}/wq": (d, qd), f"{name}/wv": (d, kvd)}


def _block_shapes(cfg: ModelConfig, decoder: bool) -> dict:
    d = cfg.d_model
    out = {k: v for k, v in dense.block_shapes(cfg).items()
           if not k.startswith("attn/")}
    if decoder:
        out.update(_attn_shapes(cfg, "self_attn"))
        out.update(_attn_shapes(cfg, "cross_attn"))
        out["ln_x"] = (d,)
    else:
        out.update(_attn_shapes(cfg, "attn"))
    return out


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One worker's leaf shapes by ``"/"``-joined name."""
    d = cfg.d_model
    out = {"embed": (cfg.vocab_size, d), "enc_ln_f": (d,), "ln_f": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    for stack, n, dec in (("enc_blocks", cfg.encoder_layers, False),
                          ("dec_blocks", cfg.decoder_layers, True)):
        for leaf, shape in _block_shapes(cfg, dec).items():
            out[f"{stack}/{leaf}"] = (n,) + shape
    return out


def _attn_init(gen: torch.Generator, cfg: ModelConfig, name: str) -> dict:
    attn = L.init_attention(gen, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim)
    return {f"{name}/{k}": v for k, v in attn.items()}


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    blk = {"ln1": torch.zeros(d), "ln_x": torch.zeros(d),
           "ln2": torch.zeros(d)}
    blk.update(_attn_init(gen, cfg, "self_attn"))
    blk.update(_attn_init(gen, cfg, "cross_attn"))
    mlp = L.init_mlp(gen, d, cfg.d_ff, cfg.act)
    blk.update({f"mlp/{k}": v for k, v in mlp.items()})
    return blk


def init(cfg: ModelConfig, generator: torch.Generator,
         dtypes: dict) -> dict:
    """One worker's parameters, drawn from ``generator`` (the reference's
    init laws), each cast to ``dtypes[name]``."""
    d = cfg.d_model
    p = {"embed": L.embed_init(generator, (cfg.vocab_size, d)),
         "enc_ln_f": torch.zeros(d), "ln_f": torch.zeros(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (d, cfg.vocab_size))
    p = L.cast_leaves(p, dtypes)
    p.update(L.stack_blocks("enc_blocks", (cfg.encoder_layers,),
                            lambda: dense.init_block(generator, cfg),
                            dtypes))
    p.update(L.stack_blocks("dec_blocks", (cfg.decoder_layers,),
                            lambda: _dec_block_init(generator, cfg), dtypes))
    return p


def attention_calls(cfg: ModelConfig) -> int:
    """flash-attention launches of one forward pass: none."""
    return 0


def activation_floats(cfg: ModelConfig, seq_len: int) -> int:
    """The floats one decoder token's forward keeps for the backward
    pass, about: the encoder's per-frame activations (an attention + MLP
    block's, ``dense.attention_block_floats``, a layer) over the frames
    a decoder token stands for (``seq_len / dec_len(seq_len)``, about
    ``DEC_RATIO``), and per decoder layer the self-attention + MLP
    block's, plus the cross-attention's norm input and output, q, its
    output and residual, and its K and V over those frames."""
    frames = -(-seq_len // dec_len(seq_len))
    hd = cfg.resolved_head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    enc = cfg.encoder_layers * dense.attention_block_floats(cfg, cfg.d_ff)
    cross = 3 * cfg.d_model + 2 * qd + frames * 2 * kvd
    dec = cfg.decoder_layers * (dense.attention_block_floats(cfg, cfg.d_ff)
                                + cross)
    return frames * enc + dec


def _ln(x, gain, eps: float):
    """The reference's layer norm of gain 1 + ``gain`` and no bias."""
    return L.layer_norm(x, 1.0 + gain, torch.zeros_like(gain), eps)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor):
    """frames [W, B, S, d] (precomputed frame embeddings) -> the
    encoder's output [W, B, S, d]."""
    s, d = frames.shape[2], frames.shape[3]
    x = frames + L.sinusoidal_positions(s, d, frames.device).to(frames.dtype)

    def block_fn(h, bp):
        a = _ln(h, bp["ln1"], cfg.norm_eps)
        h = h + L.multi_head_attention(
            L.sub(bp, "attn"), a, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            causal=False)
        m = _ln(h, bp["ln2"], cfg.norm_eps)
        return h + L.apply_mlp(L.sub(bp, "mlp"), m, cfg.act)

    block = L.remat(block_fn, cfg)
    for i in range(cfg.encoder_layers):
        x = block(x, L.layer(params, "enc_blocks", (i,)))
    return _ln(x, params["enc_ln_f"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, bp: dict, x, enc_out, positions, *,
               return_kv: bool = False):
    """Self-attention, cross-attention to ``enc_out``, MLP. With
    ``return_kv`` also the self-attention's post-RoPE k, v and the
    cross-attention's k, v [W * B, S, Hkv, hd] (what prefill caches)."""
    heads = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                 head_dim=cfg.resolved_head_dim)
    a = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    a, k, v = L.multi_head_attention(L.sub(bp, "self_attn"), a,
                                     positions=positions, causal=True,
                                     return_kv=True, **heads)
    x = x + a
    a = L.rms_norm(x, bp["ln_x"], cfg.norm_eps)
    a, xk, xv = L.multi_head_attention(L.sub(bp, "cross_attn"), a,
                                       causal=False, kv_x=enc_out,
                                       return_kv=True, **heads)
    x = x + a
    m = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + L.apply_mlp(L.sub(bp, "mlp"), m, cfg.act)
    return (x, k, v, xk, xv) if return_kv else x


def decode_seq(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               enc_out: torch.Tensor):
    """Teacher-forced decoder forward: tokens [W, B, T] -> final hidden
    states [W, B, T, d]."""
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    block = L.remat(lambda h, bp: _dec_block(cfg, bp, h, enc_out, positions),
                    cfg)
    for i in range(cfg.decoder_layers):
        x = block(x, L.layer(params, "dec_blocks", (i,)))
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


head_matrix = dense.head_matrix


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, count=None):
    """Per-worker loss: batch ``frames`` [W, B, S, d], ``tokens`` and
    ``labels`` [W, B, T] -> (loss [W], {"tokens": count [W]}). ``count``
    [W]: the token count the loss sum is divided by (the model axis's dp
    slots pass their worker's; default the batch's own)."""
    L.check_trainable(cfg)
    enc_out = encode(cfg, params, batch["frames"])
    h = decode_seq(cfg, params, batch["tokens"], enc_out)
    loss, cnt = L.chunked_softmax_xent(h, head_matrix(cfg, params),
                                       batch["labels"].long(),
                                       batch.get("loss_mask"), count=count)
    return loss, {"tokens": cnt}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_dec_len: int,
               enc_len: int, *, num_workers: int = 1, device=None) -> dict:
    """A zero cache: self K / V of capacity ``max_dec_len``, cross K / V
    over ``enc_len`` frames, ``len`` 0."""
    dt = L.dtype_of(cfg.dtype)
    lead = (num_workers, cfg.decoder_layers, batch)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {name: torch.zeros((*lead, cap, *tail), dtype=dt, device=device)
             for name, cap in (("k", max_dec_len), ("v", max_dec_len),
                               ("xk", enc_len), ("xv", enc_len))}
    cache["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, max_len: int = 0):
    """Encode the frames [W, B, S, d], cache the cross K / V, and run the
    prompt tokens [W, B, T] through the decoder -> (the last position's
    logits [W, B, V] f32, the cache of decoder capacity ``max_len``, T
    when 0)."""
    wn, b, t = tokens.shape
    se = frames.shape[2]
    cache = init_cache(cfg, b, max_len or t, se, num_workers=wn,
                       device=tokens.device)
    enc_out = encode(cfg, params, frames)
    positions = torch.arange(t, device=tokens.device)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.decoder_layers):
        x, k, v, xk, xv = _dec_block(cfg, L.layer(params, "dec_blocks", (i,)),
                                     x, enc_out, positions, return_kv=True)
        for name, src, n in (("k", k, t), ("v", v, t), ("xk", xk, se),
                             ("xv", xv, se)):
            cache[name][:, i, :, :n] = src.reshape(wn, b, n, *tail)
    x = L.rms_norm(x[:, :, -1:], params["ln_f"], cfg.norm_eps)
    cache["len"].fill_(t)
    return dense.logits_at(cfg, params, x)[:, :, 0], cache


def _cross(p: dict, x, xk, xv, cfg: ModelConfig):
    """One token's cross-attention x [W, B, 1, d] over the cached xk / xv
    [W, B, S, Hkv, hd] (the plain composition, no mask)."""
    wn, b = x.shape[:2]
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    q = L.matmul(x, p["wq"]).reshape(wn * b, 1, hq, hd)
    kv_shape = (wn * b, xk.shape[2], cfg.num_kv_heads, hd)
    o = L.gqa_attention_ref(q, xk.reshape(kv_shape), xv.reshape(kv_shape))
    return L.matmul(o.reshape(wn, b, 1, hq * hd), p["wo"])


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One-token decode against the cached self and cross K / V: tokens
    [W, B, 1] -> (logits [W, B, V] f32, the cache written in place)."""
    n = int(cache["len"])
    x = L.embed(params["embed"], tokens)
    pos = torch.tensor([n], device=x.device)
    for i in range(cfg.decoder_layers):
        bp = L.layer(params, "dec_blocks", (i,))
        a = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        x = x + L.decode_attention(
            L.sub(bp, "self_attn"), a, cache["k"][:, i], cache["v"][:, i], n,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=pos)
        a = L.rms_norm(x, bp["ln_x"], cfg.norm_eps)
        x = x + _cross(L.sub(bp, "cross_attn"), a, cache["xk"][:, i],
                       cache["xv"][:, i], cfg)
        m = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.apply_mlp(L.sub(bp, "mlp"), m, cfg.act)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["len"] += 1
    return dense.logits_at(cfg, params, x)[:, :, 0], cache
