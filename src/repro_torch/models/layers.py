"""Building blocks of the registry models (the port of
``repro.models.layers``' training-forward subset), written for a whole
fleet at once.

Every parameter carries a leading worker axis ``[W, ...]`` — they are
views into the engines' flat ``[W, P]`` matrix — and activations carry
it too, ``[W, B, S, ...]``. The worker axis is the batch of every matrix
product (``torch.bmm``) and is folded into the batch of the attention,
which does not depend on the weights. Initialisers draw ONE worker's
leaves from a ``torch.Generator`` (not ``jax.random``: the tests carry
the reference's weights across instead).

Not ported here: ``decode_attention``, ``layer_norm``, M-RoPE and
sinusoidal positions (ROADMAP.md queue 1, items 8 and 10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref


def check_trainable(cfg) -> None:
    """Raise for what the port's registry models do not run: an
    activation-checkpoint policy (a memory policy that leaves the numbers
    as they are) and leaves stored in another type than f32 (the DFL
    engines' flat path is f32)."""
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 8); use remat='none'")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r} is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 8); the registry models train in "
            "float32")


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


# ---------------------------------------------------------------------------
# Fleet math
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [W, ..., din] @ w [W, din, dout] -> [W, ..., dout], one batched
    product over the worker axis."""
    wn = x.shape[0]
    y = torch.bmm(x.reshape(wn, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _per_worker(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """[W, d] -> [W, 1, ..., 1, d] against an [W, ..., d] activation."""
    return p.reshape(p.shape[0], *([1] * (ndim - 2)), p.shape[-1])


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x [W, ..., d], gamma [W, d]: x / rms(x) * (1 + gamma)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + _per_worker(gamma, x.dim()))


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
    (the reference's half-split rotation)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = (positions.to(torch.float32)[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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


def multi_head_attention(p: dict, x: torch.Tensor, *, num_heads: int,
                         num_kv_heads: int, head_dim: int,
                         positions: torch.Tensor, theta: float = 1e4,
                         causal: bool = True, window: int = 0,
                         attn_fn=None) -> torch.Tensor:
    """Full-sequence GQA self-attention of a fleet: x [W, B, S, D] with
    one layer's worker-stacked wq / wk / wv / wo -> [W, B, S, D]. The
    attention sees the W * B sequences as one batch."""
    wn, b, s, _ = x.shape
    q = matmul(x, p["wq"]).reshape(wn * b, s, num_heads, head_dim)
    k = matmul(x, p["wk"]).reshape(wn * b, s, num_kv_heads, head_dim)
    v = matmul(x, p["wv"]).reshape(wn * b, s, num_kv_heads, head_dim)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    mask = None
    if causal or window:
        mask = gqa_scores_mask(s, s, causal=causal, window=window,
                               device=x.device)
    o = (attn_fn(q, k, v, mask) if attn_fn is not None
         else gqa_attention_ref(q, k, v, mask))
    return matmul(o.reshape(wn, b, s, num_heads * head_dim), p["wo"])


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

def chunked_softmax_xent(h: torch.Tensor, w_emb: torch.Tensor,
                         labels: torch.Tensor, mask=None,
                         chunk: int = 512):
    """Per-worker cross-entropy over the vocabulary in chunks along S.

    h: [W, B, S, D] final hidden states; w_emb: [W, D, V]; labels: [W, B,
    S] int. The reference's chunking: max(S // chunk, 1) chunks of equal
    length, whose masked sums of logsumexp(z) - z[gold] add in chunk
    order. Returns (mean loss [W], token count [W])."""
    wn, b, s, _ = h.shape
    if mask is None:
        mask = torch.ones(wn, b, s, dtype=h.dtype, device=h.device)
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    if n_chunks * chunk != s:
        raise ValueError(f"sequence length {s} is not {n_chunks} chunks of "
                         f"{chunk} (the reference cannot reshape it either)")
    tot = torch.zeros(wn, dtype=h.dtype, device=h.device)
    cnt = torch.zeros(wn, dtype=h.dtype, device=h.device)
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        logits = matmul(h[:, :, part], w_emb)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, :, part, None]).squeeze(-1)
        mx = mask[:, :, part]
        tot = tot + ((logz - gold) * mx).sum(dim=(1, 2))
        cnt = cnt + mx.sum(dim=(1, 2))
    return tot / torch.clamp(cnt, min=1.0), cnt
