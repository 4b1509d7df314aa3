"""xLSTM blocks (xlstm-1.3b): mLSTM (matrix memory, parallel over
tokens) and sLSTM (scalar memory with recurrent memory mixing,
sequential) — the port of ``repro.models.xlstm``, for a fleet of W
workers at once.

The mLSTM recurrence
    C_t = f_t C_{t-1} + i_t v_t k_t^T,  n_t = f_t n_{t-1} + i_t k_t
runs through ``ssm.chunked_recurrence`` with per-head (k, q) as (B, C)
and the normaliser n folded in as an extra ones-column of v; the
denominator is max(|n . q|, 1). sLSTM is a loop over tokens with its
block-diagonal recurrent matrices, followed by its gated FFN. Layout:
groups of ``slstm_every`` mLSTM blocks and one sLSTM block, then the
tail mLSTM blocks. Leaves, worker-stacked as in ``models/dense.py``:
``mlstm/...`` ``[W, G, slstm_every, ...]``, ``slstm/...`` ``[W, G,
...]``, ``tail/...`` ``[W, tail, ...]``.

Every block runs under ``cfg.remat``.

Serving keeps constant-size recurrent states, named as the reference's
cache tree: ``mlstm/C`` ``[W, G, slstm_every, B, H, n_qk, hd + 1]`` and
``tail/C`` (the chunked recurrence's state over the ones-augmented v,
the normaliser in the last column), ``slstm/c``, ``/n``, ``/h`` ``[W, G,
B, H, dh]`` and ``slstm/m`` ``[W, G, B, H]``, all f32, and ``len``;
updated in place (``models/dense.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.ssm import chunked_recurrence, recurrence_floats

QK_DIM_FACTOR = 0.5      # mLSTM qk dim = head_dim / 2
UP_FACTOR = 2            # mLSTM block up-projection factor
# leaves stored in f32 whatever cfg.dtype says: the mLSTM gates and the
# sLSTM recurrence and bias (registry.leaf_dtypes)
F32_LEAVES = frozenset({"w_igate", "b_igate", "w_fgate", "b_fgate", "r",
                        "b"})


# ---------------------------------------------------------------------------
# mLSTM layer
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_up, heads, head_dim_v, head_dim_qk)."""
    d_up = UP_FACTOR * cfg.d_model
    h = cfg.num_heads
    hd = d_up // h
    return d_up, h, hd, max(int(hd * QK_DIM_FACTOR), 4)


def _mlstm_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    d_up, h, _, nqk = _mlstm_dims(cfg)
    return {"b_fgate": (h,), "b_igate": (h,), "ln": (d,),
            "ln_inner": (d_up,), "w_down": (d_up, d), "w_fgate": (d_up, h),
            "w_igate": (d_up, h), "w_up": (d, 2 * d_up),
            "wk": (d_up, h * nqk), "wq": (d_up, h * nqk), "wv": (d_up, d_up)}


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One worker's mLSTM block, by the reference's init laws."""
    s = _mlstm_shapes(cfg)
    h = s["b_igate"][0]
    return {
        "ln": torch.zeros(s["ln"]),
        "w_up": L.dense_init(gen, s["w_up"]),
        "wq": L.dense_init(gen, s["wq"]),
        "wk": L.dense_init(gen, s["wk"]),
        "wv": L.dense_init(gen, s["wv"]),
        "w_igate": L.dense_init(gen, s["w_igate"], scale=0.01),
        "b_igate": torch.full((h,), -3.0),
        "w_fgate": L.dense_init(gen, s["w_fgate"], scale=0.01),
        "b_fgate": torch.full((h,), 3.0),    # init: mostly remember
        "ln_inner": torch.zeros(s["ln_inner"]),
        "w_down": L.dense_init(gen, s["w_down"]),
    }


def _mlstm_qkv_gates(p: dict, a: torch.Tensor):
    """The mLSTM cell's projections of a [W, B, S, d_up]: q, k [W, B, S,
    H, n_qk], v [W, B, S, H, hd] and the gates' pre-activations [W, B,
    S, H]."""
    wn, b, s, d_up = a.shape
    h = p["w_igate"].shape[-1]
    nqk = p["wq"].shape[-1] // h
    hd = d_up // h
    q = L.matmul(a, p["wq"]).reshape(wn, b, s, h, nqk) * (nqk ** -0.5)
    k = L.matmul(a, p["wk"]).reshape(wn, b, s, h, nqk)
    v = L.matmul(a, p["wv"]).reshape(wn, b, s, h, hd)
    af = a.to(torch.float32)
    igate = L.matmul(af, p["w_igate"]) + p["b_igate"][:, None, None]
    fgate = L.matmul(af, p["w_fgate"]) + p["b_fgate"][:, None, None]
    return q, k, v, igate, fgate


def _v_aug(v: torch.Tensor) -> torch.Tensor:
    """v in f32 with a ones column appended (the normaliser's)."""
    return torch.cat([v.to(torch.float32),
                      torch.ones(*v.shape[:-1], 1, dtype=torch.float32,
                                 device=v.device)], dim=-1)


def _mlstm_out(p: dict, h_res, y_aug, gate, cfg: ModelConfig):
    """The block's output from the recurrence's y_aug [..., H, hd + 1]:
    the numerator over max(|normaliser|, 1), normed, gated, projected
    down, plus the residual."""
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    # torch.maximum splits the gradient of a tie in half, as jnp.maximum
    hid = num / torch.maximum(torch.abs(den), den.new_ones(()))
    hid = hid.reshape(*h_res.shape[:-1], -1).to(h_res.dtype)
    hid = L.rms_norm(hid, p["ln_inner"], cfg.norm_eps)
    return h_res + L.matmul(hid * F.silu(gate), p["w_down"])


def _mlstm(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int,
           final: bool):
    """Full-sequence mLSTM block of a fleet: x [W, B, S, d] -> ([W, B, S,
    d], the final state [W * B, H, n_qk, hd + 1] or None)."""
    wn, bsz, s, d = x.shape
    h_res = x
    x = L.rms_norm(x, p["ln"], cfg.norm_eps)
    a, gate = torch.chunk(L.matmul(x, p["w_up"]), 2, dim=-1)
    q, k, v, igate, fgate = _mlstm_qkv_gates(p, a)
    log_f = F.logsigmoid(fgate)                              # [W,B,S,H]
    i_mult = torch.exp(igate)                                # update gate
    # the normaliser: the same recurrence on an extra ones column of v
    v_aug = _v_aug(v)
    h, hd = v.shape[-2], v.shape[-1]
    nb = wn * bsz
    y_aug, st = chunked_recurrence(
        v_aug.reshape(nb, s, h, hd + 1), gate=i_mult.reshape(nb, s, h),
        log_decay=log_f.reshape(nb, s, h), b=k.reshape(nb, s, h, -1),
        c=q.reshape(nb, s, h, -1), chunk=chunk, final=final)
    return _mlstm_out(p, h_res, y_aug.reshape(wn, bsz, s, h, hd + 1), gate,
                      cfg), st


def apply_mlstm(p: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 256) -> torch.Tensor:
    """Full-sequence mLSTM block of a fleet: x [W, B, S, d] -> [W, B, S,
    d]."""
    return _mlstm(p, x, cfg, chunk, final=False)[0]


# ---------------------------------------------------------------------------
# sLSTM layer (sequential; memory mixing via block-diagonal recurrence)
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    h = cfg.num_heads
    return h, cfg.d_model // h


def _slstm_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    h, dh = _slstm_dims(cfg)
    ffn = 4 * d // 3
    return {"b": (4 * d,), "ln": (d,), "ln2": (d,), "ln_inner": (d,),
            "r": (4, h, dh, dh), "w_ffn_down": (ffn, d),
            "w_ffn_gate": (d, ffn), "w_ffn_up": (d, ffn), "w_in": (d, 4 * d)}


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One worker's sLSTM block: 4 gates (z, i, f, o) with input
    projections and block-diagonal recurrent matrices, then a gated FFN
    of width 4 d / 3."""
    d = cfg.d_model
    s = _slstm_shapes(cfg)
    return {
        "ln": torch.zeros(d),
        "w_in": L.dense_init(gen, s["w_in"]),
        "r": L.dense_init(gen, s["r"], scale=0.05),
        "b": torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0),
                        torch.zeros(d)]),
        "ln_inner": torch.zeros(d),
        "w_ffn_gate": L.dense_init(gen, s["w_ffn_gate"]),
        "w_ffn_up": L.dense_init(gen, s["w_ffn_up"]),
        "w_ffn_down": L.dense_init(gen, s["w_ffn_down"]),
        "ln2": torch.zeros(d),
    }


def init_slstm_state(cfg: ModelConfig, num_workers: int, batch: int,
                     device=None) -> dict:
    """The zero state: c, n, h [W, B, H, dh] and the stabiliser m [W, B,
    H]."""
    h, dh = _slstm_dims(cfg)
    z = torch.zeros(num_workers, batch, h, dh, device=device)
    return {"c": z, "n": z, "h": z,
            "m": torch.zeros(num_workers, batch, h, device=device)}


def _slstm_step(p: dict, state: dict, x_proj: torch.Tensor) -> dict:
    """One token: x_proj [W, B, 4 d] (W x + b precomputed), the state of
    ``init_slstm_state`` -> the next state."""
    wn, bsz = x_proj.shape[:2]
    h_heads, dh = p["r"].shape[2], p["r"].shape[3]
    # recurrent contribution: block-diagonal R @ h_{t-1}, per gate
    rec = torch.einsum("wghde,wbhe->wbghd", p["r"].to(torch.float32),
                       state["h"])                           # [W,B,4,H,dh]
    pre = x_proj.to(torch.float32).reshape(wn, bsz, 4, h_heads, dh) + rec
    z_t = torch.tanh(pre[:, :, 0])
    i_t = pre[:, :, 1]                                       # log-space
    f_t = F.logsigmoid(pre[:, :, 2])
    o_t = torch.sigmoid(pre[:, :, 3])
    # stabiliser (per head): m_t = max(f + m, max_dh i); amax splits the
    # gradient of a tie, as the reference's max does
    i_head = torch.amax(i_t, dim=-1)                         # [W,B,H]
    m_new = torch.maximum(f_t.mean(dim=-1) + state["m"], i_head)
    f_s = torch.exp(f_t + (state["m"] - m_new)[..., None])
    i_s = torch.exp(i_t - m_new[..., None])
    c = f_s * state["c"] + i_s * z_t
    n = f_s * state["n"] + i_s
    h_new = o_t * c / torch.maximum(n, n.new_full((), 1e-6))
    return {"c": c, "n": n, "h": h_new, "m": m_new}


@dataclass
class TokenLoop:
    """A cap on ``apply_slstm``'s token loop (``token_loop``): ``trips``
    trips, the loop lengths it was asked for, and the trip running (None
    outside the loop)."""

    trips: int
    lengths: set[int] = field(default_factory=set)
    trip: int | None = None


_TOKEN_LOOP: contextvars.ContextVar[TokenLoop | None] = \
    contextvars.ContextVar("slstm_token_loop", default=None)


@contextlib.contextmanager
def token_loop(trips: int):
    """Within: ``apply_slstm`` on ``meta`` tensors runs at most ``trips``
    trips of its token loop and repeats the last hidden state over the
    tokens left — every trip issues the same operations at the same
    shapes, so a dry run counts the loop from short traces
    (``launch/dryrun.py``). Yields the ``TokenLoop``, which records the
    loop lengths seen."""
    loop = TokenLoop(trips)
    tok = _TOKEN_LOOP.set(loop)
    try:
        yield loop
    finally:
        _TOKEN_LOOP.reset(tok)


def apply_slstm(p: dict, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Full-sequence sLSTM block of a fleet, token by token: x [W, B, S, d]
    -> ([W, B, S, d], the final state); under ``token_loop`` (``meta``
    tensors only) a capped number of trips."""
    wn, bsz, s, d = x.shape
    loop = _TOKEN_LOOP.get()
    trips = s
    if loop is not None:
        if x.device.type != "meta":
            raise ValueError("token_loop caps the sLSTM loop of a meta "
                             "trace only: its values are not the model's")
        loop.lengths.add(s)
        trips = min(loop.trips, s)
    h_res = x
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    x_proj = L.matmul(xn, p["w_in"]) + p["b"][:, None, None].to(xn.dtype)
    st = state or init_slstm_state(cfg, wn, bsz, device=x.device)
    hs = []
    for t in range(trips):
        if loop is not None:
            loop.trip = t
        st = _slstm_step(p, st, x_proj[:, :, t])
        hs.append(st["h"])
    if loop is not None:
        loop.trip = None
    hs += hs[-1:] * (s - trips)
    hid = torch.stack(hs, dim=2).reshape(wn, bsz, s, d).to(x.dtype)
    hid = L.rms_norm(hid, p["ln_inner"], cfg.norm_eps)
    x = h_res + hid
    # gated FFN sub-block
    m = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    ff = L.matmul(F.silu(L.matmul(m, p["w_ffn_gate"]))
                  * L.matmul(m, p["w_ffn_up"]), p["w_ffn_down"])
    return x + ff, st


# ---------------------------------------------------------------------------
# Model: groups of (slstm_every mLSTM blocks + 1 sLSTM block), mLSTM tail
# ---------------------------------------------------------------------------

def _group_shape(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_groups, mlstm_per_group, tail_mlstm)."""
    per = cfg.slstm_every + 1 if cfg.slstm_every else cfg.num_layers
    g = cfg.num_layers // per if cfg.slstm_every else 0
    tail = cfg.num_layers - g * per
    return g, cfg.slstm_every, tail


def _stacks(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], dict]]:
    """Each block stack's name, stacked layer axes and block leaf shapes."""
    g, mpg, tail = _group_shape(cfg)
    out = {}
    if g:
        out["mlstm"] = ((g, mpg), _mlstm_shapes(cfg))
        out["slstm"] = ((g,), _slstm_shapes(cfg))
    if tail:
        out["tail"] = ((tail,), _mlstm_shapes(cfg))
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
    make = {"mlstm": init_mlstm_block, "slstm": init_slstm_block,
            "tail": init_mlstm_block}
    for stack, (axes, _) in _stacks(cfg).items():
        p.update(L.stack_blocks(stack, axes,
                                lambda: make[stack](generator, cfg), dtypes))
    return p


def attention_calls(cfg: ModelConfig) -> int:
    """Attention layers one forward pass runs: none."""
    return 0


def activation_floats(cfg: ModelConfig, seq_len: int) -> int:
    """The floats one token's forward keeps for the backward pass, about.
    An mLSTM block: the norms, the up-projection, q (and its scaled
    copy), k, v and its ones column, the gates, the recurrence
    (``ssm.recurrence_floats`` on the [H, n_qk, hd + 1] state) and the
    output's division, norm and gate. An sLSTM block: its projection, and
    per token the recurrent term, the pre-activations, the four gates and
    the new c, n, h and m, then the FFN's four intermediates."""
    d = cfg.d_model
    d_up, h, hd, nqk = _mlstm_dims(cfg)
    mlstm = (2 * d + 12 * d_up + 3 * h * nqk + 8 * h
             + recurrence_floats(h, nqk, hd + 1, seq_len))
    slstm = 30 * d + 4 * (4 * d // 3)
    g, mpg, tail = _group_shape(cfg)
    return (g * mpg + tail) * mlstm + g * slstm


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full forward to final hidden states: tokens [W, B, S] int ->
    [W, B, S, D]."""
    L.check_trainable(cfg)
    x = L.embed(params["embed"], tokens)
    g, mpg, tail = _group_shape(cfg)
    mlstm = L.remat(lambda h, bp: apply_mlstm(bp, h, cfg), cfg)
    slstm = L.remat(lambda h, bp: apply_slstm(bp, h, cfg)[0], cfg)
    for gi in range(g):
        for j in range(mpg):
            x = mlstm(x, L.layer(params, "mlstm", (gi, j)))
        x = slstm(x, L.layer(params, "slstm", (gi,)))
    for j in range(tail):
        x = mlstm(x, L.layer(params, "tail", (j,)))
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


# ---------------------------------------------------------------------------
# Serving: recurrent state cache (constant size)
# ---------------------------------------------------------------------------

SLSTM_STATE = ("c", "n", "h", "m")


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *,
               num_workers: int = 1, device=None) -> dict:
    """The zero recurrent states of every block (``max_len`` is unused:
    the states do not grow), ``len`` 0."""
    g, mpg, tail = _group_shape(cfg)
    _, h, hd, nqk = _mlstm_dims(cfg)
    hs, dh = _slstm_dims(cfg)
    cache = {}

    def zeros(*shape):
        return torch.zeros((num_workers, *shape), dtype=torch.float32,
                           device=device)

    if g:
        cache["mlstm/C"] = zeros(g, mpg, batch, h, nqk, hd + 1)
        for name in SLSTM_STATE:
            cache[f"slstm/{name}"] = (zeros(g, batch, hs) if name == "m"
                                      else zeros(g, batch, hs, dh))
    if tail:
        cache["tail/C"] = zeros(tail, batch, h, nqk, hd + 1)
    cache["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def decode_mlstm(p: dict, x: torch.Tensor, C: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Single-token mLSTM step: x [W, B, 1, d]; the state ``C`` [W, B, H,
    n_qk, hd + 1] (a cache view) advanced in place, C = f C + i k (x)
    v_aug. Returns [W, B, 1, d]."""
    h_res = x
    x = L.rms_norm(x, p["ln"], cfg.norm_eps)
    a, gate = torch.chunk(L.matmul(x, p["w_up"]), 2, dim=-1)
    q, k, v, igate, fgate = _mlstm_qkv_gates(p, a)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]           # [W,B,H,*]
    f = torch.exp(F.logsigmoid(fgate[:, :, 0]))             # [W,B,H]
    i = torch.exp(igate[:, :, 0])
    C.mul_(f[..., None, None]).add_(
        i[..., None, None] * torch.einsum("wbhn,wbhp->wbhnp",
                                          k.to(torch.float32), _v_aug(v)))
    y_aug = torch.einsum("wbhn,wbhnp->wbhp", q.to(torch.float32), C)
    return _mlstm_out(p, h_res, y_aug[:, :, None], gate, cfg)


def decode_slstm(p: dict, x: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    """Single-token sLSTM step: x [W, B, 1, d]; ``state`` the {c, n, h,
    m} cache views, advanced in place. Returns [W, B, 1, d]."""
    wn, bsz, _, d = x.shape
    h_res = x
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    x_proj = (L.matmul(xn, p["w_in"])
              + p["b"][:, None, None].to(xn.dtype))[:, :, 0]
    st = _slstm_step(p, state, x_proj)
    for name in SLSTM_STATE:
        state[name].copy_(st[name])
    hid = st["h"].reshape(wn, bsz, 1, d).to(x.dtype)
    x = h_res + L.rms_norm(hid, p["ln_inner"], cfg.norm_eps)
    m = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.matmul(F.silu(L.matmul(m, p["w_ffn_gate"]))
                        * L.matmul(m, p["w_ffn_up"]), p["w_ffn_down"])


def _cache_layers(cfg: ModelConfig):
    """The blocks in the reference's order: (stack, index, is sLSTM)."""
    g, mpg, tail = _group_shape(cfg)
    for gi in range(g):
        for j in range(mpg):
            yield "mlstm", (gi, j), False
        yield "slstm", (gi,), True
    for j in range(tail):
        yield "tail", (j,), False


def _slstm_cache(cache: dict, idx: tuple[int, ...]) -> dict:
    at = (slice(None),) + idx
    return {name: cache[f"slstm/{name}"][at] for name in SLSTM_STATE}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int = 0):
    """Prefill (chunked-parallel mLSTM, token-loop sLSTM): tokens [W, B,
    S] -> (the last position's logits [W, B, V] f32, every block's final
    state)."""
    wn, b, s = tokens.shape
    cache = init_cache(cfg, b, num_workers=wn, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    for stack, idx, is_slstm in _cache_layers(cfg):
        bp = L.layer(params, stack, idx)
        if is_slstm:
            x, st = apply_slstm(bp, x, cfg)
            for name, dst in _slstm_cache(cache, idx).items():
                dst.copy_(st[name])
        else:
            x, st = _mlstm(bp, x, cfg, 256, final=True)
            dst = cache[f"{stack}/C"][(slice(None),) + idx]
            dst.copy_(st.reshape(dst.shape))
    x = L.rms_norm(x[:, :, -1:], params["ln_f"], cfg.norm_eps)
    cache["len"].fill_(s)
    return dense.logits_at(cfg, params, x)[:, :, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One-token decode: tokens [W, B, 1] -> (logits [W, B, V] f32, the
    states advanced in place)."""
    x = L.embed(params["embed"], tokens)
    for stack, idx, is_slstm in _cache_layers(cfg):
        bp = L.layer(params, stack, idx)
        if is_slstm:
            x = decode_slstm(bp, x, _slstm_cache(cache, idx), cfg)
        else:
            x = decode_mlstm(bp, x, cache[f"{stack}/C"][(slice(None),)
                                                        + idx], cfg)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache["len"] += 1
    return dense.logits_at(cfg, params, x)[:, :, 0], cache
