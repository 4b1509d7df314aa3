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


def _mlstm_qkv(p: dict, a: torch.Tensor, heads: int):
    """The mLSTM cell's projections of a [W, B, S, d_up] onto the ``heads``
    heads of ``p``'s wq / wk / wv (all of them, or a slot's): q, k [W, B,
    S, heads, n_qk], v [W, B, S, heads, hd]."""
    wn, b, s, _ = a.shape
    nqk = p["wq"].shape[-1] // heads
    q = L.matmul(a, p["wq"]).reshape(wn, b, s, heads, nqk) * (nqk ** -0.5)
    k = L.matmul(a, p["wk"]).reshape(wn, b, s, heads, nqk)
    v = L.matmul(a, p["wv"]).reshape(wn, b, s, heads, -1)
    return q, k, v


def _mlstm_gates(p: dict, a: torch.Tensor):
    """The gates' pre-activations [W, B, S, H] of a [W, B, S, d_up], in
    f32 (the gate leaves' dtype)."""
    af = a.to(torch.float32)
    igate = L.matmul(af, p["w_igate"]) + p["b_igate"][:, None, None]
    fgate = L.matmul(af, p["w_fgate"]) + p["b_fgate"][:, None, None]
    return igate, fgate


def _v_aug(v: torch.Tensor) -> torch.Tensor:
    """v in f32 with a ones column appended (the normaliser's)."""
    return torch.cat([v.to(torch.float32),
                      torch.ones(*v.shape[:-1], 1, dtype=torch.float32,
                                 device=v.device)], dim=-1)


def _hidden(y_aug: torch.Tensor, h_res: torch.Tensor) -> torch.Tensor:
    """The recurrence's y_aug [..., heads, hd + 1] -> its numerator over
    max(|normaliser|, 1), [W, B, S, heads * hd] in h_res's dtype."""
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    # torch.maximum splits the gradient of a tie in half, as jnp.maximum
    hid = num / torch.maximum(torch.abs(den), den.new_ones(()))
    return hid.reshape(*h_res.shape[:-1], -1).to(h_res.dtype)


def _mlstm_down(ps: list, h_res, hids: list, gate, cfg: ModelConfig):
    """The block's output from each slot's hidden heads ``hids[j]`` (one
    slot, or each slot of ``ps`` its heads' part): ln_inner's RMS over
    every slot's heads (joined on h_res's device), gated, projected down
    — w_down row-parallel over the slots, their outputs added
    (``layers.slot_sum``) —, plus the residual."""
    home = h_res.device
    hid = hids[0] if len(hids) == 1 else \
        torch.cat([t.to(home) for t in hids], dim=-1)
    hid = L.rms_norm(hid, ps[0]["ln_inner"], cfg.norm_eps) * F.silu(gate)
    if len(hids) == 1:
        return h_res + L.matmul(hid, ps[0]["w_down"])
    cols = hids[0].shape[-1]
    return h_res + L.slot_sum([L.matmul(
        hid[..., j * cols:(j + 1) * cols].to(p["w_down"].device),
        p["w_down"]) for j, p in enumerate(ps)], home)


def _mlstm_pieces(ps: list, x: torch.Tensor, cfg: ModelConfig, chunk: int,
                  final: bool):
    """The mLSTM block over a worker's model-axis slots (``mlstm_pieces``;
    one slot for an unsplit block) -> ([W, B, S, d] on x's device, the
    final state [W * B, H, n_qk, hd + 1] or None)."""
    home, p0 = x.device, ps[0]
    wn, bsz, s, d = x.shape
    d_up, h, hd, _ = _mlstm_dims(cfg)
    h_res = x
    x = L.rms_norm(x, p0["ln"], cfg.norm_eps)
    up = L.join_columns(ps, "w_up", 2 * d_up, lambda p: L.matmul(
        x.to(p["w_up"].device), p["w_up"]), home)
    a, gate = torch.chunk(up, 2, dim=-1)
    # the heads a slot: wq / wk / wv and w_down split on head boundaries
    # (runtime/sharding.leaf_splits) or held whole, then run on slot 0;
    # q / k / v before the gates, so that one slot sums the gradient into
    # a in the unsplit block's order
    heads = ps if p0["wv"].shape[-1] < d_up else ps[:1]
    hs = h // len(heads)
    qkv = [_mlstm_qkv(p, a.to(p["wv"].device), hs) for p in heads]
    igate, fgate = _mlstm_gates(p0, a)
    log_f = F.logsigmoid(fgate)                              # [W,B,S,H]
    i_mult = torch.exp(igate)                                # update gate
    nb = wn * bsz
    hids, states = [], []
    for j, (q, k, v) in enumerate(qkv):
        dev, at = v.device, slice(j * hs, (j + 1) * hs)
        # the normaliser: the same recurrence on an extra ones column of v
        y_aug, st = chunked_recurrence(
            _v_aug(v).reshape(nb, s, hs, hd + 1),
            gate=i_mult[..., at].to(dev).reshape(nb, s, hs),
            log_decay=log_f[..., at].to(dev).reshape(nb, s, hs),
            b=k.reshape(nb, s, hs, -1), c=q.reshape(nb, s, hs, -1),
            chunk=chunk, final=final)
        hids.append(_hidden(y_aug, h_res))
        states.append(st)
    st = None if not final else states[0] if len(states) == 1 else \
        torch.cat([t.to(home) for t in states], dim=1)
    return _mlstm_down(heads, h_res, hids, gate, cfg), st


def _mlstm(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int,
           final: bool):
    """Full-sequence mLSTM block of a fleet: x [W, B, S, d] -> ([W, B, S,
    d], the final state [W * B, H, n_qk, hd + 1] or None)."""
    return _mlstm_pieces([p], x, cfg, chunk, final)


def mlstm_pieces(ps: list, x: torch.Tensor, cfg: ModelConfig,
                 chunk: int = 256) -> torch.Tensor:
    """``apply_mlstm`` over a worker's model-axis slots (the spec rules:
    ``w_up``, ``wq``, ``wk``, ``wv`` split on their columns, ``w_down``
    on its rows, the gates and norms whole): ``ps[j]`` slot j's block
    leaves ([W, ...] on its device), x [W, B, S, d] on slot 0's. Each
    slot computes its columns of x @ w_up and the pieces join on slot 0
    (the cut falls on the a | gate boundary at m = 2, inside each half at
    m = 4), which computes the gates from its whole ``w_igate`` /
    ``w_fgate``; each slot then runs q, k, v and the chunked recurrence
    on its heads (the whole a, its heads' gates). ``ln_inner``
    normalises over every slot's heads, joined on slot 0; ``w_down`` is
    row-parallel, slot j taking its heads' columns of the gated hidden
    state, the slots' outputs added (``layers.slot_sum``). A leaf the
    rule keeps whole is read from slot 0's copy."""
    return _mlstm_pieces(ps, x, cfg, chunk, final=False)[0]


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


def _slstm_step(r: torch.Tensor, state: dict, x_proj: torch.Tensor) -> dict:
    """One token: x_proj [W, B, 4 d] (W x + b precomputed), the recurrence
    ``r`` [W, 4, H, dh, dh], the state of ``init_slstm_state`` -> the next
    state."""
    wn, bsz = x_proj.shape[:2]
    h_heads, dh = r.shape[2], r.shape[3]
    # recurrent contribution: block-diagonal R @ h_{t-1}, per gate
    rec = torch.einsum("wghde,wbhe->wbghd", r.to(torch.float32),
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


def slstm_pieces(ps: list, x: torch.Tensor, cfg: ModelConfig, state=None):
    """``apply_slstm`` over a worker's model-axis slots (the spec rules:
    ``w_in`` split on its columns, ``r`` on its heads, the FFN's
    ``w_ffn_gate`` / ``w_ffn_up`` on their columns and ``w_ffn_down`` on
    its rows where its width divides, the rest whole): ``ps[j]`` slot j's
    block leaves, x [W, B, S, d] on slot 0's device. Each slot computes
    its columns of x @ w_in (the cut falls on gate boundaries, z, i | f,
    o at m = 2, not on heads); the projection and ``r``'s heads join on
    slot 0, which runs the token loop once, as one slot does. The FFN is
    column- and row-parallel (``layers.slot_sum``) where it is split, else
    slot 0's. Under ``token_loop`` (``meta`` tensors only) a capped number
    of trips. Returns ([W, B, S, d], the final state) on slot 0's
    device."""
    home, p0 = x.device, ps[0]
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
    xn = L.rms_norm(x, p0["ln"], cfg.norm_eps)
    x_proj = L.join_columns(ps, "w_in", 4 * d, lambda p: L.matmul(
        xn.to(p["w_in"].device), p["w_in"]), home) \
        + p0["b"][:, None, None].to(xn.dtype)
    r = p0["r"] if p0["r"].shape[2] == cfg.num_heads else \
        torch.cat([p["r"].to(home) for p in ps], dim=2)
    st = state or init_slstm_state(cfg, wn, bsz, device=x.device)
    hs = []
    for t in range(trips):
        if loop is not None:
            loop.trip = t
        st = _slstm_step(r, st, x_proj[:, :, t])
        hs.append(st["h"])
    if loop is not None:
        loop.trip = None
    hs += hs[-1:] * (s - trips)
    hid = torch.stack(hs, dim=2).reshape(wn, bsz, s, d).to(x.dtype)
    hid = L.rms_norm(hid, p0["ln_inner"], cfg.norm_eps)
    x = h_res + hid
    # gated FFN sub-block
    m = L.rms_norm(x, p0["ln2"], cfg.norm_eps)

    def ffn(p):
        mj = m.to(p["w_ffn_gate"].device)
        return L.matmul(F.silu(L.matmul(mj, p["w_ffn_gate"]))
                        * L.matmul(mj, p["w_ffn_up"]), p["w_ffn_down"])

    if p0["w_ffn_down"].shape[-2] == _slstm_shapes(cfg)["w_ffn_down"][0]:
        return x + ffn(p0), st
    return x + L.slot_sum([ffn(p) for p in ps], home), st


def apply_slstm(p: dict, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Full-sequence sLSTM block of a fleet, token by token: x [W, B, S, d]
    -> ([W, B, S, d], the final state); under ``token_loop`` (``meta``
    tensors only) a capped number of trips."""
    return slstm_pieces([p], x, cfg, state)


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


def forward_pieces(cfg: ModelConfig, slots: list, tokens: torch.Tensor):
    """The forward of a worker's replica held over its model-axis slots
    (``dense.loss_fn_pieces``' layout: ``slots[j]`` slot j's leaves, one
    slot for an unsplit replica; tokens [W, B, S] on slot 0's device):
    the embedding over the vocabulary pieces (``layers.embed_slots``),
    each mLSTM block by ``mlstm_pieces`` and each sLSTM block by
    ``slstm_pieces``, every block under ``cfg.remat``; a leaf every slot
    holds whole is read from slot 0's copy. Returns the final hidden
    states [W, B, S, D] on slot 0's device."""
    L.check_trainable(cfg)
    x = L.embed_slots(slots, tokens, cfg.vocab_size)
    mlstm = L.remat(lambda h, bps: mlstm_pieces(bps, h, cfg), cfg)
    slstm = L.remat(lambda h, bps: slstm_pieces(bps, h, cfg)[0], cfg)
    for stack, idx, is_slstm in _cache_layers(cfg):
        x = (slstm if is_slstm else mlstm)(
            x, [L.layer(p, stack, idx) for p in slots])
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
    q, k, v = _mlstm_qkv(p, a, p["w_igate"].shape[-1])
    igate, fgate = _mlstm_gates(p, a)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]           # [W,B,H,*]
    f = torch.exp(F.logsigmoid(fgate[:, :, 0]))             # [W,B,H]
    i = torch.exp(igate[:, :, 0])
    C.mul_(f[..., None, None]).add_(
        i[..., None, None] * torch.einsum("wbhn,wbhp->wbhnp",
                                          k.to(torch.float32), _v_aug(v)))
    y_aug = torch.einsum("wbhn,wbhnp->wbhp", q.to(torch.float32), C)
    return _mlstm_down([p], h_res, [_hidden(y_aug[:, :, None], h_res)],
                       gate, cfg)


def decode_slstm(p: dict, x: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    """Single-token sLSTM step: x [W, B, 1, d]; ``state`` the {c, n, h,
    m} cache views, advanced in place. Returns [W, B, 1, d]."""
    wn, bsz, _, d = x.shape
    h_res = x
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    x_proj = (L.matmul(xn, p["w_in"])
              + p["b"][:, None, None].to(xn.dtype))[:, :, 0]
    st = _slstm_step(p["r"], state, x_proj)
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
