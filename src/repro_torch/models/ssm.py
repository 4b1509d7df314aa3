"""Mamba2 / SSD blocks (zamba2's backbone): the port of
``repro.models.ssm``.

The selective state-space layer is the reference's chunked SSD
algorithm: intra-chunk terms are attention-like einsums, and a loop over
chunks carries the ``[B, H, n, p]`` state. ``ssd_ref`` is the
sequential-scan oracle the tests hold it against.

The recurrence has no weights, so it takes the fleet's sequences as one
batch (``[W * B, ...]``, as the attention does); ``apply_mamba2`` runs a
block of worker-stacked parameters ``[W, ...]`` on activations ``[W, B,
S, d]``. Serving: ``prefill_mamba2`` also returns the block's final
state and convolution context, and ``decode_mamba2`` is the O(1)
recurrent step, updating that cache in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

HEAD_DIM = 64          # mamba2 default headdim p
CONV_WIDTH = 4

# leaves of a Mamba2 block stored in f32 whatever cfg.dtype says
F32_LEAVES = frozenset({"a_log", "dt_bias", "d_skip"})


def num_ssm_heads(d_inner: int) -> int:
    """Mamba2 heads of width ``HEAD_DIM`` over the inner width."""
    return max(1, d_inner // HEAD_DIM)


def mamba2_shapes(d_model: int, ssm_state: int) -> dict[str, tuple]:
    """One block's leaf shapes by name."""
    d_in = 2 * d_model
    h = num_ssm_heads(d_in)
    conv_ch = d_in + 2 * ssm_state
    return {"a_log": (h,), "conv_b": (conv_ch,),
            "conv_w": (CONV_WIDTH, conv_ch), "d_skip": (h,),
            "dt_bias": (h,), "in_proj": (d_model, 2 * d_in + 2 * ssm_state
                                         + h),
            "norm": (d_in,), "out_proj": (d_in, d_model)}


def init_mamba2(gen: torch.Generator, d_model: int, ssm_state: int) -> dict:
    """One worker's block, by the reference's init laws."""
    shapes = mamba2_shapes(d_model, ssm_state)
    h = shapes["a_log"][0]
    return {
        "in_proj": L.dense_init(gen, shapes["in_proj"]),
        "conv_w": L.dense_init(gen, shapes["conv_w"], scale=0.5),
        "conv_b": torch.zeros(shapes["conv_b"]),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32)),
        "dt_bias": torch.zeros(h),
        "d_skip": torch.ones(h),
        "norm": torch.zeros(shapes["norm"]),
        "out_proj": L.dense_init(gen, shapes["out_proj"]),
    }


def _split_proj(zxbcdt: torch.Tensor, d_model: int, n: int):
    """The input projection's output zxbcdt [W, B, S, 2 d_in + 2 n + H]
    -> (z, xbc, dt, d_in, heads)."""
    d_in = 2 * d_model
    h = num_ssm_heads(d_in)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, h], dim=-1)
    return z, xbc, dt, d_in, h


def _causal_conv(p: dict, xbc: torch.Tensor, conv_state=None):
    """Depthwise causal convolution of width 4 over xbc [W, B, S, C] with
    each worker's conv_w [W, 4, C] and conv_b [W, C] -> (silu(out), the
    trailing [W, B, 3, C] context). ``conv_state`` replaces the zero
    left padding (the decode path's context)."""
    wn, b, s, ch = xbc.shape
    pad = (torch.zeros(wn, b, CONV_WIDTH - 1, ch, dtype=xbc.dtype,
                       device=xbc.device)
           if conv_state is None else conv_state)
    xp = torch.cat([pad, xbc], dim=2)                    # [W, B, S+3, C]
    w = p["conv_w"][:, None, None]                       # [W, 1, 1, 4, C]
    out = xp[:, :, 0:s] * w[..., 0, :]
    for i in range(1, CONV_WIDTH):
        out = out + xp[:, :, i:i + s] * w[..., i, :]
    out = F.silu(out + p["conv_b"][:, None, None])
    return out, xp[:, :, -(CONV_WIDTH - 1):]


def chunk_len(seq_len: int, chunk: int = 256) -> int:
    """The recurrence's chunk length q at ``seq_len`` (the reference's
    rule: min(chunk, S), halved until it divides S)."""
    q = min(chunk, seq_len)
    while seq_len % q:
        q //= 2
    return q


def chunked_recurrence(xh, gate, log_decay, b, c, chunk: int = 256,
                       state0=None, *, final: bool = True):
    """The chunked linear recurrence SSD and mLSTM share. Per head

        S_t = exp(log_decay_t) S_{t-1} + gate_t b_t (x) x_t,
        y_t = c_t . S_t.

    xh [B, S, H, p]; gate, log_decay [B, S, H]; b, c [B, S, n] (shared by
    the heads, mamba2) or [B, S, H, n] (per head, mLSTM), in chunks of
    ``chunk_len(S, chunk)`` tokens. Returns (y [B, S, H, p], final state
    [B, H, n, p]).

    ``final=False`` returns None for the state and computes only what y
    reads: the last chunk's summary feeds the final state alone, and
    with one chunk and no ``state0`` there is no inter-chunk term (its
    state is zero), so y is the intra-chunk term — the same values, and
    the ``[B, nc, H, n, p]`` chunk states are not held."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    per_head = b.dim() == 4
    q = chunk_len(s, chunk)
    nc = s // q
    f32 = torch.float32
    xc = xh.reshape(bsz, nc, q, h, p).to(f32)
    dtc = gate.to(f32).reshape(bsz, nc, q, h)
    dac = log_decay.to(f32).reshape(bsz, nc, q, h)
    bshape = (bsz, nc, q, h, n) if per_head else (bsz, nc, q, n)
    bc = b.reshape(bshape).to(f32)
    cc = c.reshape(bshape).to(f32)
    lcum = torch.cumsum(dac, dim=2)                          # [B,nc,q,H]

    # ---- intra-chunk (attention-like) ----
    # M[t, s] = exp(l_t - l_s) (C_t . B_s) gate_s for s <= t; above the
    # diagonal l_t - l_s > 0 can overflow, so it is masked to -inf BEFORE
    # the exp (an inf there would make the backward's inf * 0 a NaN)
    rel = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]    # [B,nc,q,q,H]
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xh.device))
    rel = torch.where(tri[None, None, :, :, None], rel,
                      torch.tensor(-math.inf, dtype=f32, device=xh.device))
    if per_head:
        cb = torch.einsum("bgthn,bgshn->bgtsh", cc, bc)      # [B,nc,q,q,H]
        m = torch.exp(rel) * cb * dtc[:, :, None, :, :]
    else:
        cb = torch.einsum("bgtn,bgsn->bgts", cc, bc)         # [B,nc,q,q]
        m = torch.exp(rel) * cb[..., None] * dtc[:, :, None, :, :]
    y = torch.einsum("bgtsh,bgshp->bgthp", m, xc)

    # the chunk summaries y or the final state reads
    need = nc if final else nc - 1
    if need == 0 and state0 is None:
        return y.reshape(bsz, s, h, p).to(xh.dtype), None

    # ---- chunk summaries ----
    # state contribution of chunk g: sum_s exp(l_end - l_s) gate_s B_s x_s^T
    dec_end = torch.exp(lcum[:, :need, -1:, :] - lcum[:, :need])
    wts = dec_end * dtc[:, :need]
    if per_head:
        states = torch.einsum("bgsh,bgshn,bgshp->bghnp", wts, bc[:, :need],
                              xc[:, :need])                  # [B,nc,H,n,p]
    else:
        states = torch.einsum("bgsh,bgsn,bgshp->bghnp", wts, bc[:, :need],
                              xc[:, :need])
    chunk_decay = torch.exp(lcum[:, :, -1, :])               # [B,nc,H]

    # ---- inter-chunk state recurrence (a loop over chunks) ----
    carry = (torch.zeros(bsz, h, n, p, dtype=f32, device=xh.device)
             if state0 is None else state0.to(f32))
    prev = []                                # the state BEFORE each chunk
    for g in range(nc):
        prev.append(carry)
        if g < need:
            carry = carry * chunk_decay[:, g, :, None, None] + states[:, g]
    prev_states = torch.stack(prev, dim=1)                   # [B,nc,H,n,p]

    # ---- inter-chunk contribution: y_t += C_t^T (exp(l_t) S_chunk_start)
    dec_in = torch.exp(lcum)                                 # [B,nc,q,H]
    if per_head:
        y_inter = torch.einsum("bgthn,bghnp->bgthp", cc, prev_states) \
            * dec_in[..., None]
    else:
        y_inter = torch.einsum("bgtn,bghnp->bgthp", cc, prev_states) \
            * dec_in[..., None]
    y = (y + y_inter).reshape(bsz, s, h, p)
    return y.to(xh.dtype), (carry if final else None)


def _decay_rate(a_log: torch.Tensor) -> torch.Tensor:
    """a = -exp(a_log), shaped against dt [B, S, H]: a_log [H], or [B, H]
    (each sequence its worker's row)."""
    a = -torch.exp(a_log)
    return a if a.dim() == 1 else a[:, None, :]


def ssd_chunked(xh, dt, a_log, b, c, chunk: int = 256, state0=None, *,
                final: bool = True):
    """Chunked SSD (mamba2): xh [B, S, H, p]; dt [B, S, H]; b, c [B, S,
    n]; a_log [H] or [B, H]. Returns (y [B, S, H, p], final state [B, H,
    n, p]) — the state None with ``final=False`` (see
    ``chunked_recurrence``)."""
    dt = dt.to(torch.float32)
    return chunked_recurrence(xh, gate=dt, log_decay=dt * _decay_rate(a_log),
                              b=b, c=c, chunk=chunk, state0=state0,
                              final=final)


def ssd_ref(xh, dt, a_log, b, c, state0=None):
    """Sequential-scan oracle for tests, token by token. Same signature as
    ``ssd_chunked``."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    f32 = torch.float32
    a = _decay_rate(a_log)
    a = a[:, 0] if a.dim() == 2 else a
    st = (torch.zeros(bsz, h, n, p, dtype=f32, device=xh.device)
          if state0 is None else state0.to(f32))
    ys = []
    for i in range(s):
        x_t, dt_t = xh[:, i].to(f32), dt[:, i].to(f32)
        b_t, c_t = b[:, i].to(f32), c[:, i].to(f32)
        dec = torch.exp(dt_t * a)                            # [B,H]
        upd = torch.einsum("bh,bn,bhp->bhnp", dt_t, b_t, x_t)
        st = st * dec[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c_t, st))
    return torch.stack(ys, dim=1).to(xh.dtype), st


def recurrence_floats(heads: int, n: int, p: int, seq_len: int) -> int:
    """What ``chunked_recurrence(..., final=False)`` keeps per token,
    about: the chunk's masked decays, their exponentials and the [q, q]
    mixing terms per head, and past one chunk the chunk states and the
    states before each chunk ([B, nc, H, n, p] each, over q tokens)."""
    q = chunk_len(seq_len)
    out = 4 * q * heads + q
    if seq_len > q:
        out += 2 * heads * n * p // q + heads * n * p // seq_len
    return out


def mamba2_floats(d_model: int, ssm_state: int, seq_len: int) -> int:
    """What one Mamba2 block's forward keeps per token, about: the
    projection, the convolution's padded input, partial sums and
    activation, the recurrence, and a dozen [d_in] intermediates of the
    skip, gate and norm."""
    d_in = 2 * d_model
    h = num_ssm_heads(d_in)
    conv_ch = d_in + 2 * ssm_state
    return (4 * d_model + 2 * d_in + 2 * ssm_state + h + 7 * conv_ch
            + 12 * d_in + 4 * h
            + recurrence_floats(h, ssm_state, HEAD_DIM, seq_len))


def _mamba2(p: dict, x: torch.Tensor, ssm_state_dim: int, chunk: int,
            final: bool):
    """A Mamba2 block body of a fleet: x [W, B, S, d] -> (out [W, B, S,
    d], the final state [W * B, H, n, p] or None, the trailing
    convolution context [W, B, 3, C])."""
    y, st, conv_state = _mamba2_mixer(p, L.matmul(x, p["in_proj"]),
                                      x.shape[-1], ssm_state_dim, chunk,
                                      final)
    return L.matmul(y, p["out_proj"]), st, conv_state


def _mamba2_mixer(p: dict, zxbcdt: torch.Tensor, d: int,
                  ssm_state_dim: int, chunk: int, final: bool):
    """A Mamba2 block between its two projections: the input projection's
    output zxbcdt [W, B, S, 2 d_in + 2 n + H] -> (the gated, normed y
    [W, B, S, d_in] that ``out_proj`` takes, the final state or None,
    the trailing convolution context): the causal convolution, the
    chunked SSD, the skip and the gated RMSNorm, with ``p``'s
    ``conv_w`` / ``conv_b`` / ``dt_bias`` / ``a_log`` / ``d_skip`` /
    ``norm``."""
    wn, bsz, s, _ = zxbcdt.shape
    n = ssm_state_dim
    z, xbc, dt, d_in, h = _split_proj(zxbcdt, d, n)
    xbc, conv_state = _causal_conv(p, xbc)
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][:, None, None])
    xh = xs.reshape(wn, bsz, s, h, HEAD_DIM)
    # the sequences of all workers as one batch, each with its worker's
    # decay rates
    a_log = p["a_log"][:, None].expand(wn, bsz, h).reshape(wn * bsz, h)
    y, st = ssd_chunked(xh.reshape(wn * bsz, s, h, HEAD_DIM),
                        dt.reshape(wn * bsz, s, h), a_log,
                        b.reshape(wn * bsz, s, n), c.reshape(wn * bsz, s, n),
                        chunk=chunk, final=final)
    y = y.reshape(wn, bsz, s, h, HEAD_DIM) \
        + xh.to(torch.float32) * p["d_skip"][:, None, None, :, None]
    y = y.reshape(wn, bsz, s, d_in).to(zxbcdt.dtype)
    return L.rms_norm(y * F.silu(z), p["norm"]), st, conv_state


def apply_mamba2(p: dict, x: torch.Tensor, ssm_state_dim: int, *,
                 chunk: int = 256) -> torch.Tensor:
    """Full-sequence Mamba2 block body of a fleet: x [W, B, S, d] with one
    block's worker-stacked leaves -> [W, B, S, d]."""
    return _mamba2(p, x, ssm_state_dim, chunk, final=False)[0]


def mamba2_pieces(ps: list, x: torch.Tensor, ssm_state_dim: int, *,
                  chunk: int = 256) -> torch.Tensor:
    """``apply_mamba2`` over a worker's model-axis slots (the spec rules:
    ``in_proj`` split on its columns, ``conv_w`` on its channels,
    ``out_proj`` on its rows, the rest whole): ``ps[j]`` slot j's block
    leaves ([W, ...] on its device), x [W, B, S, d] on slot 0's. Each
    slot computes its columns of x @ in_proj and the pieces join on slot
    0 (the contiguous cut does not fall on the z | x | B | C | dt
    boundaries, nor ``conv_w``'s on x | B | C), where the convolution,
    the SSD and the gated RMSNorm run with slot 0's whole leaves and the
    joined ``conv_w``; ``out_proj`` is row-parallel, slot j taking y's
    d_in columns [j d_in / m, (j + 1) d_in / m), the slots' outputs added
    (``layers.slot_sum``). A leaf the rule keeps whole is read from slot
    0's copy."""
    home, p0 = x.device, ps[0]
    d = x.shape[-1]
    shapes = mamba2_shapes(d, ssm_state_dim)
    zxbcdt = L.join_columns(ps, "in_proj", shapes["in_proj"][-1], lambda p:
                            L.matmul(x.to(p["in_proj"].device),
                                     p["in_proj"]), home)
    mixer = dict(p0, conv_w=L.join_columns(
        ps, "conv_w", shapes["conv_w"][-1], lambda p: p["conv_w"], home))
    y, _, _ = _mamba2_mixer(mixer, zxbcdt, d, ssm_state_dim, chunk,
                            final=False)
    rows = p0["out_proj"].shape[-2]
    if rows == shapes["out_proj"][0]:
        return L.matmul(y, p0["out_proj"])
    return L.slot_sum([L.matmul(y[..., j * rows:(j + 1) * rows].to(
        p["out_proj"].device), p["out_proj"]) for j, p in enumerate(ps)],
        home)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_mamba2_cache(batch: int, d_model: int, ssm_state: int, dtype,
                      *, lead: tuple[int, ...] = (1,), device=None) -> dict:
    """A zero cache of Mamba2 blocks stacked on ``lead`` axes (the worker
    axis first): ``state`` [*lead, B, H, n, p] f32 and ``conv`` [*lead,
    B, 3, C] in ``dtype``."""
    d_in = 2 * d_model
    h = num_ssm_heads(d_in)
    return {
        "state": torch.zeros((*lead, batch, h, ssm_state, HEAD_DIM),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, CONV_WIDTH - 1,
                             d_in + 2 * ssm_state), dtype=dtype,
                            device=device),
    }


def prefill_mamba2(p: dict, x: torch.Tensor, ssm_state_dim: int,
                   state: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """``apply_mamba2`` that also writes the block's final state into
    ``state`` [W, B, H, n, p] and its trailing convolution context into
    ``conv`` [W, B, 3, C] (cache views), in place."""
    out, st, conv_state = _mamba2(p, x, ssm_state_dim, 256, final=True)
    state.copy_(st.reshape(state.shape))
    conv.copy_(conv_state)
    return out


def decode_mamba2(p: dict, x: torch.Tensor, state: torch.Tensor,
                  conv: torch.Tensor, ssm_state_dim: int) -> torch.Tensor:
    """Single-token Mamba2 step: x [W, B, 1, d] with one block's
    worker-stacked leaves; ``state`` [W, B, H, n, p] f32 and ``conv``
    [W, B, 3, C] (cache views) advanced in place. Returns [W, B, 1, d]."""
    wn, bsz, _, d = x.shape
    n = ssm_state_dim
    f32 = torch.float32
    z, xbc, dt, d_in, h = _split_proj(L.matmul(x, p["in_proj"]), d, n)
    xbc, conv_state = _causal_conv(p, xbc, conv)
    xs, b, c = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"][:, None, None])[:, :, 0]
    xh = xs.reshape(wn, bsz, h, HEAD_DIM).to(f32)
    dec = torch.exp(dt * -torch.exp(p["a_log"])[:, None])       # [W,B,H]
    upd = torch.einsum("wbh,wbn,wbhp->wbhnp", dt, b[:, :, 0].to(f32), xh)
    state.mul_(dec[..., None, None]).add_(upd)
    conv.copy_(conv_state)
    y = torch.einsum("wbn,wbhnp->wbhp", c[:, :, 0].to(f32), state)
    y = y + xh * p["d_skip"][:, None, :, None]
    y = y.reshape(wn, bsz, 1, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"])
    return L.matmul(y, p["out_proj"])
