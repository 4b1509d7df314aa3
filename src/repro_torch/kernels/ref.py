"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against, and what ``ops`` runs on tensors
the caller placed on the CPU.

The wire codecs' kernels work on the flat ``[W, P]`` rows in the int8
codec's tile layout (``wire_tiles``): a worker's row is read as a
``[rows, cols]`` matrix with cols = min(1024, P), cut into tiles of
br = min(8, rows) whole rows, so tile t is the contiguous span
[t·br·cols, (t+1)·br·cols) of the row, clipped at P.

The attention functions take the registry models' layout: q [B, S, Hq,
hd], k and v [B, Sk, Hkv, hd].
"""
from __future__ import annotations

import math

import torch

# the reference's masked score (``repro/kernels/flash_attention.py``)
NEG_INF = -1e30

# the int8 codec's wire tile (``repro/kernels/quantize_block.py``)
BLOCK_ROWS = 8
BLOCK_COLS = 1024
QMAX = 127.0


def wire_tiles(num_params: int) -> tuple[int, int, int]:
    """[P] -> (row_len, tile_len, n_tiles): the padded wire row
    rows·cols, the tile span br·cols and the tiles per row."""
    cols = min(BLOCK_COLS, num_params)
    rows = -(-num_params // cols)
    tile_len = min(BLOCK_ROWS, rows) * cols
    return rows * cols, tile_len, -(-rows * cols // tile_len)


def _tiled(x: torch.Tensor, tile_len: int, n_tiles: int) -> torch.Tensor:
    """[W, L] -> [W, n_tiles, tile_len], zero-padded past L."""
    pad = n_tiles * tile_len - x.shape[1]
    return torch.nn.functional.pad(x, (0, pad)).view(x.shape[0], n_tiles,
                                                      tile_len)


def _to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def gossip_mix_ref(x: torch.Tensor, u: torch.Tensor, w: torch.Tensor, *,
                   centre: torch.Tensor | None = None,
                   round_bf16: bool = False) -> torch.Tensor:
    """x: [B, L]; u: [U, L]; w: [B, K], K a multiple of U -> y[b] = x[b]
    + sum_k w[b, k] (u[k mod U] - c[b]), c the ``centre`` [B, L] (default
    x), f32, accumulated for k ascending with one rounding per subtract,
    multiply and add — the kernel's exact arithmetic order, so the two
    agree bit for bit (an identity row of ``w`` is an exact no-op).
    ``round_bf16`` also rounds each term and each sum to bf16 (to nearest
    even, kept in f32): the reference's matching gossip on a bf16 leaf."""
    c = x if centre is None else centre
    acc = x
    for k in range(w.shape[1]):
        term = w[:, k:k + 1] * (u[k % u.shape[0]] - c)
        if round_bf16:
            acc = _to_bf16(acc + _to_bf16(term))
        else:
            acc = acc + term
    return acc


def gossip_mix_lanes_ref(x: torch.Tensor, u: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """x: [S, B, L]; u: [S, K, L]; w: [S, B, K] -> [S, B, L]: lane s is
    ``gossip_mix_ref(x[s], u[s], w[s])``, so the lanes are bit-equal to S
    separate calls."""
    return torch.stack([gossip_mix_ref(x[s], u[s], w[s])
                        for s in range(x.shape[0])])


def quantize_block_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [W, P] f32 -> (q int8 [W, rows·cols], scales f32 [W, n_tiles]):
    per tile scale = max(amax / 127, 1e-30) and q = clip(round_half_even(
    x / scale), ±127), divided (not multiplied by a reciprocal). The wire
    row's padding past P is zero in q."""
    w, p = x.shape
    row_len, tile_len, n_tiles = wire_tiles(p)
    t = _tiled(x, tile_len, n_tiles)
    amax = torch.amax(t.abs(), dim=2)
    # a tensor divisor: on CUDA, PyTorch turns division by a Python
    # scalar into a multiply by its reciprocal
    scales = torch.clamp(amax / torch.full_like(amax, QMAX), min=1e-30)
    q = torch.clamp(torch.round(t / scales[:, :, None]), -QMAX, QMAX)
    return q.view(w, -1)[:, :row_len].to(torch.int8), scales


def dequantize_block_ref(q: torch.Tensor, scales: torch.Tensor,
                         num_params: int) -> torch.Tensor:
    """Inverse of ``quantize_block_ref``: q int8 [W, rows·cols] and
    scales [W, n_tiles] -> y f32 [W, P], y = q · scale (one multiply)."""
    w = q.shape[0]
    _, tile_len, n_tiles = wire_tiles(num_params)
    y = _tiled(q.to(torch.float32), tile_len, n_tiles) * scales[:, :, None]
    return y.view(w, -1)[:, :num_params]


def sparsify_block_ref(x: torch.Tensor, gate: torch.Tensor,
                       thresh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [W, P]; gate: [W, P] or one shared row [1, P]; thresh: [W] ->
    (y [W, P], nnz int32 [W, n_tiles]): y keeps x where gate >= thresh of
    its row, else +0.0; nnz counts the survivors per tile (coordinates
    past P never count)."""
    w, p = x.shape
    _, tile_len, n_tiles = wire_tiles(p)
    keep = gate >= thresh[:, None]
    y = torch.where(keep, x, torch.zeros((), dtype=x.dtype))
    nnz = _tiled(keep.expand(w, p).to(torch.int32), tile_len, n_tiles)
    return y, nnz.sum(dim=2, dtype=torch.int32)


# ---------------------------------------------------------------------------
# edge-list gossip and robust aggregation
# ---------------------------------------------------------------------------

def csr_slots(row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor):
    """The CSR edge list slot by slot: for j = 0 .. max in-degree - 1
    yields (w_j [W], col_j [W]), the weight and source of every row's
    j-th incoming edge (weight 0 and source 0 where a row has fewer than
    j + 1 edges). Walking the slots in order adds each row's edges in
    list order, as the kernels do."""
    start = row_ptr[:-1].long()
    count = row_ptr[1:].long() - start
    slots = int(count.max()) if count.numel() else 0
    for j in range(slots):
        valid = count > j
        e = torch.where(valid, start + j, torch.zeros_like(start))
        yield (torch.where(valid, w[e], torch.zeros((), dtype=w.dtype,
                                                     device=w.device)),
               torch.where(valid, col[e].long(), torch.zeros_like(start)))


def gossip_edges_ref(x: torch.Tensor, t: torch.Tensor, row_ptr: torch.Tensor,
                     col: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x, t: [W, C] f32; a CSR edge list sorted by destination (row_ptr
    [W + 1], col [E] the sources, w [E] the weights) -> y[d] = x[d] +
    sum_e w_e (t[col_e] - x[d]) over row d's edges in list order, one
    rounding per subtract, multiply and add — the kernel's order, so the
    two agree bit for bit. Empty slots carry weight 0 and add an exact
    zero; t = x is honest gossip, t != x a lying wire."""
    acc = x
    for wj, cj in csr_slots(row_ptr, col, w):
        acc = acc + wj[:, None] * (t[cj] - x)
    return acc


def resolve_trim(b: float, cnt: torch.Tensor) -> torch.Tensor:
    """Per-worker trim count from the spec's ``b`` and the closed
    neighbourhood sizes ``cnt`` (int): a fractional b scales with cnt as
    floor(b · cnt) in f32, an absolute b is int(b); clamped to
    (cnt - 1) // 2 so the trimmed window is never empty."""
    if b < 1.0:
        bi = torch.floor(torch.tensor(b, dtype=torch.float32,
                                      device=cnt.device)
                         * cnt.to(torch.float32)).to(cnt.dtype)
    else:
        bi = torch.full_like(cnt, int(b))
    return torch.minimum(bi, torch.div(cnt - 1, 2, rounding_mode="floor"))


def robust_gossip_ref(x: torch.Tensor, t: torch.Tensor, nbr: torch.Tensor,
                      deg: torch.Tensor, *, b: float,
                      mode: str) -> torch.Tensor:
    """x, t: [W, C] f32; nbr: [W, D] padded neighbour table; deg: [W] ->
    per worker the coordinate-wise ``mode`` statistic of its own row x[i]
    and the transmitted rows t[nbr[i, :deg[i]]]: the window is sorted
    ascending (+inf in the padding slots sinks past it), then
    ``"trimmed"`` averages positions [b_i, cnt - b_i) (cnt = deg + 1,
    b_i = ``resolve_trim``), added in ascending position order and
    divided by cnt - 2 b_i, and ``"median"`` is half the sum of the two
    middle order statistics. Workers with deg 0 keep their row."""
    n, d_pad = nbr.shape
    deg = deg.long()
    slot = torch.arange(d_pad, device=x.device)[None, :]
    gathered = torch.where((slot < deg[:, None])[:, :, None],
                           t[nbr.long()], float("inf"))
    sv = torch.sort(torch.cat([x[:, None, :], gathered], dim=1), dim=1).values
    cnt = deg + 1
    if mode == "trimmed":
        bi = resolve_trim(b, cnt)
        acc = torch.zeros_like(x)
        for pos in range(d_pad + 1):
            inside = ((pos >= bi) & (pos < cnt - bi))[:, None]
            acc = acc + torch.where(inside, sv[:, pos], 0.0)
        # a tensor divisor: on CUDA a Python scalar divisor becomes a
        # reciprocal multiply
        y = acc / (cnt - 2 * bi).to(torch.float32)[:, None]
    elif mode == "median":
        lo = torch.div(cnt - 1, 2, rounding_mode="floor")[:, None, None]
        hi = torch.div(cnt, 2, rounding_mode="floor")[:, None, None]
        idx = lambda k: k.expand(n, 1, x.shape[1])  # noqa: E731
        y = 0.5 * (torch.gather(sv, 1, idx(lo))[:, 0]
                   + torch.gather(sv, 1, idx(hi))[:, 0])
    else:
        raise ValueError(f"unknown robust mode {mode!r}")
    return torch.where((deg > 0)[:, None], y, x)


# ---------------------------------------------------------------------------
# attention and consensus distance
# ---------------------------------------------------------------------------

def attention_mask(q_len: int, kv_len: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """Boolean [q_len, kv_len] mask: key kp is in reach of query qp when
    kp <= qp (causal) and kp > qp - window (a sliding window)."""
    qp = torch.arange(q_len, device=device)[:, None]
    kp = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention, the reference's composition: q [B, S,
    Hq, hd], k and v [B, Sk, Hkv, hd] -> [B, S, Hq, hd]; query head h
    reads KV head h // (Hq / Hkv). Scores are f32 (the operands' products
    summed in f32), divided by sqrt(hd), masked to -1e30 outside ``mask``
    [S, Sk] and soft-maxed over the keys in f32; the weights are rounded
    to v's dtype before the value product, which sums in f32 and rounds
    to v's dtype once — the reference's dtype steps (a no-op chain in
    f32)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhgst,bthd->bshgd", w.float(), v.float())
    return o.to(v.dtype).reshape(b, s, hq, hd)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, causal: bool, window: int) -> torch.Tensor:
    """``gqa_attention`` under the causal / sliding-window mask (no mask
    when neither is set), in the operands' dtype steps: the composition
    the reference's flash backward recomputes through
    (``repro/kernels/ops.py: _ref_model_layout``)."""
    mask = (attention_mask(q.shape[1], k.shape[1], causal=causal,
                           window=window, device=q.device)
            if causal or window else None)
    return gqa_attention(q, k, v, mask)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int) -> torch.Tensor:
    """The flash-attention kernel's function: ``masked_attention`` in
    f32. Operands of another dtype (bf16) are upcast and the output
    rounded to their dtype once — what the kernel computes on them: f32
    scores, softmax and weights, exact operands."""
    if q.dtype != torch.float32:
        return masked_attention(q.float(), k.float(), v.float(),
                                causal=causal, window=window).to(q.dtype)
    return masked_attention(q, k, v, causal=causal, window=window)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``t``: the spacing of bf16 values
    at |t| (8 significand bits), at the least normal for 0. The bf16
    flash instances are held to it against ``flash_attention_ref``."""
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def consensus_dist_ref(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x: [L]; u: [K, L] -> [K] L2 distances ||u_k - x|| (Eq. 7, square
    root included)."""
    return torch.sqrt(((u - x) ** 2).sum(1))
