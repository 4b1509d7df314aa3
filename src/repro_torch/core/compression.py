"""Compressed gossip codecs: int8 quantization and top-k / rand-k
sparsification with error feedback — the port of
``repro.core.compression``: the codec descriptions and Eq. 10 wire
accounting on the host, and the compensated update both engines run on
the device.

``cfg.compress`` selects the codec (``parse_mode`` -> ``Codec``):
``"none"`` sends raw f32 parameters, ``"int8"`` per-(8, 1024)-tile
scaled int8, ``"topk:<k>"`` value+index pairs and ``"randk:<k>"`` values
plus a shared mask seed (k a fraction of P when < 1, an absolute count
otherwise). The per-leaf ``"leafmap:..."`` maps are not ported
(ROADMAP.md queue 1, item 8).

All codecs share one state shape, a per-worker [W, P] buffer next to the
params (``carries_state`` / ``state_init``): int8 carries the
error-feedback residual (z = x + e, ŷ = C(z), e' = z - ŷ,
x' = x + (W ŷ - ŷ)); top-k with error feedback the tracked public copy
x̂ (q = topk(x - x̂), x̂' = x̂ + q, x' = x + gamma (W x̂' - x̂')); rand-k
nothing — its mask is shared by every worker and drawn from a seeded
stream (``sparsify_base_key`` / ``randk_scores``), a numpy copy of the
reference's threefry2x32 ``jax.random`` stream, bit for bit.

The codec round trips (``qdq_rows``, ``sparsify_rows``) go through
``kernels/ops.py``: CUDA tensors launch the hand-written quantize,
dequantize and sparsify kernels, CPU tensors run their plain versions.
The mixing delta ``W v - v`` stays a dense ``torch.matmul``, as the
reference leaves it to XLA. The top-k threshold (each row's k-th largest
gate) comes from ``torch.topk`` outside the kernel, as the reference
takes it from ``lax.top_k``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import BLOCK_COLS, BLOCK_ROWS

COMPRESS_MODES = ("none", "int8", "topk:<k>", "randk:<k>",
                  "leafmap:<pat>=<codec>,...")
SPARSE_KINDS = ("topk", "randk")
UNIFORM_KINDS = ("none", "int8", "topk", "randk")

FP32_BITS = 32
INT8_BITS = 8
SCALE_BITS = 32
INDEX_BITS = 32     # top-k ships one explicit coordinate index per value
SEED_BITS = 32      # rand-k ships only the shared mask seed

# rand-k mask stream constant: folds cfg.seed into a stream independent
# of the batch-sampling / model-init / AD-PSGD partner streams
_SPARSE_STREAM = 0x5A


def pad_to_blocks(r: int, c: int, block_rows: int = BLOCK_ROWS,
                  block_cols: int = BLOCK_COLS) -> tuple[int, int, int, int]:
    """Block shape + padded extent for an [R, C] operand: blocks never
    exceed the array, and the array is padded up to a whole block grid
    (``repro.kernels.gossip_mix.pad_to_blocks``)."""
    br, bc = min(block_rows, r), min(block_cols, c)
    rp = -(-r // br) * br
    cp = -(-c // bc) * bc
    return br, bc, rp, cp


@dataclass(frozen=True)
class Codec:
    """One parsed ``cfg.compress`` wire codec.

    ``kind`` is one of none | int8 | topk | randk; ``k`` is the sparse
    keep spec — a fraction of P when in (0, 1), an absolute coordinate
    count when >= 1, and 0 for the non-sparse kinds. ``RoundPlan.codec``
    carries the (possibly tightened) codec from the strategy into the
    engines, which charge Eq. 10 comm time / ``wire_ratio``.
    """

    kind: str
    k: float = 0.0

    @property
    def is_sparse(self) -> bool:
        """True for the top-k / rand-k sparsification kinds."""
        return self.kind in SPARSE_KINDS

    @property
    def mode(self) -> str:
        """The ``cfg.compress`` string this codec round-trips to."""
        return f"{self.kind}:{self.k:g}" if self.is_sparse else self.kind

    def with_k(self, k: float) -> "Codec":
        """Same kind, new keep spec (the planner's k-tightening step)."""
        return Codec(self.kind, float(k))

    def resolve_k(self, num_params: int) -> int:
        """The absolute per-row coordinate count for a P-sized payload."""
        if not self.is_sparse:
            return 0
        k = self.k * num_params if self.k < 1.0 else self.k
        return int(min(max(round(k), 1), num_params))

    def wire_bits(self, num_params: int) -> int:
        """Bits on the wire for one model transfer under this codec."""
        if self.kind == "none":
            return FP32_BITS * num_params
        if self.kind == "int8":
            rows, cols = flat_tile_shape(num_params)
            br, bc, rp, cp = pad_to_blocks(rows, cols, BLOCK_ROWS,
                                           BLOCK_COLS)
            n_tiles = (rp // br) * (cp // bc)
            return INT8_BITS * rows * cols + SCALE_BITS * n_tiles
        k = self.resolve_k(num_params)
        if self.kind == "topk":
            return k * (FP32_BITS + INDEX_BITS)
        return k * FP32_BITS + SEED_BITS                    # randk

    def wire_ratio(self, num_params: int) -> float:
        """Uncompressed / compressed wire bits — the Eq. 10 comm divisor
        and the ratio the adaptive planner solves tau*/topology against."""
        return FP32_BITS * num_params / self.wire_bits(num_params)


def parse_mode(mode) -> Codec:
    """Parse a ``cfg.compress`` value (or pass a ``Codec`` through).

    Accepts ``"none"``, ``"int8"``, ``"topk:<k>"`` and ``"randk:<k>"``
    with k a positive fraction (< 1, of P) or absolute count (>= 1).
    The per-leaf map ``"leafmap:..."`` raises ``NotImplementedError``."""
    if isinstance(mode, Codec):
        return mode
    if mode in ("none", "int8"):
        return Codec(str(mode))
    kind, sep, arg = str(mode).partition(":")
    if kind == "leafmap" and sep:
        raise NotImplementedError(
            "per-leaf codec maps (compress='leafmap:...') are not ported "
            "yet: ROADMAP.md queue 1, item 8 (registry models)")
    if kind in SPARSE_KINDS and sep:
        try:
            k = float(arg)
        except ValueError:
            k = 0.0
        if k > 0.0:
            return Codec(kind, k)
    raise ValueError(f"compress must be one of {COMPRESS_MODES} "
                     f"(k a positive fraction of P or an absolute "
                     f"count), got {mode!r}")


def validate_mode(mode: str) -> str:
    """Check a ``cfg.compress`` value against the supported wire modes
    (raises ValueError) and return it unchanged."""
    parse_mode(mode)
    return mode


def flat_tile_shape(num_params: int) -> tuple[int, int]:
    """[P] -> the [rows, cols] layout the int8 codec quantizes through."""
    cols = min(BLOCK_COLS, num_params)
    rows = -(-num_params // cols)
    return rows, cols


def wire_bits(num_params: int, mode: str = "int8") -> int:
    """Bits on the wire for one model transfer under ``mode`` (for int8,
    padding included — the payload ships the whole [rows, cols] grid)."""
    return parse_mode(mode).wire_bits(num_params)


def wire_ratio(num_params: int, mode: str = "int8") -> float:
    """Uncompressed / compressed wire bits — the comm-time divisor in
    Eq. 10 (1.0 for ``mode="none"``)."""
    return parse_mode(mode).wire_ratio(num_params)


# ---------------------------------------------------------------------------
# the rand-k mask stream: jax.random's threefry2x32, in numpy
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple[int, int], x0, x1) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under
    ``key`` — the block cipher behind ``jax.random``'s default PRNG."""
    u32 = np.uint32
    ks = (u32(key[0]), u32(key[1]),
          u32(key[0] ^ key[1] ^ 0x1BD11BDA))
    x = [np.asarray(x0, u32) + ks[0], np.asarray(x1, u32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << u32(r)) | (x[1] >> u32(32 - r))
            x[1] = x[1] ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3]
        x[1] = x[1] + u32(i + 1)
    return x[0], x[1]


def _fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the key hashed with the 32-bit ``data``."""
    a, b = _threefry2x32(key, [0], [data])
    return int(a[0]), int(b[0])


def sparsify_base_key(seed: int) -> tuple[int, int]:
    """The rand-k mask stream for one run, ``fold_in(PRNGKey(seed),
    0x5A)`` as a (hi, lo) pair of uint32 — independent of the
    batch-sampling, model-init and AD-PSGD partner streams, and SHARED by
    both engines (sender and receiver agree on the mask, which is why
    rand-k ships no indices)."""
    return _fold_in((0, int(seed) & 0xFFFFFFFF), _SPARSE_STREAM)


def randk_scores(key: tuple[int, int], step: int,
                 num_params: int) -> np.ndarray:
    """[P] f32 uniform keep scores in [0, 1), deterministic in (key,
    step) — ``jax.random.uniform(fold_in(key, step), (P,))`` bit for bit
    (the partitionable threefry of jax >= 0.5: bits = hi ^ lo of the
    cipher of (0, i)). ``step`` is the round index for the synchronous
    engines and the global event index for AD-PSGD; one draw per step is
    shared by every worker."""
    hi, lo = _threefry2x32(_fold_in(key, step),
                           np.zeros(num_params, np.uint32),
                           np.arange(num_params, dtype=np.uint32))
    bits = ((hi ^ lo) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


# ---------------------------------------------------------------------------
# codec round trips on a fleet's [W, P] rows
# ---------------------------------------------------------------------------

def qdq_rows(z: torch.Tensor) -> torch.Tensor:
    """z: [W, P] -> ŷ: [W, P], one int8 round trip per worker row (one
    quantize and one dequantize launch for the whole fleet)."""
    q, scales = ops.quantize_block(z)
    return ops.dequantize_block(q, scales, z.shape[1])


def sparsify_rows(z: torch.Tensor, kind: str, k: int, *,
                  scores: torch.Tensor | None = None) -> torch.Tensor:
    """z: [W, P] -> ŷ: [W, P], keeping k coordinates per row — top-k: the
    largest |z| of each worker; rand-k: the k largest of ``scores``, the
    step's [P] mask draw (``randk_scores``) on z's device, shared by all
    rows — and zeroing the rest (ties at the threshold are all kept)."""
    if kind == "topk":
        gate = z.abs()
    elif kind == "randk":
        gate = scores.reshape(1, -1)
    else:
        raise ValueError(f"not a sparse codec kind: {kind!r}")
    kth = torch.topk(gate, k, dim=1).values[:, -1]
    thresh = kth.expand(z.shape[0]).contiguous()
    return ops.sparsify_block(z, gate, thresh)[0]


def encode_rows(z: torch.Tensor, kind: str = "int8", k: int = 0, *,
                scores: torch.Tensor | None = None) -> torch.Tensor:
    """The codec round trip ŷ = C(z) for a batch of worker rows [W, P] —
    the single dispatch every compressed call site goes through."""
    if kind == "int8":
        return qdq_rows(z)
    return sparsify_rows(z, kind, k, scores=scores)


# ---------------------------------------------------------------------------
# the compensated update (canonical form)
# ---------------------------------------------------------------------------

def carries_state(kind: str, error_feedback: bool) -> bool:
    """Whether the codec evolves the per-worker [W, P] state buffer:
    int8 its residual and top-k its tracked public copy x̂ when error
    feedback is on; rand-k never (its unsent coordinates are raw state
    awaiting a later draw, not an unsent increment)."""
    if kind == "randk":
        return False
    return error_feedback


def state_init(flat: torch.Tensor, kind: str,
               error_feedback: bool) -> torch.Tensor | None:
    """The codec-state buffer at round 0 for initial params ``flat``
    [W, P]: zeros for the int8 residual, the (globally known) initial
    params for top-k's public copy x̂, and None where the run carries
    no state (uncompressed, rand-k, error feedback off)."""
    if kind == "none" or not carries_state(kind, error_feedback):
        return None
    if kind == "topk":
        return flat.clone()
    return torch.zeros_like(flat)


def state_after_join(err: torch.Tensor, keep_col: torch.Tensor,
                     flat: torch.Tensor, kind: str,
                     error_feedback: bool) -> torch.Tensor:
    """Reset joined workers' codec state after the donor-average re-init:
    the residual owes nothing (zeros); the top-k public copy x̂ becomes
    the blended row itself (the blend weights are deterministic, so every
    peer can reconstruct it). ``keep_col``: [W, 1] join mask; ``flat``:
    the post-blend [W, P]."""
    if kind == "topk" and error_feedback:
        return torch.where(keep_col, flat, err)
    return torch.where(keep_col, torch.zeros((), dtype=err.dtype), err)


def compress_decompress(flat, err, *, error_feedback: bool = True,
                        kind: str = "int8", k: int = 0, scores=None):
    """(x [W, P], e [W, P]) -> (ŷ, e'): the wire payload each worker
    sends under the int8 / rand-k / naive-top-k codecs, plus the state
    carried to the next round (unchanged unless int8 with error
    feedback). Top-k with error feedback does not take this form — see
    ``compressed_gossip_ref``."""
    ef = carries_state(kind, error_feedback) and kind != "topk"
    z = flat + err if ef else flat
    yhat = encode_rows(z, kind, k, scores=scores)
    return yhat, (z - yhat if ef else err)


def compressed_gossip_ref(flat, err, mix, *, error_feedback: bool = True,
                          kind: str = "int8", k: int = 0, scores=None,
                          gamma: float = 1.0):
    """One compressed gossip round on the flat [W, P] params with the
    dense [W, W] ``mix``, for any codec -> (x', state'):

        int8 / rand-k / naive top-k:  x' = x + (W ŷ - ŷ)
        top-k with error feedback:    q = topk(x - x̂), x̂' = x̂ + q,
                                      x' = x + gamma (W x̂' - x̂')

    Both forms preserve the fleet average for a doubly stochastic W and
    are exact no-ops through an identity mix. ``err`` is the state buffer
    (``state_init``; None for the stateless codecs), ``scores`` the
    round's rand-k mask draw on the device."""
    def mix_delta(v):
        return torch.matmul(mix, v) - v

    if kind == "topk" and error_feedback:
        xhat = err + sparsify_rows(flat - err, "topk", k)
        return flat + gamma * mix_delta(xhat), xhat
    yhat, new_err = compress_decompress(flat, err,
                                        error_feedback=error_feedback,
                                        kind=kind, k=k, scores=scores)
    return flat + mix_delta(yhat), new_err


def compressed_pair_ref(xi, xj, ei, ej, *, error_feedback: bool = True,
                        kind: str = "int8", k: int = 0, scores=None,
                        gamma: float = 1.0):
    """One compressed AD-PSGD pairwise exchange: the compensated update
    on a single edge with the 2x2 mix [[.5, .5], [.5, .5]], on [P] rows
    and their state rows -> (x_i', x_j', e_i', e_j'):

        x_i' = x_i + ½ (ŷ_j - ŷ_i),   x_j' = x_j + ½ (ŷ_i - ŷ_j)

    with ŷ = C(x + e) for int8 (residuals carried per worker), C(x) for
    rand-k (the event's shared mask draw) and naive top-k, and the
    x̂-tracked form (damped by ``gamma``) for top-k with error feedback.
    The endpoints' sum is preserved exactly; both rows' round trip is one
    codec call on the stacked [2, P] pair."""
    if kind == "topk" and error_feedback:
        q = sparsify_rows(torch.stack([xi - ei, xj - ej]), "topk", k)
        xhat_i, xhat_j = ei + q[0], ej + q[1]
        half = 0.5 * gamma * (xhat_j - xhat_i)
        return xi + half, xj - half, xhat_i, xhat_j
    ef = carries_state(kind, error_feedback)
    z = torch.stack([xi + ei, xj + ej]) if ef else torch.stack([xi, xj])
    yhat = encode_rows(z, kind, k, scores=scores)
    half = 0.5 * (yhat[1] - yhat[0])
    if ef:
        ei, ej = z[0] - yhat[0], z[1] - yhat[1]
    return xi + half, xj - half, ei, ej
