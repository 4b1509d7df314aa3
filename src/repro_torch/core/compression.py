"""Compressed gossip codecs: int8 quantization and top-k / rand-k
sparsification with error feedback — the port of
``repro.core.compression``: the codec descriptions and Eq. 10 wire
accounting on the host, and the compensated update both engines run on
the device.

``cfg.compress`` selects the codec (``parse_mode`` -> ``Codec``):
``"none"`` sends raw f32 parameters, ``"int8"`` per-(8, 1024)-tile
scaled int8, ``"topk:<k>"`` value+index pairs and ``"randk:<k>"`` values
plus a shared mask seed (k a fraction of P when < 1, an absolute count
otherwise), and ``"leafmap:<pat>=<codec>,...,default=<codec>"`` a
per-leaf map of those four (``LeafmapCodec``: each leaf segment of the
flat row ships under its own codec, one mixing delta on the combined
payload).

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
reference leaves it to XLA, or over edge lists the deterministic
segment sum ``edge_mix_delta``. The top-k threshold (each row's k-th largest
gate) comes from ``torch.topk`` outside the kernel, as the reference
takes it from ``lax.top_k``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import robust
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


def parse_mode(mode) -> "Codec | LeafmapCodec":
    """Parse a ``cfg.compress`` value (or pass a ``Codec`` or
    ``LeafmapCodec`` through).

    Accepts ``"none"``, ``"int8"``, ``"topk:<k>"`` and ``"randk:<k>"``
    with k a positive fraction (< 1, of P) or absolute count (>= 1),
    plus the per-leaf map ``"leafmap:<pat>=<codec>,...,default=<codec>"``
    (``parse_leafmap``), e.g.
    ``"leafmap:embed=randk:0.05,ln=none,default=int8"``."""
    if isinstance(mode, (Codec, LeafmapCodec)):
        return mode
    if mode in ("none", "int8"):
        return Codec(str(mode))
    kind, sep, arg = str(mode).partition(":")
    if kind == "leafmap" and sep:
        return parse_leafmap(arg)
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


# ---------------------------------------------------------------------------
# per-leaf codec maps ("leafmap:..."): heterogeneous codecs over one model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSegment:
    """One contiguous run ``flat[:, start:stop]`` of the wire row that a
    single uniform ``Codec`` applies to. Built by ``LeafmapCodec.compile``
    from the adapter's leaf-offset table (adjacent leaves with the same
    codec merge into one segment; a sparse k fraction resolves against
    the merged segment's length)."""

    start: int
    stop: int
    codec: Codec
    k_abs: int = 0

    @property
    def size(self) -> int:
        """Segment length in parameters."""
        return self.stop - self.start


@dataclass(frozen=True)
class LeafmapCodec:
    """A per-leaf codec map: each model leaf gossips under its own wire
    codec (e.g. embeddings rand-k, layernorms uncompressed, the rest
    int8).

    ``rules`` are (substring pattern, Codec) pairs matched against the
    adapter's leaf names in order (first match wins, case-insensitive);
    ``default`` covers unmatched leaves. The parsed form is layout-free;
    the engines call ``compile(adapter.leaf_offsets())`` to bind it to a
    flat layout, which fills ``segments``, the table every payload and
    wire computation runs over. Frozen and tuple-valued, so a compiled
    map is hashable.

    Wire accounting is the exact per-segment sum of each segment's own
    codec's ``wire_bits(segment length)``; ``wire_ratio`` divides the
    uncompressed total by it. A leafmap is never ``is_sparse``: the
    planner's k-tightening refines uniform sparse codecs only."""

    rules: tuple
    default: Codec
    segments: tuple = ()
    kind: str = "leafmap"

    @property
    def is_sparse(self) -> bool:
        """False: k-tightening applies to uniform sparse codecs only."""
        return False

    @property
    def compiled(self) -> bool:
        """Whether ``compile`` has bound this map to a leaf layout."""
        return bool(self.segments)

    @property
    def mode(self) -> str:
        """The ``cfg.compress`` string this map round-trips to."""
        body = ",".join(f"{pat}={c.mode}" for pat, c in self.rules)
        sep = "," if body else ""
        return f"leafmap:{body}{sep}default={self.default.mode}"

    def codec_for(self, leaf_name: str) -> Codec:
        """The codec a leaf name maps to (first matching rule wins)."""
        name = leaf_name.lower()
        for pat, codec in self.rules:
            if pat in name:
                return codec
        return self.default

    def compile(self, leaves) -> "LeafmapCodec":
        """Bind to an adapter's leaf-offset table (objects with
        ``name`` / ``start`` / ``stop``, contiguous from 0). Adjacent
        same-codec leaves merge into one segment; sparse k specs resolve
        to absolute counts per merged segment."""
        runs: list[list] = []
        for leaf in leaves:
            codec = self.codec_for(leaf.name)
            if runs and runs[-1][2] == codec and runs[-1][1] == leaf.start:
                runs[-1][1] = leaf.stop
            else:
                runs.append([leaf.start, leaf.stop, codec])
        segs = tuple(
            LeafSegment(a, b, c, c.resolve_k(b - a)) for a, b, c in runs)
        return LeafmapCodec(self.rules, self.default, segs)

    def _require_compiled(self):
        if not self.segments:
            raise ValueError(
                "LeafmapCodec must be compiled against a model's leaf "
                "layout (adapter.leaf_offsets()) before wire accounting "
                "or payload encoding — engines do this automatically")

    def resolve_k(self, num_params: int) -> int:
        """Per-segment k is resolved at compile time; the engines'
        uniform-codec k slot is unused (0)."""
        return 0

    def wire_bits(self, num_params: int = 0) -> int:
        """Exact bits on the wire for one model transfer: the sum of each
        segment's own codec accounting (``num_params`` is ignored — the
        compiled segment table fixes the payload)."""
        self._require_compiled()
        return sum(s.codec.wire_bits(s.size) for s in self.segments)

    def wire_ratio(self, num_params: int = 0) -> float:
        """Uncompressed / compressed wire bits from the segment table
        (the Eq. 10 comm divisor; ``num_params`` ignored)."""
        self._require_compiled()
        total = self.segments[-1].stop
        return FP32_BITS * total / self.wire_bits()


def parse_leafmap(body: str) -> LeafmapCodec:
    """Parse the body of ``"leafmap:<pat>=<codec>,...,default=<codec>"``:
    each comma-separated item maps a leaf-name substring to a uniform
    codec string (``none`` / ``int8`` / ``topk:<k>`` / ``randk:<k>``);
    the reserved pattern ``default`` sets the codec of unmatched leaves
    (``none`` if absent)."""
    rules: list[tuple[str, Codec]] = []
    default = Codec("none")
    for item in body.split(","):
        if not item.strip():
            continue
        pat, sep, codec_str = item.partition("=")
        if not sep:
            raise ValueError(
                f"leafmap item {item!r} is not <pattern>=<codec>")
        codec = parse_mode(codec_str.strip())
        if not isinstance(codec, Codec):
            raise ValueError("leafmap entries must be uniform codecs, "
                             f"got {codec_str!r}")
        if pat.strip().lower() == "default":
            default = codec
        else:
            rules.append((pat.strip().lower(), codec))
    return LeafmapCodec(tuple(rules), default)


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


def edge_mix_delta(v: torch.Tensor, edges) -> torch.Tensor:
    """The sparse mixing delta ``W v - v`` = sum_{j != i} W_ij (v_j - v_i)
    from the directed edges alone, O(E P): ``edges`` is the CSR form
    (row_ptr, col, w) of ``topology.edges_to_csr``; each row sums its
    edges' deltas from zero in list order, deterministic on every device
    (the reference's ``segment_sum``)."""
    return robust.segment_mix_delta(v, v, edges)


def compressed_payload(flat, err, *, error_feedback: bool = True,
                       kind: str = "int8", k: int = 0, scores=None):
    """The first half of the compensated update, row-local: (x [W, P],
    state) -> (payload, state'), what each worker ships and carries —
    int8 / rand-k / naive top-k the round trip ŷ (``compress_decompress``),
    top-k with error feedback its tracked public copy x̂' = x̂ +
    topk(x - x̂), which is also its new state."""
    if kind == "topk" and error_feedback:
        xhat = err + sparsify_rows(flat - err, "topk", k)
        return xhat, xhat
    return compress_decompress(flat, err, error_feedback=error_feedback,
                               kind=kind, k=k, scores=scores)


def compressed_update(flat, delta, *, kind: str = "int8",
                      error_feedback: bool = True, gamma: float = 1.0):
    """The second half: x' = x + delta, the payload's mixing delta
    ``W v - v``, damped by ``gamma`` for top-k with error feedback."""
    if kind == "topk" and error_feedback:
        return flat + gamma * delta
    return flat + delta


def compressed_gossip_ref(flat, err, mix, *, error_feedback: bool = True,
                          kind: str = "int8", k: int = 0, scores=None,
                          gamma: float = 1.0, edges=None, mix_delta_fn=None):
    """One compressed gossip round on the flat [W, P] params with the
    dense [W, W] ``mix``, for any codec -> (x', state'):

        int8 / rand-k / naive top-k:  x' = x + (W ŷ - ŷ)
        top-k with error feedback:    q = topk(x - x̂), x̂' = x̂ + q,
                                      x' = x + gamma (W x̂' - x̂')

    Both forms preserve the fleet average for a doubly stochastic W and
    are exact no-ops through an identity mix. ``err`` is the state buffer
    (``state_init``; None for the stateless codecs), ``scores`` the
    round's rand-k mask draw on the device. ``edges`` (a CSR edge list;
    pass ``mix=None``) takes the mixing delta from the edges
    (``edge_mix_delta``); ``mix_delta_fn`` replaces it outright (the
    fused engine's ``gossip_edges(v) - v``). The payload and the update
    are ``compressed_payload`` and ``compressed_update``, which the
    sharded path runs with every shard's payload before any routed
    delta."""
    def mix_delta(v):
        if mix_delta_fn is not None:
            return mix_delta_fn(v)
        if edges is not None:
            return edge_mix_delta(v, edges)
        return torch.matmul(mix, v) - v

    payload, new_err = compressed_payload(flat, err,
                                          error_feedback=error_feedback,
                                          kind=kind, k=k, scores=scores)
    return compressed_update(flat, mix_delta(payload), kind=kind,
                             error_feedback=error_feedback,
                             gamma=gamma), new_err


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
    codec call on the stacked pair. The rows may carry a leading lane
    axis ([S, P]: S lanes share the event), folded into the codec's rows
    as [2·S, P]."""
    def pair(a, b):
        return torch.stack([a, b]).reshape(-1, a.shape[-1])

    if kind == "topk" and error_feedback:
        q = sparsify_rows(pair(xi - ei, xj - ej), "topk", k).view(
            2, *xi.shape)
        xhat_i, xhat_j = ei + q[0], ej + q[1]
        half = 0.5 * gamma * (xhat_j - xhat_i)
        return xi + half, xj - half, xhat_i, xhat_j
    ef = carries_state(kind, error_feedback)
    z = pair(xi + ei, xj + ej) if ef else pair(xi, xj)
    yhat = encode_rows(z, kind, k, scores=scores).view(2, *xi.shape)
    z = z.view(2, *xi.shape)
    half = 0.5 * (yhat[1] - yhat[0])
    if ef:
        ei, ej = z[0] - yhat[0], z[1] - yhat[1]
    return xi + half, xj - half, ei, ej


# ---------------------------------------------------------------------------
# per-leaf codec maps: state, rand-k draws and the compensated update
# ---------------------------------------------------------------------------

def leafmap_carries_state(lcodec: LeafmapCodec, error_feedback: bool) -> bool:
    """Whether any segment evolves the [W, P] codec-state buffer (the
    buffer is fleet-shaped either way; each segment reads its own
    columns as an int8 residual, a top-k public copy x̂, or dead
    zeros)."""
    return any(carries_state(s.codec.kind, error_feedback)
               for s in lcodec.segments)


def leafmap_state_init(flat: torch.Tensor, lcodec: LeafmapCodec,
                       error_feedback: bool) -> torch.Tensor:
    """Per-segment ``state_init`` on [..., W, P]: x̂ segments start at the
    (globally known) initial params, every other column at zero."""
    lcodec._require_compiled()
    err = torch.zeros_like(flat)
    for s in lcodec.segments:
        if s.codec.kind == "topk" and error_feedback:
            err[..., s.start:s.stop] = flat[..., s.start:s.stop]
    return err


def leafmap_state_after_join(err: torch.Tensor, keep_col: torch.Tensor,
                             flat: torch.Tensor, lcodec: LeafmapCodec,
                             error_feedback: bool) -> torch.Tensor:
    """Per-segment ``state_after_join``: joined rows re-anchor x̂
    segments at the blended row and zero the other columns."""
    out = torch.empty_like(err)
    for s in lcodec.segments:
        out[..., s.start:s.stop] = state_after_join(
            err[..., s.start:s.stop], keep_col, flat[..., s.start:s.stop],
            s.codec.kind, error_feedback)
    return out


def codec_state_init(flat: torch.Tensor, codec,
                     error_feedback: bool) -> torch.Tensor | None:
    """The engines' codec-state buffer at round 0 (None where the run
    carries none): ``state_init`` for a uniform codec, a leafmap's
    [..., W, P] segment buffer (``leafmap_state_init``)."""
    if codec.kind == "leafmap":
        return leafmap_state_init(flat, codec, error_feedback)
    return state_init(flat, codec.kind, error_feedback)


def codec_state_after_join(err, keep_col, flat, codec,
                           error_feedback: bool) -> torch.Tensor:
    """Joined rows' codec state after the donor-average re-init:
    ``state_after_join``, per segment for a leafmap."""
    if codec.kind == "leafmap":
        return leafmap_state_after_join(err, keep_col, flat, codec,
                                        error_feedback)
    return state_after_join(err, keep_col, flat, codec.kind, error_feedback)


def leafmap_gamma_mask(lcodec: LeafmapCodec,
                       error_feedback: bool) -> np.ndarray:
    """[P] f32 mask, 1.0 on the coordinates whose segment mixes through
    the damped x̂-tracked top-k step (where ``sparse_gamma`` applies),
    0.0 elsewhere. Static per compiled map."""
    lcodec._require_compiled()
    mask = np.zeros(lcodec.segments[-1].stop, np.float32)
    for s in lcodec.segments:
        if s.codec.kind == "topk" and error_feedback:
            mask[s.start:s.stop] = 1.0
    return mask


def leafmap_scores(lcodec: LeafmapCodec, key: tuple[int, int],
                   step: int) -> np.ndarray | None:
    """The rand-k mask draws of one exchange as a [P] f32 row: each
    rand-k segment's ``randk_scores`` under its own key, the run's key
    folded on the segment's start (segments draw independent masks, as
    the reference's ``fold_in(key, start)`` does), in the segment's
    columns; zeros elsewhere. None when no segment is rand-k."""
    lcodec._require_compiled()
    segs = [s for s in lcodec.segments if s.codec.kind == "randk"]
    if not segs:
        return None
    out = np.zeros(lcodec.segments[-1].stop, np.float32)
    for s in segs:
        out[s.start:s.stop] = randk_scores(_fold_in(key, s.start), step,
                                           s.size)
    return out


def leafmap_payload(flat: torch.Tensor, err: torch.Tensor,
                    lcodec: LeafmapCodec, *, error_feedback: bool = True,
                    scores: torch.Tensor | None = None):
    """Per-segment wire round trip on [W, P] -> (payload, new_state).

    Each segment applies its own codec as the uniform paths do: ``none``
    ships raw values; int8 the error-compensated round trip ŷ = C(x + e);
    top-k with error feedback advances the tracked public copy x̂ by the
    top-k innovation (the payload is x̂'; its mixing delta is damped by
    ``sparse_gamma``); rand-k the segment's columns of ``scores``
    (``leafmap_scores``, on the device). A segment's columns are a
    strided view of the row; each codec call takes them as a contiguous
    copy (the kernels need one), and its result is written back into one
    [W, P] payload and one state tensor."""
    lcodec._require_compiled()
    payload = torch.empty_like(flat)
    state = err.clone()
    for s in lcodec.segments:
        a, b, c = s.start, s.stop, s.codec
        x, e = flat[:, a:b], err[:, a:b]
        if c.kind == "none":
            payload[:, a:b] = x
        elif c.kind == "topk" and error_feedback:
            xhat = e + sparsify_rows(x - e, "topk", s.k_abs)
            payload[:, a:b] = xhat
            state[:, a:b] = xhat
        elif c.kind == "randk":
            payload[:, a:b] = sparsify_rows(x.contiguous(), "randk",
                                            s.k_abs, scores=scores[a:b])
        else:                       # int8 (EF or naive), naive top-k
            ef = carries_state(c.kind, error_feedback) and c.kind != "topk"
            z = x + e if ef else x.contiguous()
            yhat = encode_rows(z, c.kind, s.k_abs)
            payload[:, a:b] = yhat
            if ef:
                state[:, a:b] = z - yhat
    return payload, state


def leafmap_gossip_ref(flat, err, mix, lcodec: LeafmapCodec, *,
                       error_feedback: bool = True, scores=None,
                       gamma: float = 1.0, edges=None, mix_delta_fn=None):
    """One leafmap-compressed gossip round on the flat [W, P] params ->
    (x', state'): the combined per-segment payload v through ONE mixing
    delta (mixing is column-independent, so this is per-segment mixing),

        x' = x + g ⊙ (W v - v),

    g the per-coordinate step — ``gamma`` on x̂-tracked top-k segments, 1
    elsewhere. ``edges`` (a CSR edge list; pass ``mix=None``) or
    ``mix_delta_fn`` take the delta as in ``compressed_gossip_ref``."""
    payload, new_err = leafmap_payload(flat, err, lcodec,
                                       error_feedback=error_feedback,
                                       scores=scores)
    if mix_delta_fn is not None:
        delta = mix_delta_fn(payload)
    elif edges is not None:
        delta = edge_mix_delta(payload, edges)
    else:
        delta = torch.matmul(mix, payload) - payload
    if error_feedback:
        for s in lcodec.segments:
            if s.codec.kind == "topk":
                delta[:, s.start:s.stop] *= gamma
    return flat + delta, new_err
