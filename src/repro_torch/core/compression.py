"""Wire-codec descriptions and Eq. 10 wire accounting — the jax-free half
of ``repro.core.compression``, copied so the port's planner and engines
price a link exactly like the reference.

``cfg.compress`` selects the codec (``parse_mode`` -> ``Codec``):
``"none"`` sends raw f32 parameters, ``"int8"`` per-(8, 1024)-tile
scaled int8, ``"topk:<k>"`` value+index pairs and ``"randk:<k>"`` values
plus a shared mask seed (k a fraction of P when < 1, an absolute count
otherwise). The port's engines gossip uncompressed only: the device side
of the codecs (and the per-leaf ``"leafmap:..."`` maps) arrives with the
wire-codec slice (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

from dataclasses import dataclass

COMPRESS_MODES = ("none", "int8", "topk:<k>", "randk:<k>",
                  "leafmap:<pat>=<codec>,...")
SPARSE_KINDS = ("topk", "randk")
UNIFORM_KINDS = ("none", "int8", "topk", "randk")

FP32_BITS = 32
INT8_BITS = 8
SCALE_BITS = 32
INDEX_BITS = 32     # top-k ships one explicit coordinate index per value
SEED_BITS = 32      # rand-k ships only the shared mask seed

# the int8 codec's wire tile (kernels/quantize_block.py in the reference)
BLOCK_ROWS = 8
BLOCK_COLS = 1024


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
            "yet: ROADMAP.md queue 1, item 5 (wire codecs)")
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
