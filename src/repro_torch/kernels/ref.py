"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against, and what ``ops`` runs on tensors
the caller placed on the CPU.

The wire codecs' kernels work on the flat ``[W, P]`` rows in the int8
codec's tile layout (``wire_tiles``): a worker's row is read as a
``[rows, cols]`` matrix with cols = min(1024, P), cut into tiles of
br = min(8, rows) whole rows, so tile t is the contiguous span
[t·br·cols, (t+1)·br·cols) of the row, clipped at P.
"""
from __future__ import annotations

import torch

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


def gossip_mix_ref(x: torch.Tensor, u: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x: [B, L]; u: [K, L]; w: [B, K] -> y[b] = x[b] + sum_k w[b, k]
    (u[k] - x[b]), f32, accumulated for k ascending with one rounding per
    subtract, multiply and add — the kernel's exact arithmetic order, so
    the two agree bit for bit (an identity row of ``w`` is an exact
    no-op)."""
    acc = x
    for k in range(u.shape[0]):
        acc = acc + w[:, k:k + 1] * (u[k] - x)
    return acc


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
