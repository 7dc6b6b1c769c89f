"""Tiling helpers (twin of ``repro.core.ops.tiles``): the (bm, bn, bk)
block shape, pad-to-tile helpers, the MoE group aligner, per-impl
default tiles and the shape-keyed tile cache.
The ``cuda`` gemm impl reads a ``TileConfig`` for its quantized rungs
only: ``tile_for("cuda", m, n, k)`` is the quantization grid of
``gemm_lowp`` (each (bm, bk) tile of A and (bk, bn) tile of B gets its
own scale), the grid ``repro``'s router gives its ``pallas`` impl.  The
grouped family reads ``bm`` as the group alignment of the sorted token
buffer (``core.ops.grouped.grouped_tiles``).  The other CUDA GEMM
kernels pick their own tiles from the problem's M and read unpadded
views.  Autotune and JSON persistence wait for their slice."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["TileConfig", "round_up", "pad2", "align_group_counts", "tile_for",
           "set_tiles", "set_default_tiles"]


def round_up(x, mult: int):
    """Round ``x`` up to a multiple of ``mult`` (ints or tensors)."""
    return -(-x // mult) * mult


def pad2(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """Zero-pad the last two dims of ``x`` up to multiples of (r, c)."""
    pr, pc = (-x.shape[-2]) % r, (-x.shape[-1]) % c
    if pr or pc:
        x = F.pad(x, (0, pc, 0, pr))
    return x


def align_group_counts(counts, bm: int):
    """Per-group row counts -> row-tile-aligned region sizes: each group
    padded up to a multiple of ``bm``, and at least one tile (so an
    empty group still owns a defined weight-gradient block).  Tensors or
    numpy arrays."""
    up = round_up(counts, bm)
    if isinstance(up, torch.Tensor):
        return torch.clamp(up, min=bm)
    return np.maximum(up, bm)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """(bm, bn, bk) block shape for one 2-D kernel problem."""

    bm: int = 256
    bn: int = 256
    bk: int = 256

    def clamp(self, m: int, n: int, k: int, *, row_quantum: int = 8) -> TileConfig:
        """Shrink blocks to no larger than the rounded-up problem (rows
        rounded to ``row_quantum``)."""
        return TileConfig(
            bm=min(self.bm, round_up(m, row_quantum)),
            bn=min(self.bn, round_up(n, 128)),
            bk=min(self.bk, round_up(k, 128)),
        )


# Per-impl defaults, (tiles, row quantum), seeded by the impls that read
# tiles; exact-shape overrides: (impl, m, n, k) -> TileConfig.
_TILE_DEFAULTS: dict[str, tuple[TileConfig, int]] = {}
_TILE_CACHE: dict[tuple[str, int, int, int], TileConfig] = {}


def set_default_tiles(impl: str, tiles: TileConfig, *, row_quantum: int = 8) -> None:
    """Seed the impl's default block shape; ``row_quantum`` is the
    smallest row tile it serves (the clamp rounds ``bm`` to it)."""
    _TILE_DEFAULTS[impl] = (tiles, row_quantum)


def tile_for(impl: str, m: int, n: int, k: int) -> TileConfig:
    """Exact-shape override if set, else the impl's default clamped."""
    hit = _TILE_CACHE.get((impl, m, n, k))
    if hit is not None:
        return hit
    base, quantum = _TILE_DEFAULTS.get(impl, (TileConfig(), 8))
    return base.clamp(m, n, k, row_quantum=quantum)


def set_tiles(impl: str, m: int, n: int, k: int, tiles: TileConfig) -> None:
    """Pin the tile config for one exact problem shape."""
    _TILE_CACHE[(impl, m, n, k)] = tiles

