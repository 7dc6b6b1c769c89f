"""Tiling helpers (twin of ``repro.core.ops.tiles``): the (bm, bn, bk)
block shape, pad-to-tile helpers, the MoE group aligner, per-impl
default tiles, the shape-keyed tile cache, its JSON file and the
autotuner that fills it.
The ``cuda`` gemm impl reads a ``TileConfig`` for its quantized rungs
only: ``tile_for("cuda", m, n, k)`` is the quantization grid of
``gemm_lowp`` (each (bm, bk) tile of A and (bk, bn) tile of B gets its
own scale), the grid ``repro``'s router gives its ``pallas`` impl.  The
grouped family reads ``bm`` as the group alignment of the sorted token
buffer (``core.ops.grouped.grouped_tiles``).  The other CUDA GEMM
kernels pick their own tiles from the problem's M and read unpadded
views, so a tuned or pinned tile moves nothing else.

The cache file is ``repro``'s: JSON ``"impl/m/n/k" -> [bm, bn, bk]`` at
the path the ``REPRO_TILE_CACHE`` variable names (the launchers'
``--tile-cache`` sets it), so a file written by either package loads in
the other."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import time
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["TileConfig", "round_up", "pad2", "align_group_counts", "tile_for",
           "set_tiles", "set_default_tiles", "pinned_tiles", "clear_tile_cache",
           "tile_cache_path", "save_tile_cache", "load_tile_cache", "use_tile_cache",
           "autotune_tiles"]


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
# a call's own tiles (``gemm(..., tiles=)``), ahead of the cache
_PINNED: contextvars.ContextVar[TileConfig | None] = contextvars.ContextVar(
    "pinned_tiles", default=None)


def set_default_tiles(impl: str, tiles: TileConfig, *, row_quantum: int = 8) -> None:
    """Seed the impl's default block shape; ``row_quantum`` is the
    smallest row tile it serves (the clamp rounds ``bm`` to it)."""
    _TILE_DEFAULTS[impl] = (tiles, row_quantum)


def tile_for(impl: str, m: int, n: int, k: int) -> TileConfig:
    """The tiles pinned around this call if any, else the exact-shape
    override if set, else the impl's default clamped."""
    pinned = _PINNED.get()
    if pinned is not None:
        return pinned.clamp(m, n, k)
    hit = _TILE_CACHE.get((impl, m, n, k))
    if hit is not None:
        return hit
    base, quantum = _TILE_DEFAULTS.get(impl, (TileConfig(), 8))
    return base.clamp(m, n, k, row_quantum=quantum)


def set_tiles(impl: str, m: int, n: int, k: int, tiles: TileConfig) -> None:
    """Pin the tile config for one exact problem shape."""
    _TILE_CACHE[(impl, m, n, k)] = tiles


@contextlib.contextmanager
def pinned_tiles(tiles: TileConfig | None):
    """Within the block, ``tile_for`` answers ``tiles`` (clamped to each
    problem) for every impl and shape: ``repro``'s ``Route.tiles``, which
    ``gemm(..., tiles=)`` sets for one call.  ``None`` pins nothing."""
    token = _PINNED.set(tiles)
    try:
        yield
    finally:
        _PINNED.reset(token)


def clear_tile_cache() -> None:
    _TILE_CACHE.clear()


_TILE_CACHE_ENV = "REPRO_TILE_CACHE"


def tile_cache_path(path: str | None = None) -> str | None:
    return path if path is not None else os.environ.get(_TILE_CACHE_ENV)


def _read_cache_file(path: str) -> dict | None:
    """The entries of a cache file, or None where it is absent, unreadable
    or holds anything but ``"impl/m/n/k": [bm, bn, bk]`` entries."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
        return {(impl, int(m), int(n), int(k)): TileConfig(int(bm), int(bn), int(bk))
                for (impl, m, n, k), (bm, bn, bk)
                in ((key.rsplit("/", 3), t) for key, t in payload.items())}
    except (OSError, ValueError, TypeError, AttributeError):
        return None


def save_tile_cache(path: str | None = None) -> str | None:
    """Write the shape-keyed cache to JSON; nothing without a path.

    Merged over the entries already on disk, this process's winning per
    shape (no file lock: two processes saving at once can lose one's
    update, which costs a re-tune, never a wrong tile); a file that does
    not load is rewritten whole.  Written to a temporary file renamed over
    the target, so a crash mid-save leaves the old file whole.
    """
    path = tile_cache_path(path)
    if not path:
        return None
    merged = {**(_read_cache_file(path) or {}), **_TILE_CACHE}
    payload = {f"{b}/{m}/{n}/{k}": [t.bm, t.bn, t.bk] for (b, m, n, k), t in merged.items()}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def use_tile_cache(path: str | None) -> int:
    """The launchers' ``--tile-cache``: a given ``path`` becomes
    ``REPRO_TILE_CACHE`` (the file is both loaded now and where autotune
    results are saved, so it overrides an inherited value; ranks a
    launcher starts inherit it), then the cache is loaded from it or from
    the inherited value.  Returns the entries loaded."""
    if path:
        os.environ[_TILE_CACHE_ENV] = path
    return load_tile_cache()


def load_tile_cache(path: str | None = None) -> int:
    """Merge a saved cache into this process's; returns the entries loaded
    (0 without a path or a file, and for a corrupt or unreadable file,
    which means a re-tune, not a failed start)."""
    path = tile_cache_path(path)
    entries = _read_cache_file(path) if path else None
    if not entries:
        return 0
    _TILE_CACHE.update(entries)
    return len(entries)


def autotune_tiles(impl: str, m: int, n: int, k: int, *, policy: str = "bf16",
                   candidates: Sequence[TileConfig] | None = None, reps: int = 2,
                   device: str | torch.device = "cuda", persist: bool = True,
                   timings: dict | None = None) -> TileConfig:
    """Time ``candidates`` through ``gemm``'s dispatch on ``impl`` and cache
    the winner for the shape (and, unless ``persist`` is off, save it to
    the cache file, when one is configured).

    The candidates default to ``repro``'s: (bm, bn, bk) over (128, 256)^3,
    clamped to the problem, duplicates dropped.  Each gets one warm-up
    call, then ``reps`` calls timed on the host clock, the device
    synchronised after each.  Operands are U[-1, 1] f32 from a seeded generator on
    ``device``.  In the port a tile moves only ``gemm_lowp``'s quantization
    grid (the fp8 / int8 rungs of the ``cuda`` impl) and the grouped
    family's ``bm``; the other GEMM kernels choose their own tiles, so for
    them the candidates time alike.  ``timings``, if given, receives each
    candidate's seconds a call.
    """
    from repro_torch.core.ops.gemm import gemm   # local: tiles stays a leaf module

    if candidates is None:
        candidates = list(dict.fromkeys(
            TileConfig(bm, bn, bk).clamp(m, n, k)
            for bm in (128, 256) for bn in (128, 256) for bk in (128, 256)))
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.rand((m, k), generator=gen, device=device) * 2 - 1
    b = torch.rand((k, n), generator=gen, device=device) * 2 - 1

    def run(cand):
        out = gemm(a, b, policy=policy, backend=impl, tiles=cand)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    best, best_t = None, float("inf")
    for cand in candidates:
        run(cand)                                   # warm-up (and the build)
        t0 = time.perf_counter()
        for _ in range(reps):
            run(cand)
        t = (time.perf_counter() - t0) / reps
        if timings is not None:
            timings[cand] = t
        if t < best_t:
            best, best_t = cand, t
    assert best is not None
    set_tiles(impl, m, n, k, best)
    if persist:
        save_tile_cache()
    return best
