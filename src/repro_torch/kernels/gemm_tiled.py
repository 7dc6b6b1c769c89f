"""Tiled bf16 GEMM on the Hopper tensor cores (``csrc/gemm_tiled.cu``).

Replaces the TPU kernel ``repro/kernels/gemm_tiled.py:_gemm_kernel``
(``pallas_call`` at ``gemm_tiled.py:91``): C = A.B with both operands
rounded to bf16 and an f32 accumulator, the paper's "WMMA + shared
memory" surface (its Fig. 6 CUTLASS column).

What bounds it on the H100.  Prefill and training shapes (M > 16) are
bounded by operations once their operands are staged well: 4096^3 is 139
us of bf16 tensor-core work against 20 us of bytes; the prefill MLP (700 x
1152 x 6912 against f32 weights) moves 16 us of bytes against 11 us of
work.  Decode (M <= 16 rows against a 6912 x 1152 weight or the 1152 x
262144 table) is a weight stream, bounded by bytes alone, and only as
fast as the bytes the grid keeps in flight.

The design, by shape:
  M > 16   the Hopper mainloop (``csrc/gemm_sm90.cuh``): a producer
           warpgroup fills a 4-stage ring of 128-byte swizzled tiles (TMA
           for bf16 operands that are contiguous along K or M/N and 16-byte
           aligned; 16-byte loads rounded to bf16 on the way in for f32
           operands and odd strides), one or two consumer warpgroups run
           ``wgmma`` m64n128k16 on it, BM 64 up to 64 rows, else 128; each
           adds its accumulator into an f32 total every 256 of K (the
           tensor cores' own accumulation loses precision with K).
  M <= 16  the split-K weight stream (``csrc/gemm_splitk.cuh``): a grid of
           64-column N tiles by K splits (``splitk_splits``: enough splits
           of >= 4 64-row K tiles for twice the SM count, one when the N
           tiles fill the card), each CTA streaming its weight slice
           through a 3-stage ring of 16-byte ``cp.async`` copies (three
           CTAs an SM) into ``mma.sync`` m16n8k16 with the operands
           swapped (16 weight columns as the MMA's rows, the <= 16
           activation rows as its n); the CTA that draws a tile's last
           ticket sums the splits' f32 partials in split order in the same
           launch (deterministic, no atomics on C).
Both read f32 or bf16 operands where they lie, through their strides (the
JAX wrapper's ``astype(bfloat16)`` would write a 0.6 GB bf16 copy of the
unembed table per call in eager PyTorch), and mask the ragged edges in
the kernel (no padded copy).  ``LAUNCHES_BY_LOOP`` counts which mainloop
each launch ran (``wmma``: the WMMA tile of ``csrc/gemm_common.cuh``, which
``gemm_tiled`` and ``gemm_refined`` no longer run; the quantized and
grouped rungs do).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _trace

__all__ = ["gemm_tiled", "gemm_tiled_plain", "gemm_tiled_splitk_plain", "splitk_splits",
           "sm90_splits", "split_ranges", "whole_splits", "split_workspace", "sm90_workspace",
           "sm_count", "LAUNCHES", "LAUNCHES_BY_LOOP", "MAINLOOPS"]

LAUNCHES = 0
MAINLOOPS = ("wmma", "sm90", "splitk")      # the C launchers' mainloop ids
LAUNCHES_BY_LOOP = dict.fromkeys(MAINLOOPS, 0)

# The split-K loop's tiles (``csrc/gemm_splitk.cuh``): 64 weight columns by
# 64 K rows, at least SPLITK_MIN_TILES K tiles a split; a CTA's f32 partial
# is SPLITK_PART floats.
SPLITK_BN = SPLITK_BK = 64
SPLITK_MIN_TILES = 4
SPLITK_PART = 1024
# The split workspace (shared by the split-K GEMM and the split decode,
# which run one at a time on a stream): slots of the decode's largest
# partial (16 rows x (256 + 2) floats) and tickets, per SM.
WS_SLOTS_PER_SM = 4
WS_SLOT_FLOATS = 16 * (256 + 2)
TICKETS_PER_SM = 4
# The refined wgmma mainloop's tiles (``csrc/gemm_refined_sm90.cuh``): 128
# x 128 outputs a CTA, K in 64-deep stages, at least SM90_MIN_TILES of them a
# split; its split workspace holds SM90_SLOTS_PER_SM partials of SM90_PART
# floats an SM (104 MB at 132 SMs) and as many tickets.
SM90_BM = SM90_BN = 128
SM90_BK = 64
SM90_MIN_TILES = 8
SM90_PART = SM90_BM * SM90_BN
SM90_SLOTS_PER_SM = 12

_c = ctypes
GEMM_ARGTYPES = [
    _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_longlong, _c.c_longlong,   # a
    _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_longlong, _c.c_longlong,   # b
    _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,                  # c, batch, m, n, k
]
# splits, then ws, ws_floats, tickets, n_tickets (``split_workspace``)
SPLIT_ARGTYPES = [_c.c_int, _c.c_void_p, _c.c_longlong, _c.c_void_p, _c.c_int]


@_trace.plain_twin
def gemm_tiled_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: bf16-rounded operands, upcast,
    multiplied and summed in f32 (products of bf16 values are exact)."""
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def split_ranges(total: int, splits: int) -> list[tuple[int, int]]:
    """The tile ranges [lo, hi) of ``splits`` splits over ``total`` tiles,
    as the split kernels take them: per = ceil(total / splits), split s
    from s * per (clipped to ``total``; a range may be empty)."""
    per = -(-total // splits)
    return [(min(total, s * per), min(total, (s + 1) * per)) for s in range(splits)]


def whole_splits(total: int, want: int, most: int, min_per: int = 1) -> int:
    """A split count for ``total`` tiles whose ``split_ranges`` are all
    non-empty and, but for the last, at least ``min_per`` tiles: the
    smallest such count from ``want`` up to ``most``, else the largest
    below ``want`` (1 at worst)."""
    def whole(s):
        per = -(-total // s)
        return per >= min_per and (s - 1) * per < total
    up = [s for s in range(max(want, 2), most + 1) if whole(s)]
    if up:
        return up[0]
    return next((s for s in range(min(want, most + 1) - 1, 1, -1) if whole(s)), 1)


@functools.lru_cache(maxsize=4096)
def splitk_splits(batch: int, m: int, n: int, k: int, sms: int) -> int:
    """K splits of a ``gemm_tiled`` launch: 1 above M = 16 (the wgmma
    mainloop) and when the batch's N tiles alone give twice ``sms`` CTAs;
    else the fewest splits of whole K tiles, at least SPLITK_MIN_TILES
    each, that reach twice ``sms`` CTAs (fewer where K is too short), none
    empty, within the workspace's slots."""
    tiles = batch * -(-n // SPLITK_BN)
    k_tiles = -(-k // SPLITK_BK)
    want = -(-2 * sms // max(tiles, 1))
    if m > 16 or want <= 1 or tiles > TICKETS_PER_SM * sms:
        return 1
    most = min(k_tiles // SPLITK_MIN_TILES,
               WS_SLOTS_PER_SM * sms * WS_SLOT_FLOATS // (tiles * SPLITK_PART))
    return whole_splits(k_tiles, want, most, SPLITK_MIN_TILES)


@functools.lru_cache(maxsize=4096)
def sm90_splits(batch: int, m: int, n: int, k: int, sms: int) -> int:
    """K splits of a refined launch above M = 16 (the wgmma mainloop; 1 at
    M <= 16): of the counts whose splits are whole K tiles, at least
    SM90_MIN_TILES each and none empty, within the workspace's slots, the
    smallest that gives the busiest SM the least work, ceil(tiles * splits
    / sms) waves of ceil(k_tiles / splits) stages.  1 where the output tiles
    come within a wave of filling the card; whole waves where a last partial
    wave would idle most SMs (train dX, 144 tiles on 132 SMs: 11)."""
    tiles = batch * -(-m // SM90_BM) * -(-n // SM90_BN)
    k_tiles = -(-k // SM90_BK)
    if m <= 16 or tiles == 0:
        return 1
    most = min(k_tiles // SM90_MIN_TILES, SM90_SLOTS_PER_SM * sms // tiles)
    best, cost = 1, -(-tiles // sms) * k_tiles
    for s in range(2, most + 1):
        per = -(-k_tiles // s)
        c = -(-tiles * s // sms) * per
        if (s - 1) * per < k_tiles and c < cost:
            best, cost = s, c
    return best


def gemm_tiled_splitk_plain(a: torch.Tensor, b: torch.Tensor, splits: int) -> torch.Tensor:
    """The split-K loop's sum in plain PyTorch: each split's product of
    bf16-rounded operands over its K tiles (``split_ranges``) in f32, the
    partials added in split order (the last CTA's reduction)."""
    a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    out = None
    for lo, hi in split_ranges(-(-a.shape[-1] // SPLITK_BK), splits):
        part = torch.matmul(a[..., lo * SPLITK_BK:hi * SPLITK_BK].float(),
                            b[..., lo * SPLITK_BK:hi * SPLITK_BK, :].float())
        out = part if out is None else out + part
    return out


SMEM_LIMIT = 232448              # bytes of shared memory a block may use on the H100


@functools.cache
def card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The share of the card a launch plans its splits for.  A rank running its
# block of a sharded problem (``core.ops.shard``) plans as the whole
# problem would on one device: the split choosers see the card's SMs over
# the share of the grid the cut took away, so the block sums K (or walks
# the KV cache) in the same splits as one device.
SM_SHARE = 1


def sm_count(index: int) -> int:
    """The SMs a launch plans its splits for (see ``SM_SHARE``)."""
    return max(1, card_sms(index) // SM_SHARE)


_WORKSPACES: dict[tuple[str, int, int], tuple] = {}


def _workspace(kind: str, index: int, stream: int, floats: int, n_tickets: int):
    ws = _WORKSPACES.get((kind, index, stream))
    if ws is None:
        dev = torch.device("cuda", index)
        parts = torch.empty(floats, dtype=torch.float32, device=dev)
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
        ws = (parts.data_ptr(), parts.numel(), tickets.data_ptr(), tickets.numel(),
              parts, tickets)
        _WORKSPACES[(kind, index, stream)] = ws
    return ws[:4]


def split_workspace(index: int, stream: int) -> tuple[int, int, int, int]:
    """The split kernels' f32 partials and int32 tickets (zero between
    launches: the last CTA of a tile resets its ticket) on device ``index``
    for the stream ``stream``, allocated once per device and stream: the
    launchers' (ws, ws_floats, tickets, n_tickets)."""
    sms = card_sms(index)
    return _workspace("split", index, stream, WS_SLOTS_PER_SM * sms * WS_SLOT_FLOATS,
                      TICKETS_PER_SM * sms)


def sm90_workspace(index: int, stream: int) -> tuple[int, int, int, int]:
    """The refined wgmma mainloop's split workspace (``sm90_splits`` > 1),
    as ``split_workspace``: SM90_SLOTS_PER_SM partials of 128 x 128 floats
    and as many tickets an SM."""
    sms = card_sms(index)
    return _workspace("sm90", index, stream, SM90_SLOTS_PER_SM * sms * SM90_PART,
                      SM90_SLOTS_PER_SM * sms)


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"gemm expects (m,k)x(k,n) or (g,m,k)x(g,k,n); "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"gemm shape mismatch {tuple(a.shape)} x {tuple(b.shape)}")


def on_cpu(*xs: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain versions' case);
    False when all lie on one CUDA device; raises on anything else."""
    devs = {x.device for x in xs}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel operands must share one CUDA device; got {devs}")
    return False


def gemm_dims(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int]:
    """(batch, m, n, k) of checked operands (batch 1 for 2-D ones)."""
    return (a.shape[0] if a.dim() == 3 else 1), a.shape[-2], b.shape[-1], a.shape[-1]


def gemm_outputs(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The f32 C of a (batched) GEMM launch, as a trace site's outputs."""
    return ((tuple(a.shape[:-1]) + (b.shape[-1],), torch.float32),)


def split_site_fields(total: int, splits: int) -> dict:
    """A split launch's ``KernelSite`` fields: the ranges of
    ``split_ranges`` over ``total`` tiles and f32 partials (none at 1)."""
    if splits <= 1:
        return {}
    return {"split_total": total, "splits": tuple(split_ranges(total, splits)),
            "workspace_dtype": torch.float32}


def _site(a: torch.Tensor, b: torch.Tensor) -> _trace.KernelSite:
    batch, m, n, k = gemm_dims(a, b)
    splits = splitk_splits(batch, m, n, k, _trace.AUDIT_SMS)
    return _trace.KernelSite(
        kernel="gemm_tiled", entry="gemm_tiled_launch", mainloop="sm90" if m > 16 else "splitk",
        policy="bf16", terms=1, contractions=1, outputs=gemm_outputs(a, b),
        **split_site_fields(-(-k // SPLITK_BK), splits))


def launch_gemm(fn, a: torch.Tensor, b: torch.Tensor, *extra,
                stream: int | None = None) -> torch.Tensor:
    """Launch a strided (batched) GEMM launcher of the gemm_common.cuh
    family; ``extra`` C ints go between ``k`` and the stream (``stream``:
    the current one unless given)."""
    squeeze = a.dim() == 2
    a3 = a.unsqueeze(0) if squeeze else a
    b3 = b.unsqueeze(0) if squeeze else b
    a3 = a3 if a3.dtype in (torch.float32, torch.bfloat16) else a3.float()
    b3 = b3 if b3.dtype in (torch.float32, torch.bfloat16) else b3.float()
    batch, m, k = a3.shape
    n = b3.shape[2]
    c = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    if c.numel():
        sab, sam, sak = a3.stride()
        sbb, sbk, sbn = b3.stride()
        if squeeze:
            sab = sbb = 0
        dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
        rc = fn(a3.data_ptr(), int(a3.dtype == torch.bfloat16), sab, sam, sak,
                b3.data_ptr(), int(b3.dtype == torch.bfloat16), sbb, sbk, sbn,
                c.data_ptr(), batch, m, n, k, *extra,
                torch.cuda.current_stream(a.device).cuda_stream if stream is None else stream,
                dev)
        _build.check(rc, fn.__name__)
    return c[0] if squeeze else c


@functools.cache
def _launcher():
    fn = _build.load("gemm_tiled").gemm_tiled_launch
    fn.argtypes = [*GEMM_ARGTYPES, *SPLIT_ARGTYPES, _c.POINTER(_c.c_int), _c.c_void_p, _c.c_int]
    fn.restype = _c.c_int
    return fn


def gemm_tiled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with bf16 tensor-core passes and an f32 accumulator.

    a: (m, k) or (g, m, k); b: (k, n) or (g, k, n); f32 or bf16, any
    strides.  Returns f32.  CPU tensors run ``gemm_tiled_plain``; CUDA
    tensors launch the kernel or raise.
    """
    global LAUNCHES
    check_operands(a, b)
    if _trace.ACTIVE:
        return _trace.launch(_site(a, b), a, b)
    if on_cpu(a, b):
        return gemm_tiled_plain(a, b)
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    splits = splitk_splits(a.shape[0] if a.dim() == 3 else 1, a.shape[-2], b.shape[-1],
                           a.shape[-1], sm_count(index))
    loop = _c.c_int(-1)
    out = launch_gemm(_launcher(), a, b, splits, *split_workspace(index, stream),
                      _c.byref(loop), stream=stream)
    LAUNCHES += 1
    if loop.value >= 0:
        LAUNCHES_BY_LOOP[MAINLOOPS[loop.value]] += 1
    return out
