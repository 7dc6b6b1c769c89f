"""Grouped (ragged) expert GEMMs of the MoE FFN on the Hopper tensor cores
(``csrc/gemm_grouped.cuh``, instantiated by ``gemm_grouped.cu``,
``gemm_grouped_ext.cu`` and ``gemm_grouped_dw.cu``), forward, dx and dW.

Replaces two TPU kernels of ``repro/kernels/gemm_grouped.py``:

  ``_gmm_kernel`` (:131, ``pallas_call`` at :184, via ``_gmm_call``)
      ``grouped_gemm``: out[r] = x[r] . w[g(r)] over a token buffer
      sorted by group, each group's run padded to the alignment ``bm``;
      with ``trans_w`` the same walk against w[g]^T (the backward's dx).
  ``_dw_kernel`` (``pallas_call`` at :246, via ``_dw_call``)
      ``grouped_gemm_dw``: dw[g] = x_g^T . dy_g over group g's run.

Both run every rung of the ladder.  The forward and dx by CTA row tile
(``cta_rows``):

  16 rows  (every decode call of the MoE FFN: at most 16 rows an expert)
           bf16 and the refined rungs run the split-K weight stream of
           ``gemm_tiled``'s decode (``csrc/gemm_splitk.cuh``) in its
           group-rows mode: grid (64-column N tiles, K splits, 16-row
           tiles of x), tile z against ``w + gid[z] * stride_E``.  A tile
           with no live row -- dead (past ``offsets[E]``) or only the
           alignment padding of its run, known from ``group_counts`` (each
           run's real rows, on the device) -- loads nothing and stores
           zeros, so only the experts that have rows are streamed.  The
           split count comes from the shapes alone (``grouped_splits``),
           the partials sum in split order on ``split_workspace``.
           bf16x6, f32 and the fp8 / int8 rungs keep the WMMA tile.
  64, 128  the bf16 rung runs the Hopper mainloop (``csrc/gemm_sm90.cuh``:
           TMA or a converting producer warpgroup feeding ``wgmma``; its
           grid walks the row tiles fastest, so the row tiles of one
           expert read each weight N-tile from HBM once and from L2
           after); every other rung ``gemm_common.cuh``'s WMMA tiled
           kernel: refine_a / bf16x3 / refine_ab from staged bf16 hi/lo
           tiles; the fp8 / int8 rungs quantized on their way into those
           tiles under each staged tile's pow2 scales (the CTA's rows x BK
           of x, BK x 128 of w), then multiplied in bf16's one pass or
           bf16x3's three; bf16x6 from f32 tiles with its terms made per
           fragment; f32 on the CUDA cores.

The bf16 dW runs the Hopper mainloop's group-K mode (``gemm_sm90.cuh``:
persistent CTAs over 128 x 128 tiles of dw, each walking its group's run as
K, x and dy by TMA as bf16, the rows past a run's end zeroed in shared
memory); its quantized rungs first run a quantize pass
(``grouped_dw_scales``: one block per 64 x 32 tile of x^T and 32 x 128
tile of dy takes the tile's pow2 scales and writes its bf16 hi / lo
terms), whose planes the WMMA kernel then stages as they are, so no tile
is quantized more than once and no block reduces.  The TPU scalar-prefetched
a per-tile group id; here each block of the forward loads its own from
``tile_group_ids`` (computed on the device with ``searchsorted`` at the
kernel's CTA row tile, no host sync): a dead tile (id E, past
``offsets[E]``) stores zeros and issues no tensor-core work, a live one
walks K against ``w + gid * stride_E``.  dx reads ``w[g]`` through swapped
strides (a K-major B); no transpose is written.  The dW grid is (E, D/64,
F/128): each block walks its own group's run as K, reading x through the
M-contiguous A layout, so no sum is carried between blocks and no atomics
are used (the same result on every run); an empty run stores zeros, where
the TPU left the block unwritten and masked it afterwards.

What bounds them on the H100: bytes.  Every expert owns at least one tile
(``align_group_counts``), so the 64/128-row forward streams all E expert
weight matrices: at Mixtral's 8 x 4096 x 14336 in f32, 1.88 GB, 0.56 ms at
3.35 TB/s, against 0.17 ms of bf16 tensor-core work at a 700-token
prefill.  A decode call needs only the experts that have rows (4 of 8 at 4
tokens x top-2: 0.94 GB, 0.28 ms); the 16-row WMMA tile streamed all 8 in
one 16 x 128 CTA per tile over the whole K (0.92 ms), the split-K stream
reads the live experts' weights only, 64 columns a CTA, three CTAs an SM.
dW writes the same 1.88 GB.  The design reads the f32 expert stack in place
and rounds (or splits) it on the way into shared memory or fragments, as
``gemm_tiled`` does: no bf16 copy of the stack is ever written.  So no
forward can pass the f32 weight stream's bound; bf16 expert weights come
later.

Layout contract: the alignment ``bm`` must be a multiple of 16 (a WMMA
fragment's rows); the forward's CTA row tile is 128 on the bf16 rung
where 128 divides ``bm``, else 64 where 64 does, else 16.  Each output
row is its own dot product, so the row tile does not change results
(except the quantized rungs' scale tiles, which the plain twin takes at
the same row tile).  ``group_counts`` (optional, (E,) on the device) gives
each run's real rows; the rows past them are the zero padding, and
passing it changes no result (a padding row's product is zero).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import precision as prec
from repro_torch.kernels import _build, _trace
from repro_torch.kernels.gemm_refined import POLICY_CODES as _REFINED_CODES
from repro_torch.kernels.gemm_refined import gemm_refined_plain, gemm_refined_splitk_plain
from repro_torch.kernels.gemm_tiled import (MAINLOOPS, SPLIT_ARGTYPES, SPLITK_BN,
                                            gemm_tiled_plain,
                                            gemm_tiled_splitk_plain, on_cpu, sm_count,
                                            split_site_fields, split_workspace, splitk_splits)

__all__ = ["grouped_gemm", "grouped_gemm_dw", "grouped_gemm_plain", "grouped_gemm_dw_plain",
           "grouped_gemm_splitk_plain", "grouped_dw_scales", "grouped_dw_scales_plain",
           "dw_scale_slots", "grouped", "tile_group_ids", "tile_live_rows", "cta_rows",
           "grouped_splits", "LAUNCHES", "LAUNCHES_BY_LOOP", "LAUNCHES_BY_LOOP_DW",
           "POLICY_CODES", "ROW_TILE", "SPLITK_POLICIES", "DW_SCALE_TILES"]

LAUNCHES = {"grouped_gemm": 0, "grouped_gemm_dw": 0}
LAUNCHES_BY_LOOP = dict.fromkeys(MAINLOOPS, 0)   # the forward's (and dx's) mainloop
LAUNCHES_BY_LOOP_DW = dict.fromkeys(MAINLOOPS, 0)   # dW's mainloop
SCALE_PASS_LAUNCHES = 0   # the quantized dW rungs' quantize pass (grouped_dw_scales)
POLICY_CODES = {"bf16": 0, **_REFINED_CODES, "f32": 4, "bf16x6": 5, "fp8": 6, "int8": 7,
                "fp8x3": 8, "int8x3": 9}
_QUANT = ("fp8", "int8", "fp8x3", "int8x3")
_CTA_BK = {16: 64, 64: 32}   # the WMMA kernel's K step at each CTA row tile
ROW_TILE = 16          # the smallest CTA row tile: the alignment must be a multiple
# the rungs whose 16-row tiles run the split-K weight stream (the others WMMA)
SPLITK_POLICIES = ("bf16", *_REFINED_CODES)


def tile_group_ids(group_offsets: torch.Tensor, n_rows: int, bm: int) -> torch.Tensor:
    """(ceil(n_rows / bm),) int32 group id per row tile; tiles past
    ``offsets[-1]`` get E.  Each tile lies in one group because interior
    offsets are multiples of ``bm``; an empty group claims no tile."""
    starts = torch.arange(-(-n_rows // bm), dtype=torch.int32,
                          device=group_offsets.device) * bm
    return torch.searchsorted(group_offsets.to(torch.int32), starts, right=True,
                              out_int32=True) - 1


def cta_rows(bm: int, policy: str = "bf16") -> int:
    """The forward kernel's CTA row tile for alignment ``bm``: 128 on the
    bf16 rung where 128 divides ``bm`` (the Hopper mainloop's two consumer
    warpgroups), else 64 where 64 does, else 16; raises on an alignment it
    cannot serve."""
    if bm <= 0 or bm % ROW_TILE:
        raise ValueError(f"grouped_gemm needs a group alignment that is a multiple of "
                         f"{ROW_TILE}; got bm={bm}")
    if policy == "bf16" and bm % 128 == 0:
        return 128
    return 64 if bm % 64 == 0 else ROW_TILE


def grouped_splits(n_rows: int, n: int, k: int, sms: int) -> int:
    """K splits of a 16-row launch on the split-K stream: ``splitk_splits``
    over every 16-row tile of the buffer.  Only the tiles with live rows
    stream, but which those are lives on the device, and from the shapes
    alone any tile may be live (a group may own several tiles, a
    zero-width one none), so the workspace and tickets cover them all.  At
    Mixtral's decode (144 rows: 9 tiles, E = 8) the N tiles alone give one
    split."""
    return splitk_splits(-(-n_rows // ROW_TILE), ROW_TILE, n, k, sms)


def tile_live_rows(group_offsets: torch.Tensor, n_rows: int,
                   group_counts: torch.Tensor | None = None) -> list[int]:
    """The live rows of each 16-row tile, as the split-K stream takes them:
    0 for a dead tile (past ``offsets[E]``), else the rows from the tile's
    start to its group's end -- the next offset or, with ``group_counts``,
    ``offsets[g] + counts[g]`` if that is sooner -- at most 16 and the
    buffer's end.  Reads the offsets to the host (the plain models only)."""
    e = group_offsets.shape[0] - 1
    off = group_offsets.tolist()
    cnt = group_counts.tolist() if group_counts is not None else None
    live = []
    for z, g in enumerate(tile_group_ids(group_offsets, n_rows, ROW_TILE).tolist()):
        r0 = z * ROW_TILE
        if g >= e:
            live.append(0)
            continue
        end = off[g + 1] if cnt is None else min(off[g + 1], off[g] + cnt[g])
        live.append(max(0, min(ROW_TILE, n_rows - r0, end - r0)))
    return live


def _check_policy(policy: str) -> None:
    if policy not in POLICY_CODES:
        raise ValueError(f"grouped_gemm fuses {sorted(POLICY_CODES)}; got {policy!r}")


def _ladder_matmul(a: torch.Tensor, b: torch.Tensor, policy: str,
                   tiles=((0, 0), (0, 0))) -> torch.Tensor:
    """a @ b on the rung: the dense GEMM kernels' plain versions for bf16
    and the refined rungs, f32 matmul for f32, else the policy's terms
    (the quantized rungs scaled per ``tiles`` of a and b) summed smallest
    first."""
    if policy == "bf16":
        return gemm_tiled_plain(a, b)
    if policy in _REFINED_CODES:
        return gemm_refined_plain(a, b, policy)
    if policy == "f32":
        return torch.matmul(a.float(), b.float())
    if policy in _QUANT:
        at, bt = prec.tile_terms(a, policy, tiles[0]), prec.tile_terms(b, policy, tiles[1])
    else:
        at, bt = prec.operand_terms(a, b, policy)
    out = None
    for ta, tb in prec.policy_terms(policy):
        part = torch.matmul(at[ta].float(), bt[tb].float())
        out = part if out is None else out + part
    return out


@_trace.plain_twin
def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
                       bm: int, policy: str = "bf16", trans_w: bool = False,
                       group_counts: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch: a loop over groups of the
    ladder's product of each run against its expert; rows past
    ``offsets[E]`` are zero, and so are a run's rows past ``group_counts``
    where it is given (the zero padding, whose product is zero).  ``bm``
    (the alignment) sets the kernel's CTA row tile, and so the quantized
    rungs' scale tiles (taken over the whole run, padding included)."""
    _check_policy(policy)
    cta = cta_rows(bm, policy)
    tiles = ((cta, _CTA_BK.get(cta, 0)), (_CTA_BK.get(cta, 0), 128))
    off = group_offsets.tolist()
    out = torch.zeros((x.shape[0], w.shape[1] if trans_w else w.shape[2]),
                      dtype=torch.float32, device=x.device)
    for g in range(w.shape[0]):
        if off[g + 1] > off[g]:
            wg = w[g].t() if trans_w else w[g]
            out[off[g]:off[g + 1]] = _ladder_matmul(x[off[g]:off[g + 1]], wg, policy, tiles)
    if group_counts is not None:
        for g, c in enumerate(group_counts.tolist()):
            out[min(off[g] + c, off[g + 1]):off[g + 1]] = 0
    return out


def grouped_gemm_splitk_plain(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
                              policy: str = "bf16", splits: int, trans_w: bool = False,
                              group_counts: torch.Tensor | None = None) -> torch.Tensor:
    """The split-K stream's group-rows sum in plain PyTorch (the card's
    arithmetic at a 16-row CTA tile, for tests): each tile's live rows
    (``tile_live_rows``) run ``gemm_tiled_splitk_plain`` (bf16) or
    ``gemm_refined_splitk_plain`` against their expert over ``splits`` K
    splits; every other row is zero."""
    if policy not in SPLITK_POLICIES:
        raise ValueError(f"the split-K stream runs {SPLITK_POLICIES}; got {policy!r}")
    n_rows = x.shape[0]
    gids = tile_group_ids(group_offsets, n_rows, ROW_TILE).tolist()
    out = torch.zeros((n_rows, w.shape[1] if trans_w else w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for z, m in enumerate(tile_live_rows(group_offsets, n_rows, group_counts)):
        if m:
            r0 = z * ROW_TILE
            wg = w[gids[z]].t() if trans_w else w[gids[z]]
            out[r0:r0 + m] = (gemm_tiled_splitk_plain(x[r0:r0 + m], wg, splits)
                              if policy == "bf16" else
                              gemm_refined_splitk_plain(x[r0:r0 + m], wg, policy, splits))
    return out


# The dW's scale tiles of the quantized rungs: 64 x 32 of x^T and 32 x 128
# of dy (the WMMA kernel's A and B tiles), starting at each run's first row.
DW_SCALE_TILES = ((64, 32), (32, 128))


@_trace.plain_twin
def grouped_gemm_dw_plain(x: torch.Tensor, dy: torch.Tensor, group_offsets: torch.Tensor, *,
                          policy: str = "bf16") -> torch.Tensor:
    """dw[g] = x_g^T . dy_g in plain PyTorch, zero for an empty run."""
    _check_policy(policy)
    off = group_offsets.tolist()
    e = len(off) - 1
    dw = torch.zeros((e, x.shape[1], dy.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(e):
        if off[g + 1] > off[g]:
            dw[g] = _ladder_matmul(x[off[g]:off[g + 1]].t(), dy[off[g]:off[g + 1]], policy,
                                   DW_SCALE_TILES)
    return dw


def dw_scale_slots(n_rows: int, offsets: list[int]) -> tuple[int, list[int]]:
    """The quantize pass's scale buffer rows: (slot count, each group's first slot).
    Group g's K tile t (rows ``offsets[g] + 32 t`` on, up to its run's end)
    has slot ``offsets[g] // 32 + g + t``; a run of n rows has ceil(n / 32)
    tiles, so no group's slots reach the next group's first, and
    ``n_rows // 32 + E + 1`` slots hold every buffer of ``n_rows`` rows
    (the kernel's count, known without reading the offsets)."""
    k = DW_SCALE_TILES[0][1]
    return _slot_count(n_rows, len(offsets)), [o // k + g for g, o in enumerate(offsets[:-1])]


def _slot_count(n_rows: int, n_offsets: int) -> int:
    return n_rows // DW_SCALE_TILES[0][1] + n_offsets


def _scale_cols(d: int, f: int) -> tuple[int, int]:
    """The quantize pass's column tiles of x (64 wide) and of dy (128 wide)."""
    return -(-d // DW_SCALE_TILES[0][0]), -(-f // DW_SCALE_TILES[1][1])


def _pair_scales(v: torch.Tensor, policy: str, dims: tuple[int, ...]) -> torch.Tensor:
    """(hi, lo) pow2 scales over ``dims`` of v, as ``prec.tile_terms``
    takes them: hi's over |v|, lo's over the residual v - q(v) (x3 rungs;
    1 otherwise).  Returns v's shape without ``dims``, then 2."""
    fmt = prec.quant_format(policy)
    dtype, qmax = prec.QUANT_FORMATS[fmt]
    ln2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=v.device)

    def scale(u):
        amax = torch.clamp(u.abs().amax(dim=dims, keepdim=True), min=1e-30)
        return torch.exp(torch.ceil(torch.log2(amax / qmax)) * ln2)

    s_hi = scale(v)
    s_lo = torch.ones_like(s_hi)
    if policy.endswith("x3"):
        y = v / s_hi
        q = torch.clamp(torch.round(y), -qmax, qmax).to(dtype) if fmt == "int8" else y.to(dtype)
        s_lo = scale(v - (q.float() * s_hi).to(torch.bfloat16).float())
    return torch.stack([s_hi.squeeze(dims), s_lo.squeeze(dims)], dim=-1)


@_trace.plain_twin
def grouped_dw_scales_plain(x: torch.Tensor, dy: torch.Tensor, group_offsets: torch.Tensor, *,
                            policy: str) -> torch.Tensor:
    """The quantize pass's scales in plain PyTorch: (slots, ceil(D / 64) + ceil(F / 128),
    2) f32, the (hi, lo) scales of each K tile's x^T column tiles and then
    its dy column tiles, at the slots of ``dw_scale_slots``; zeros at the
    slots no tile owns.  A run that 32 does not divide ends in a short
    tile whose missing rows count as zeros (``prec.tile_terms`` pads it so)."""
    if policy not in _QUANT:
        raise ValueError(f"the dW quantize pass serves {_QUANT}; got {policy!r}")
    off = group_offsets.tolist()
    n_slots, first = dw_scale_slots(x.shape[0], off)
    nd, nf = _scale_cols(x.shape[1], dy.shape[1])
    out = torch.zeros((n_slots, nd + nf, 2), dtype=torch.float32, device=x.device)
    k = DW_SCALE_TILES[0][1]
    for g in range(len(off) - 1):
        n = off[g + 1] - off[g]
        if n == 0:
            continue
        kt = -(-n // k)
        for mat, c0, ct in ((x, 0, nd), (dy, nd, nf)):
            cw = DW_SCALE_TILES[0][0] if c0 == 0 else DW_SCALE_TILES[1][1]
            run = mat[off[g]:off[g + 1]].float()
            run = torch.nn.functional.pad(run, (0, ct * cw - run.shape[1], 0, kt * k - n))
            out[first[g]:first[g] + kt, c0:c0 + ct] = _pair_scales(
                run.reshape(kt, k, ct, cw), policy, (1, 3))
    return out


# The forward's rungs beyond bf16, its refinements and f32 are built from
# their own source (gemm_grouped_ext.cu), so the three compile in parallel.
_EXT_POLICIES = ("bf16x6", *_QUANT)


@functools.cache
def _forward_launcher(ext: bool):
    c = ctypes
    lib = _build.load("gemm_grouped_ext" if ext else "gemm_grouped")
    fwd = lib.grouped_gemm_ext_launch if ext else lib.grouped_gemm_launch
    fwd.argtypes = [c.c_void_p, c.c_int, c.c_longlong, c.c_longlong,               # x
                    c.c_void_p, c.c_int, c.c_longlong, c.c_longlong, c.c_longlong,  # w
                    c.c_void_p, c.c_int, c.c_void_p, c.c_void_p,        # gids, E, offsets, counts
                    c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,  # out m n k cta pol
                    *SPLIT_ARGTYPES, c.POINTER(c.c_int), c.c_void_p, c.c_int]
    fwd.restype = c.c_int
    return fwd


@functools.cache
def _dw_launchers():
    """(dW, quantize pass) C launchers, typed once."""
    c = ctypes
    lib = _build.load("gemm_grouped_dw")
    dw, sc = lib.grouped_gemm_dw_launch, lib.grouped_dw_scales_launch
    dw.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_int,            # x, dy (hi planes)
                   c.c_void_p, c.c_void_p,                              # lo planes
                   c.c_void_p, c.c_int, c.c_void_p, c.c_int, c.c_int,   # offsets, E, dw, rows, d
                   c.c_int, c.c_int, c.POINTER(c.c_int), c.c_void_p, c.c_int]
    sc.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_int, c.c_void_p, c.c_int, c.c_int,
                   c.c_int, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
                   c.c_void_p, c.c_void_p, c.c_int]
    dw.restype = sc.restype = c.c_int
    return dw, sc


def _operand(x: torch.Tensor) -> torch.Tensor:
    """f32 or bf16, contiguous rows."""
    x = x if x.dtype in (torch.float32, torch.bfloat16) else x.float()
    return x.contiguous()


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _site(kernel: str, entry: str, policy: str, outputs, mainloop: str | None,
          terms: int, **fields) -> _trace.KernelSite:
    return _trace.KernelSite(kernel=kernel, entry=entry, mainloop=mainloop, policy=policy,
                             terms=terms, contractions=1 if terms else 0,
                             outputs=tuple((tuple(o), torch.float32) for o in outputs), **fields)


def _forward_site(x, w, bm: int, cta: int, policy: str, trans_w: bool) -> _trace.KernelSite:
    """The forward / dx launch: CTA row tiles of ``cta`` rows, each inside
    one group because ``cta`` divides the alignment ``bm``; at 16 rows on
    the split-K stream, K split by ``grouped_splits``."""
    e, d, f = w.shape
    n_rows, n_out = x.shape[0], (d if trans_w else f)
    split = cta == ROW_TILE and policy in SPLITK_POLICIES
    if split:
        loop = "splitk"
    elif policy == "bf16" and cta in (64, 128):
        loop = "sm90"
    else:
        loop = "wmma"
    fields = split_site_fields(-(-x.shape[1] // SPLITK_BN),
                               grouped_splits(n_rows, n_out, x.shape[1], _trace.AUDIT_SMS)
                               ) if split and n_rows * n_out else {}
    return _site("grouped_gemm", "grouped_gemm_launch", policy, ((n_rows, n_out),), loop,
                 prec.num_passes(policy),
                 blocks=(_trace.Block("group_alignment", (bm,), (cta,), divisible=True),),
                 **fields)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
                 bm: int, policy: str = "bf16", trans_w: bool = False,
                 group_counts: torch.Tensor | None = None) -> torch.Tensor:
    """out[r] = x[r] @ w[g] (``trans_w``: @ w[g]^T) for the rows r of
    group g; f32 (N, F) (or (N, D)).

    x: (N, D) (or (N, F)) sorted by group, runs aligned to ``bm``,
    padding rows zero; w: (E, D, F) f32 or bf16; group_offsets: (E+1,)
    int32; group_counts: None, or (E,) each run's real rows (the rows
    before its padding), which lets the 16-row split-K stream skip the
    tiles that hold only padding (the same result).  CPU tensors run
    ``grouped_gemm_plain``; CUDA tensors launch the kernel or raise.
    """
    _check_policy(policy)
    cta = cta_rows(bm, policy)
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_gemm expects (N,K) x (E,K,F); got {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    k_dim = w.shape[2] if trans_w else w.shape[1]
    if x.shape[1] != k_dim or group_offsets.shape != (w.shape[0] + 1,):
        raise ValueError(f"grouped_gemm shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"trans_w={trans_w}, offsets {tuple(group_offsets.shape)}")
    if group_counts is not None and group_counts.shape != (w.shape[0],):
        raise ValueError(f"grouped_gemm: group_counts must be (E,) = ({w.shape[0]},); got "
                         f"{tuple(group_counts.shape)}")
    if _trace.ACTIVE:
        return _trace.launch(_forward_site(x, w, bm, cta, policy, trans_w), x, w, group_offsets,
                             group_counts)
    if on_cpu(x, w, group_offsets, *(() if group_counts is None else (group_counts,))):
        return grouped_gemm_plain(x, w, group_offsets, policy=policy, trans_w=trans_w, bm=bm,
                                  group_counts=group_counts)
    x, w = _operand(x), _operand(w)
    e, d, f = w.shape
    n_rows = x.shape[0]
    n_out = d if trans_w else f
    out = torch.empty((n_rows, n_out), dtype=torch.float32, device=x.device)
    if out.numel():
        offsets = group_offsets.to(torch.int32).contiguous()
        gids = tile_group_ids(offsets, n_rows, cta)
        counts = None if group_counts is None else group_counts.to(torch.int32).contiguous()
        splits, ws = 1, (None, 0, None, 0)
        index = _device_index(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if cta == ROW_TILE and policy in SPLITK_POLICIES:
            splits = grouped_splits(n_rows, n_out, x.shape[1], sm_count(index))
            ws = split_workspace(index, stream)
        # B = w[g] (K x N): row-major (k-stride F) or, for dx, w[g]^T (k-stride 1)
        sbk, sbn = (1, f) if trans_w else (f, 1)
        loop = ctypes.c_int(-1)
        rc = _forward_launcher(policy in _EXT_POLICIES)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0), 1,
            w.data_ptr(), int(w.dtype == torch.bfloat16), d * f, sbk, sbn,
            gids.data_ptr(), e, offsets.data_ptr(), None if counts is None else counts.data_ptr(),
            out.data_ptr(), n_rows, n_out, x.shape[1], cta, POLICY_CODES[policy], splits, *ws,
            ctypes.byref(loop), stream, index)
        _build.check(rc, "grouped_gemm_launch")
        LAUNCHES["grouped_gemm"] += 1
        LAUNCHES_BY_LOOP[MAINLOOPS[loop.value]] += 1
    return out


def _dw_shapes(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_gemm_dw expects (N,D), (N,F); got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")


def _quantize_on_card(x, dy, offsets, policy, planes: bool):
    """The quantize pass's launch on prepared operands (``_operand``) and
    int32 offsets: the scale buffer, and with ``planes`` the bf16 planes
    (x hi, x lo, dy hi, dy lo; the lo planes None for one pass)."""
    global SCALE_PASS_LAUNCHES
    d, f = x.shape[1], dy.shape[1]
    n_slots = _slot_count(x.shape[0], offsets.shape[0])
    scales = torch.zeros((n_slots, sum(_scale_cols(d, f)), 2), dtype=torch.float32,
                         device=x.device)
    x3 = policy.endswith("x3")

    def plane(m, needed):
        if not (planes and needed):
            return None
        return torch.empty(m.shape, dtype=torch.bfloat16, device=x.device)

    out = [plane(x, True), plane(x, x3), plane(dy, True), plane(dy, x3)]
    rc = _dw_launchers()[1](
        x.data_ptr(), int(x.dtype == torch.bfloat16), dy.data_ptr(),
        int(dy.dtype == torch.bfloat16), offsets.data_ptr(), offsets.shape[0] - 1, d, f,
        n_slots, POLICY_CODES[policy], scales.data_ptr(),
        *(p.data_ptr() if p is not None else None for p in out),
        torch.cuda.current_stream(x.device).cuda_stream, _device_index(x))
    _build.check(rc, "grouped_dw_scales_launch")
    SCALE_PASS_LAUNCHES += 1
    return scales, out


def grouped_dw_scales(x: torch.Tensor, dy: torch.Tensor, group_offsets: torch.Tensor, *,
                      policy: str) -> torch.Tensor:
    """The quantized dW rungs' quantize pass, its scales: the (hi, lo) pow2
    scales of every 64 x 32 tile of x^T and 32 x 128 tile of dy, laid out
    as ``grouped_dw_scales_plain`` returns them (the dW also takes the
    pass's bf16 terms, which these scales make).  CPU tensors run the plain
    twin; CUDA tensors launch the kernel or raise."""
    _dw_shapes(x, dy)
    if policy not in _QUANT:
        raise ValueError(f"the dW quantize pass serves {_QUANT}; got {policy!r}")
    if _trace.ACTIVE:
        slots = _slot_count(x.shape[0], group_offsets.shape[0])
        return _trace.launch(_site("grouped_dw_scales", "grouped_dw_scales_launch", policy,
                                   ((slots, sum(_scale_cols(x.shape[1], dy.shape[1])), 2),),
                                   None, 0), x, dy, group_offsets)
    if on_cpu(x, dy, group_offsets):
        return grouped_dw_scales_plain(x, dy, group_offsets, policy=policy)
    return _quantize_on_card(_operand(x), _operand(dy),
                             group_offsets.to(torch.int32).contiguous(), policy, False)[0]


def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor, group_offsets: torch.Tensor, *,
                    policy: str = "bf16") -> torch.Tensor:
    """dw[g] = x_g^T @ dy_g over group g's rows [offsets[g], offsets[g+1]);
    f32 (E, D, F), zero for an empty run.  x: (N, D), dy: (N, F).  CPU
    tensors run ``grouped_gemm_dw_plain``; CUDA tensors launch the
    kernel (bf16: the Hopper mainloop; the quantized rungs: the WMMA
    kernel after the quantize pass) or raise."""
    _check_policy(policy)
    _dw_shapes(x, dy)
    if _trace.ACTIVE:
        return _trace.launch(_site("grouped_gemm_dw", "grouped_gemm_dw_launch", policy,
                                   ((group_offsets.shape[0] - 1, x.shape[1], dy.shape[1]),),
                                   "sm90" if policy == "bf16" else "wmma",
                                   prec.num_passes(policy)), x, dy, group_offsets)
    if on_cpu(x, dy, group_offsets):
        return grouped_gemm_dw_plain(x, dy, group_offsets, policy=policy)
    x, dy = _operand(x), _operand(dy)
    if policy == "bf16":
        # the wgmma mainloop takes bf16 operands by TMA: round them here, as
        # its converting producer would (the same round-to-nearest-even)
        x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    e = group_offsets.shape[0] - 1
    d, f = x.shape[1], dy.shape[1]
    dw = torch.empty((e, d, f), dtype=torch.float32, device=x.device)
    if dw.numel():
        offsets = group_offsets.to(torch.int32).contiguous()
        lo = (None, None)
        if policy in _QUANT:   # the kernel reads the quantize pass's bf16 planes
            _, (x, x_lo, dy, dy_lo) = _quantize_on_card(x, dy, offsets, policy, True)
            lo = (x_lo, dy_lo)
        loop = ctypes.c_int(-1)
        rc = _dw_launchers()[0](
            x.data_ptr(), int(x.dtype == torch.bfloat16), dy.data_ptr(),
            int(dy.dtype == torch.bfloat16),
            *(p.data_ptr() if p is not None else None for p in lo),
            offsets.data_ptr(), e, dw.data_ptr(), x.shape[0], d, f, POLICY_CODES[policy],
            ctypes.byref(loop), torch.cuda.current_stream(x.device).cuda_stream,
            _device_index(x))
        _build.check(rc, "grouped_gemm_dw_launch")
        LAUNCHES["grouped_gemm_dw"] += 1
        LAUNCHES_BY_LOOP_DW[MAINLOOPS[loop.value]] += 1
    return dw


class _Grouped(torch.autograd.Function):
    """Twin of the JAX ``_grouped`` custom VJP: dx is the forward kernel
    against w^T (``trans_w``), dW the dW kernel, both on the forward's
    rung; gradients come back in the operands' dtypes.  ``group_counts``
    reaches the forward only: the cotangent's padding rows need not be
    zero, and dx computes them."""

    @staticmethod
    def forward(ctx, x, w, group_offsets, bm, policy, group_counts):
        ctx.save_for_backward(x, w, group_offsets)
        ctx.bm, ctx.policy = bm, policy
        return grouped_gemm(x, w, group_offsets, bm=bm, policy=policy, group_counts=group_counts)

    @staticmethod
    def backward(ctx, g):
        x, w, offsets = ctx.saved_tensors
        g = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_gemm(g, w, offsets, bm=ctx.bm, policy=ctx.policy,
                              trans_w=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = grouped_gemm_dw(x, g, offsets, policy=ctx.policy).to(w.dtype)
        return dx, dw, None, None, None, None


def grouped(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
            bm: int, policy: str = "bf16",
            group_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable ``grouped_gemm`` (the ``cuda_grouped`` impl's call)."""
    return _Grouped.apply(x, w, group_offsets, bm, policy, group_counts)
