"""Quantized GEMM with per-tile scales on the Hopper tensor cores
(``csrc/gemm_lowp.cu``): the ladder's fp8 / int8 rungs below bf16.

Replaces the TPU kernel ``repro/kernels/gemm_lowp.py:_lowp_kernel`` with
``_quant_tile`` (``pallas_call`` at ``gemm_lowp.py:125``).  f32 out; A is
quantized per (bm, bk) tile and B per (bk, bn) tile of a grid anchored at
0, each tile under its own amax scale ``s = amax / qmax`` (127 for int8,
448 for e4m3): int8 takes ``round(x / s)`` (half to even) clipped to
+-127, e4m3 clips ``x / s`` to +-448 and rounds to nearest even in the
cast.  fp8 / int8 run one pass; fp8x3 / int8x3 quantize the residual ``x -
q*s`` under its own tile scale and run three.  Quantization K-tile kq
gives ``u_kq = (P_lohi*(sra*sb) + P_hilo*(sa*srb)) + P_hihi*(sa*sb)`` (one
pass: ``P_hihi*(sa*sb)``) and C is ``((0 + u_0) + u_1) + ...``, each
operation rounded on its own.  The ragged last tile is masked, which is
what the TPU kernel's zero padding computes.

What bounds it on the H100, and the design, by regime
(``LAUNCHES_BY_LOOP`` counts them under ``gemm_tiled.MAINLOOPS``' ids):
  M <= 16  ``splitk``.  Decode's MLP (4 x 1152 x 6912, fp8x3) is a stream of
           31.9 MB of f32 weights, 0.0095 ms at 3.35 TB/s.  One launch: a
           thread-block cluster owns each B quantization tile, each of its
           CTAs holds all the tile's K rows of 64 columns in shared memory,
           read from device memory once; the cluster reduces the tile's
           amax (and the residual's) over distributed shared memory, each
           CTA A's few tile scales itself, then ``mma.sync`` with the
           weights as the MMA's rows and the activations as its n (the
           split-K weight stream's scheme) gives the tile's u_kq; the CTA
           that draws a column block's last ticket sums the K tiles' terms
           in kq order (``decode_plan``: the grid, cluster and workspace).
  M > 16   ``sm90``.  The prefill MLP (700 x 1152 x 6912) is 33.4 GFLOP of
           bf16-carrier passes at x3 (0.034 ms at 989 TFLOP/s).  A quantize
           pass (one launch for both operands, the same cluster reduction)
           writes the scale planes and each tile's hi / lo as bf16 carrier
           planes, every element quantized once; a wgmma mainloop reads
           every plane by TMA (one producer thread, a 4-stage ring of
           128-byte swizzled 64-deep stages, 64 x 128 CTA tiles) and two
           consumer warpgroups keep hi.hi, lo.hi and hi.lo in separate f32
           partials of 64 x 64, folded into the result where each
           quantization K-tile ends.
Quantized values ride bf16 carriers (exact: products exact in f32, int8
K-tile sums exact), so the int8 rungs equal the plain version bit for bit.

``gemm_lowp_plain`` computes the same function in plain PyTorch, tile for
tile and in the same order of operations; ``gemm_lowp_split_plain`` the
same sums as the kernels associate them (each K tile's term alone, then
summed in kq order), and ``lowp_planes_plain`` the quantize pass's scales
and planes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _trace
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels.gemm_tiled import MAINLOOPS, check_operands, on_cpu, sm_count

__all__ = ["gemm_lowp", "gemm_lowp_plain", "gemm_lowp_split_plain", "lowp_planes_plain",
           "decode_plan", "decode_slices", "check_grid", "DecodePlan", "LAUNCHES",
           "LAUNCHES_BY_LOOP", "LOWP_POLICIES"]

LAUNCHES = 0
LAUNCHES_BY_LOOP = dict.fromkeys(MAINLOOPS, 0)

LOWP_POLICIES = ("int8", "fp8", "int8x3", "fp8x3")   # the kernel's policy codes, in order
_QMAX = {"int8": 127.0, "fp8": 448.0}

# The kernels' tiles (``csrc/gemm_lowp.cu``).  Decode: a CTA holds DEC_SLICE
# columns of a B tile, all of its K rows (at most DEC_MAX_DEPTH), the tile's
# CTAs one cluster of at most MAX_CLUSTER; a CTA's term is DEC_PART floats.
# Quantize pass: slices of at most Q_ROWS x DEC_SLICE.  Mainloop: each
# consumer warpgroup's 64 columns nest in one B tile and its quantization
# K-tiles end on its 64-deep stages (SM90_NEST: what bm, bn, bk must be a
# multiple of, where they do not cover the problem; rows take the scales
# of their own A tile).
DEC_SLICE = 64
DEC_MAX_DEPTH = 512
DEC_PART = 1024
DEC_XCH = 4 * 32 * 24   # floats the CTA's K halves exchange in the slice's place
MAX_CLUSTER = 8
Q_ROWS = 256
SM90_NEST = (1, 64, 64)
SMEM_PER_SM = 228 * 1024          # an H100 SM's shared memory, 1 KB of it per CTA reserved
DEC_THREADS, THREADS_PER_SM = 256, 2048


def _check_policy(policy: str) -> None:
    if policy not in LOWP_POLICIES:
        raise ValueError(f"policy {policy!r} not in {LOWP_POLICIES}")


def _fmt(policy: str) -> str:
    return policy[:-2] if policy.endswith("x3") else policy


def _quant(x: torch.Tensor, s: torch.Tensor, fmt: str) -> torch.Tensor:
    """Exact quantized values (f32 carriers) of x under scale s."""
    y = x / s
    if fmt == "int8":
        return torch.clamp(torch.round(y), -127.0, 127.0)
    return torch.clamp(y, -448.0, 448.0).to(torch.float8_e4m3fn).float()


def _expand(s: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """(Rt, Ct) tile values -> (Rt*r, Ct*c) elementwise."""
    return s.repeat_interleave(r, dim=0).repeat_interleave(c, dim=1)


def _quantize(x: torch.Tensor, r: int, c: int, fmt: str):
    """Per-(r, c)-tile quantization of a tile-aligned x: (q, scales (Rt, Ct))."""
    rt, ct = x.shape[0] // r, x.shape[1] // c
    amax = torch.clamp(x.abs().reshape(rt, r, ct, c).amax(dim=(1, 3)), min=1e-30)
    # a tensor divisor, as the kernel divides: on CUDA, PyTorch divides by a
    # Python scalar by multiplying with its reciprocal (1 ulp off now and then)
    s = amax / amax.new_full((), _QMAX[fmt])
    return _quant(x, _expand(s, r, c), fmt), s


def _operands(a, b, policy, bm, bn, bk):
    """Both operands zero-padded to the grid and quantized: (qa, sa, qb, sb)
    and, for x3, the residuals' (qra, sra, qrb, srb) (else Nones)."""
    fmt = _fmt(policy)
    a = F.pad(a.float(), (0, -a.shape[1] % bk, 0, -a.shape[0] % bm))
    b = F.pad(b.float(), (0, -b.shape[1] % bn, 0, -b.shape[0] % bk))
    qa, sa = _quantize(a, bm, bk, fmt)
    qb, sb = _quantize(b, bk, bn, fmt)
    if not policy.endswith("x3"):
        return (qa, sa, qb, sb), (None,) * 4
    qra, sra = _quantize(a - qa * _expand(sa, bm, bk), bm, bk, fmt)
    qrb, srb = _quantize(b - qb * _expand(sb, bk, bn), bk, bn, fmt)
    return (qa, sa, qb, sb), (qra, sra, qrb, srb)


def _k_terms(a, b, policy, bm, bn, bk):
    """Each quantization K-tile's term u_kq of the padded product, in kq order."""
    (qa, sa, qb, sb), (qra, sra, qrb, srb) = _operands(a, b, policy, bm, bn, bk)
    for t in range(qa.shape[1] // bk):
        ks = slice(t * bk, (t + 1) * bk)

        def coef(sx, sy):    # per output tile: the product of the two tiles' scales
            return _expand(sx[:, t:t + 1] * sy[t:t + 1, :], bm, bn)

        hh = (qa[:, ks].float() @ qb[ks].float()) * coef(sa, sb)
        if qra is None:
            yield hh
        else:
            lohi = ((qra[:, ks].float() @ qb[ks].float()) * coef(sra, sb)
                    + (qa[:, ks].float() @ qrb[ks].float()) * coef(sa, srb))
            yield lohi + hh


def _lowp_2d(a, b, policy, bm, bn, bk):
    m, n = a.shape[0], b.shape[1]
    acc = None
    for u in _k_terms(a, b, policy, bm, bn, bk):
        acc = torch.zeros_like(u) if acc is None else acc
        acc = acc + u
    if acc is None:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    return acc[:m, :n]


def _batched(fn, a, b, *args):
    if a.dim() == 3:
        return torch.stack([fn(x, y, *args) for x, y in zip(a, b)])
    return fn(a, b, *args)


@_trace.plain_twin
def gemm_lowp_plain(a: torch.Tensor, b: torch.Tensor, policy: str = "int8x3",
                    bm: int = 256, bn: int = 256, bk: int = 256) -> torch.Tensor:
    """The same function in plain PyTorch: zero-pad to the tile grid (as
    the TPU kernel's caller does), quantize each tile, and per K-tile sum
    the passes' products (exact for int8) and dequantize into the f32
    accumulator.  a (m, k) or (g, m, k); b (k, n) or (g, k, n)."""
    _check_policy(policy)
    check_operands(a, b)
    return _batched(_lowp_2d, a, b, policy, bm, bn, bk)


def _split_2d(a, b, policy, bm, bn, bk):
    m, n, k = a.shape[0], b.shape[1], a.shape[1]
    acc = torch.zeros((-(-m // bm) * bm, -(-n // bn) * bn), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):  # each K tile quantized and multiplied alone, summed in kq order
        u, = _k_terms(a[:, k0:k0 + bk], b[k0:k0 + bk], policy, bm, bn, bk)
        acc = acc + u
    return acc[:m, :n]


def gemm_lowp_split_plain(a: torch.Tensor, b: torch.Tensor, policy: str = "int8x3",
                          bm: int = 256, bn: int = 256, bk: int = 256) -> torch.Tensor:
    """The kernels' order of operations in plain PyTorch: every
    quantization K-tile's term u_kq on its own (the decode kernel's CTAs,
    the mainloop's folds), then ``((0 + u_0) + u_1) + ...`` in kq order (the
    last CTA's sum).  The association is ``gemm_lowp_plain``'s, so the two
    are bit-equal."""
    _check_policy(policy)
    check_operands(a, b)
    return _batched(_split_2d, a, b, policy, bm, bn, bk)


def lowp_planes_plain(x: torch.Tensor, tr: int, tc: int, policy: str):
    """The quantize pass in plain PyTorch for one operand x (rows, cols)
    on a (tr, tc) grid: (hi, lo, s, sr) with hi = q(x) and lo = q(x - hi*s)
    as f32 carriers shaped like x, and the (nr, nc) tile scales s and the
    residual's sr.  lo and sr are None for one pass."""
    _check_policy(policy)
    rows, cols = x.shape
    xp = F.pad(x.float(), (0, -cols % tc, 0, -rows % tr))
    fmt = _fmt(policy)
    hi, s = _quantize(xp, tr, tc, fmt)
    if not policy.endswith("x3"):
        return hi[:rows, :cols], None, s, None
    lo, sr = _quantize(xp - hi * _expand(s, tr, tc), tr, tc, fmt)
    return hi[:rows, :cols], lo[:rows, :cols], s, sr


def check_grid(m: int, n: int, k: int, bm: int, bn: int, bk: int) -> None:
    """Raise ValueError for a quantization grid that no tile of the kernels
    nests in: at M <= 16 a B tile (its part inside the operand) must be at
    most MAX_CLUSTER x 64 wide and DEC_MAX_DEPTH deep; above, each
    dimension's grid tile must cover the problem or be a multiple of the
    mainloop's (any, 64, 64) (its rows take per-row scales), and each A
    and B tile fit a quantize cluster (MAX_CLUSTER slices of Q_ROWS x 64)."""
    if min(bm, bn, bk) < 1:
        raise ValueError(f"quantization tile ({bm}, {bn}, {bk}) must be positive")
    if m <= 16:
        if -(-min(bn, n) // DEC_SLICE) > MAX_CLUSTER or min(bk, k) > DEC_MAX_DEPTH:
            raise ValueError(f"quantization tile bk={bk} x bn={bn} is larger than the decode "
                             f"kernel's {DEC_MAX_DEPTH} x {MAX_CLUSTER * DEC_SLICE}")
        return
    for grid, size, tile, name in zip((bm, bn, bk), (m, n, k), SM90_NEST, "mnk"):
        if grid < size and grid % tile:
            raise ValueError(f"quantization tile b{name}={grid} neither covers {name}={size} "
                             f"nor is a multiple of the kernel's {tile}")
    for rows, cols, what in ((min(bm, m), min(bk, k), "A"), (min(bk, k), min(bn, n), "B")):
        if -(-rows // Q_ROWS) * -(-cols // DEC_SLICE) > MAX_CLUSTER:
            raise ValueError(f"{what}'s quantization tile {rows} x {cols} needs more than "
                             f"{MAX_CLUSTER} CTAs of {Q_ROWS} x {DEC_SLICE}")


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The decode kernel's launch (M <= 16), as ``csrc/gemm_lowp.cu``
    computes it: one cluster of ``cluster`` CTAs for each B quantization
    tile, grid (nt * cluster, kt, batch)."""
    kt: int              # K tiles (the terms each column block sums)
    nt: int              # N tiles
    cluster: int         # CTAs a B tile: ceil(tile width / 64)
    depth: int           # K rows a CTA stages: min(bk, k) rounded up to 16
    grid: tuple          # (nt * cluster, kt, batch)
    smem: int            # dynamic shared memory a CTA, bytes
    ctas_per_sm: int     # by shared memory and threads
    waves: float         # CTAs over the card's CTA slots
    slots: int           # workspace terms (DEC_PART floats each); 0 when kt == 1
    tickets: int         # one per 64-column block; 0 when kt == 1


@functools.lru_cache(maxsize=4096)
def decode_plan(batch: int, m: int, n: int, k: int, bn: int, bk: int,
                sms: int) -> DecodePlan:
    """The decode kernel's grid, cluster, shared memory, occupancy and
    workspace for a launch at M <= 16 (``check_grid`` first).  At
    gemma3-1b's decode MLP (bn = bk = 256, m = 4) a CTA stages 256 x 64
    f32 (64 KB) and A's 8 x 256 tile (8.3 KB): 3 CTAs an SM, 540 CTAs on 396
    slots of 132 SMs (1.36 waves), both for wi (5 K x 27 N tiles) and wo
    (27 x 5, the last N tile 128 wide: 2 of its 4 CTAs idle)."""
    kt, nt = -(-k // bk), -(-n // bn)
    cluster = -(-min(bn, n) // DEC_SLICE)
    depth = -(-min(bk, k) // 16) * 16
    a_rows = 8 if m <= 8 else 16
    smem = max(depth * DEC_SLICE, DEC_XCH) * 4 + a_rows * (depth + 8) * 4
    per_sm = min(SMEM_PER_SM // (smem + 1024), THREADS_PER_SM // DEC_THREADS)
    ctas = batch * nt * cluster * kt
    blocks = batch * nt * cluster
    return DecodePlan(kt=kt, nt=nt, cluster=cluster, depth=depth,
                      grid=(nt * cluster, kt, batch), smem=smem, ctas_per_sm=per_sm,
                      waves=ctas / (per_sm * sms), slots=blocks * kt if kt > 1 else 0,
                      tickets=blocks if kt > 1 else 0)


def decode_slices(plan: DecodePlan, n: int, k: int, bn: int, bk: int):
    """Each CTA's part of B, (batch, k0, k1, c0, c1), as the decode kernel
    takes it from its block and cluster rank; an idle CTA (a narrow last
    tile) has c1 <= c0."""
    out = []
    for bz in range(plan.grid[2]):
        for kq in range(plan.kt):
            for x in range(plan.grid[0]):
                nq, rank = divmod(x, plan.cluster)
                t0, t1 = nq * bn, min(n, nq * bn + bn)
                c0 = t0 + rank * DEC_SLICE
                out.append((bz, kq * bk, min(k, kq * bk + bk), c0, min(t1, c0 + DEC_SLICE)))
    return out


def _decode_workspace(index: int, stream: int, plan: DecodePlan):
    """The split kernels' workspace where the plan fits it, else one of the
    same shape sized for it (rounded up to a power of two), allocated once
    per device, stream and size."""
    ws = gt.split_workspace(index, stream)
    if plan.slots * DEC_PART <= ws[1] and plan.tickets <= ws[3]:
        return ws
    floats = 1 << max(plan.slots * DEC_PART - 1, 1).bit_length()
    tickets = 1 << max(plan.tickets - 1, 1).bit_length()
    return gt._workspace(f"lowp{floats}x{tickets}", index, stream, floats, tickets)


def _site(a: torch.Tensor, b: torch.Tensor, policy: str, bm: int, bn: int,
          bk: int) -> _trace.KernelSite:
    """At M <= 16 the decode plan's grid, each CTA starting on B's
    quantization tile (batch, kq, x // cluster) and the K tiles' terms
    summed in f32 partials; above, the launcher's own grid."""
    batch, m, n, k = gt.gemm_dims(a, b)
    check_grid(m, n, k, bm, bn, bk)
    fields = {}
    if m <= 16:
        plan = decode_plan(batch, m, n, k, bn, bk, _trace.AUDIT_SMS)
        fields = {"grid": plan.grid,
                  "blocks": (_trace.Block("b", (batch, k, n), (1, bk, bn),
                                          lambda x, y, z: (z, y, x // plan.cluster)),),
                  "workspace_dtype": torch.float32 if plan.slots else None}
    return _trace.KernelSite(
        kernel="gemm_lowp", entry="gemm_lowp_launch", mainloop="splitk" if m <= 16 else "sm90",
        policy=policy, terms=3 if policy.endswith("x3") else 1, contractions=1,
        outputs=gt.gemm_outputs(a, b), **fields)


@functools.cache
def _launcher():
    fn = _build.load("gemm_lowp").gemm_lowp_launch
    c = ctypes
    fn.argtypes = [c.c_void_p, c.c_int, c.c_longlong, c.c_longlong, c.c_longlong,
                   c.c_void_p, c.c_int, c.c_longlong, c.c_longlong, c.c_longlong,
                   c.c_void_p] + [c.c_int] * 8 + [c.c_void_p, c.c_longlong, c.c_void_p, c.c_int] \
        + [c.c_void_p] * 8 + [c.POINTER(c.c_int), c.c_void_p, c.c_int]
    fn.restype = c.c_int
    return fn


def gemm_lowp(a: torch.Tensor, b: torch.Tensor, *, policy: str = "int8x3",
              bm: int = 256, bn: int = 256, bk: int = 256) -> torch.Tensor:
    """Fused quantized C = A @ B with per-tile scales, f32 out.

    a: (m, k) or (g, m, k); b: (k, n) or (g, k, n); any float type and
    strides (f32 and bf16 are read where they lie, others as f32 copies).
    (bm, bn, bk) is the quantization grid (``check_grid`` says which the
    kernels take).  CPU tensors run ``gemm_lowp_plain``; CUDA tensors
    launch the kernels or raise.
    """
    global LAUNCHES
    _check_policy(policy)
    check_operands(a, b)
    if _trace.ACTIVE:
        return _trace.launch(_site(a, b, policy, bm, bn, bk), a, b)
    if on_cpu(a, b):
        return gemm_lowp_plain(a, b, policy, bm, bn, bk)
    squeeze = a.dim() == 2
    a3 = a.unsqueeze(0) if squeeze else a
    b3 = b.unsqueeze(0) if squeeze else b
    a3 = a3 if a3.dtype in (torch.float32, torch.bfloat16) else a3.float()
    b3 = b3 if b3.dtype in (torch.float32, torch.bfloat16) else b3.float()
    batch, m, k = a3.shape
    n = b3.shape[2]
    check_grid(m, n, k, bm, bn, bk)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a3.device)
    if out.numel() and k == 0:
        out.zero_()
    elif out.numel():
        index = a3.device.index if a3.device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(a3.device).cuda_stream
        x3 = policy.endswith("x3")
        ws, planes = (None, 0, None, 0), [None] * 8
        if m <= 16:
            ws = _decode_workspace(index, stream, decode_plan(batch, m, n, k, bn, bk,
                                                              sm_count(index)))
        else:
            kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
            mt, nt, kt = -(-m // bm), -(-n // bn), -(-k // bk)

            def empty(*shape, dtype=torch.bfloat16):
                return torch.empty(shape, dtype=dtype, device=a3.device)

            planes = [empty(batch, m, kp), empty(batch, m, kp) if x3 else None,
                      empty(batch, k, np_), empty(batch, k, np_) if x3 else None,
                      *(empty(batch, mt, kt, dtype=torch.float32) for _ in range(2)),
                      *(empty(batch, kt, nt, dtype=torch.float32) for _ in range(2))]
        sab, sam, sak = a3.stride()
        sbb, sbk, sbn = b3.stride()
        if squeeze:
            sab = sbb = 0
        loop = ctypes.c_int(-1)
        rc = _launcher()(a3.data_ptr(), int(a3.dtype == torch.bfloat16), sab, sam, sak,
                         b3.data_ptr(), int(b3.dtype == torch.bfloat16), sbb, sbk, sbn,
                         out.data_ptr(), batch, m, n, k, bm, bn, bk, LOWP_POLICIES.index(policy),
                         *ws, *(p.data_ptr() if p is not None else None for p in planes),
                         ctypes.byref(loop), stream, index)
        _build.check(rc, "gemm_lowp_launch")
        LAUNCHES += 1
        LAUNCHES_BY_LOOP[MAINLOOPS[loop.value]] += 1
    return out[0] if squeeze else out
