"""Quantized GEMM with per-tile scales on the Hopper tensor cores
(``csrc/gemm_lowp.cu``): the ladder's fp8 / int8 rungs below bf16.

Replaces the TPU kernel ``repro/kernels/gemm_lowp.py:_lowp_kernel`` with
``_quant_tile`` (``pallas_call`` at ``gemm_lowp.py:125``).  f32 in, f32
out; A is quantized per (bm, bk) tile and B per (bk, bn) tile of a grid
anchored at 0, each tile under its own amax scale ``s = amax / qmax``
(127 for int8, 448 for e4m3): int8 takes ``round(x / s)`` (half to even)
clipped to +-127, e4m3 clips ``x / s`` to +-448 and rounds to nearest even
in the cast.  fp8 / int8 run one pass; fp8x3 / int8x3 quantize the
residual ``x - q*s`` under its own tile scale and run three
(lo.hi + hi.lo, then + hi.hi), each dequantized by its product of scales
into one f32 accumulator at every bk boundary.  The ragged last tile is
masked, which is what the TPU kernel's zero padding computes.

What bounds it on the H100: at the prefill MLP (700 x 1152 x 6912,
fp8x3) 3 x 11.1 GFLOP take 0.017 ms at the 1979 TFLOP/s fp8 rate and the
~54 MB of f32 operands and output 0.016 ms; at the decode MLP (4 x 1152 x
6912) the 31.9 MB f32 weight stream bounds it (0.0095 ms).  The design: a
scale pass writes the per-tile scale planes (reading each operand once,
and once more for the residuals' scales), then the GEMM quantizes every
operand tile on its way into shared memory and runs the passes on exact
bf16 carriers of the quantized values (WMMA; products exact in f32), with
its M/N tile nested in one quantization tile so that the dequantizing
flush at each bk boundary multiplies by scalars.  Native e4m3 / s8 MMA
and a fused scale pass come later.

``gemm_lowp_plain`` computes the same function in plain PyTorch, tile for
tile and in the same order of operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.gemm_tiled import check_operands, on_cpu

__all__ = ["gemm_lowp", "gemm_lowp_plain", "LAUNCHES", "LOWP_POLICIES"]

LAUNCHES = 0

LOWP_POLICIES = ("int8", "fp8", "int8x3", "fp8x3")   # the kernel's policy codes, in order
_QMAX = {"int8": 127.0, "fp8": 448.0}
# the kernel's CTA tiles (BM, BN, BK): 16-row for M <= 16, else 64 x 128
_CTA_DECODE, _CTA = (16, 128, 64), (64, 128, 32)


def _check_policy(policy: str) -> None:
    if policy not in LOWP_POLICIES:
        raise ValueError(f"policy {policy!r} not in {LOWP_POLICIES}")


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


def _lowp_2d(a, b, policy, bm, bn, bk):
    m, n = a.shape[0], b.shape[1]
    fmt = policy[:-2] if policy.endswith("x3") else policy
    a = F.pad(a.float(), (0, -a.shape[1] % bk, 0, -m % bm))
    b = F.pad(b.float(), (0, -n % bn, 0, -b.shape[0] % bk))
    qa, sa = _quantize(a, bm, bk, fmt)
    qb, sb = _quantize(b, bk, bn, fmt)
    x3 = policy.endswith("x3")
    if x3:
        qra, sra = _quantize(a - qa * _expand(sa, bm, bk), bm, bk, fmt)
        qrb, srb = _quantize(b - qb * _expand(sb, bk, bn), bk, bn, fmt)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for t in range(a.shape[1] // bk):
        ks = slice(t * bk, (t + 1) * bk)

        def coef(sx, sy):    # per output tile: the product of the two tiles' scales
            return _expand(sx[:, t:t + 1] * sy[t:t + 1, :], bm, bn)

        hh = (qa[:, ks] @ qb[ks]) * coef(sa, sb)
        if x3:
            lohi = (qra[:, ks] @ qb[ks]) * coef(sra, sb) + (qa[:, ks] @ qrb[ks]) * coef(sa, srb)
            acc = acc + (lohi + hh)
        else:
            acc = acc + hh
    return acc[:m, :n]


def gemm_lowp_plain(a: torch.Tensor, b: torch.Tensor, policy: str = "int8x3",
                    bm: int = 256, bn: int = 256, bk: int = 256) -> torch.Tensor:
    """The same function in plain PyTorch: zero-pad to the tile grid (as
    the TPU kernel's caller does), quantize each tile, and per K-tile sum
    the passes' products (exact for int8) and dequantize into the f32
    accumulator.  a (m, k) or (g, m, k); b (k, n) or (g, k, n)."""
    _check_policy(policy)
    check_operands(a, b)
    if a.dim() == 3:
        return torch.stack([_lowp_2d(x, y, policy, bm, bn, bk) for x, y in zip(a, b)])
    return _lowp_2d(a, b, policy, bm, bn, bk)


@functools.cache
def _launcher():
    fn = _build.load("gemm_lowp").gemm_lowp_launch
    c = ctypes
    fn.argtypes = [c.c_void_p] * 7 + [c.c_int] * 8 + [c.c_void_p, c.c_int]
    fn.restype = c.c_int
    return fn


def gemm_lowp(a: torch.Tensor, b: torch.Tensor, *, policy: str = "int8x3",
              bm: int = 256, bn: int = 256, bk: int = 256) -> torch.Tensor:
    """Fused quantized C = A @ B with per-tile scales, f32 out.

    a: (m, k) or (g, m, k); b: (k, n) or (g, k, n); any float type and
    strides (the kernel reads f32 row-major copies).  (bm, bn, bk) is the
    quantization grid; the kernel's CTA tile must nest in it (a grid tile
    at least as large as the problem, or a multiple of the CTA tile).  CPU
    tensors run ``gemm_lowp_plain``; CUDA tensors launch the kernel or
    raise.
    """
    global LAUNCHES
    _check_policy(policy)
    check_operands(a, b)
    if on_cpu(a, b):
        return gemm_lowp_plain(a, b, policy, bm, bn, bk)
    squeeze = a.dim() == 2
    a3 = (a.unsqueeze(0) if squeeze else a).float().contiguous()
    b3 = (b.unsqueeze(0) if squeeze else b).float().contiguous()
    batch, m, k = a3.shape
    n = b3.shape[2]
    cta = _CTA_DECODE if m <= 16 else _CTA
    for grid, size, tile, name in zip((bm, bn, bk), (m, n, k), cta, "mnk"):
        if grid < size and grid % tile:
            raise ValueError(f"quantization tile b{name}={grid} neither covers {name}={size} "
                             f"nor is a multiple of the kernel's {tile}")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a3.device)
    if out.numel():
        mt, nt, kt = -(-m // bm), -(-n // bn), -(-k // bk)
        planes = [torch.empty(shape, dtype=torch.float32, device=a3.device)
                  for shape in ((batch, mt, kt),) * 2 + ((batch, kt, nt),) * 2]
        sa, sra, sb, srb = planes
        dev = a3.device.index if a3.device.index is not None else torch.cuda.current_device()
        rc = _launcher()(a3.data_ptr(), b3.data_ptr(), out.data_ptr(), sa.data_ptr(),
                         sra.data_ptr(), sb.data_ptr(), srb.data_ptr(), batch, m, n, k,
                         bm, bn, bk, LOWP_POLICIES.index(policy),
                         torch.cuda.current_stream(a3.device).cuda_stream, dev)
        _build.check(rc, "gemm_lowp_launch")
        LAUNCHES += 1
    return out[0] if squeeze else out
