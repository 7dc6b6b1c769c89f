"""Unstaged bf16 GEMM on the Hopper tensor cores (``csrc/gemm_naive.cu``):
the paper's Listing 1, its Fig. 6 "WMMA without shared memory" column.

Replaces the TPU kernel ``repro/kernels/gemm_naive.py:_naive_kernel``
(``pallas_call`` at ``gemm_naive.py:60``): C = bf16(A).bf16(B) with an
f32 accumulator, whole-K strips and no K-blocked pipeline.  On Hopper
that is the listing as written: one warp per 16 x 16 output tile, each
fragment read by ``wmma::load_matrix_sync`` straight from global memory,
a K loop in 16-steps into one f32 fragment, stored once.

What bounds it on the H100: by the function, bytes at the decode shapes
(a 4 x 1152 x 262144 unembed streams the table) and operations at the
prefill and square shapes.  What bounds the kernel is neither: no warp
shares an operand fragment with another through shared memory, so every
fragment is fetched from L2 (or HBM) once per output tile that needs it,
and nothing overlaps the loads with the MMAs but the other warps.  That
is the point of the baseline: the paper shows it losing to SGEMM, and
``gemm_tiled`` is the staged kernel.  It must stay unstaged.

The wrapper rounds the operands to bf16 copies, as the JAX wrapper does
(``astype(bfloat16)``), padded with zeros to multiples of 16 in M, N and
K (the JAX router pads to 128); an operand that is already bf16, aligned
and 16-divisible is read in place.  A transposed view (the unembed's
``table.t()``, the backward's K-major B or M-contiguous A) keeps its
layout: the kernel loads it as a column-major fragment.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _trace
from repro_torch.kernels.ref import gemm_mixed_ref
from repro_torch.kernels.gemm_tiled import check_operands, gemm_dims, gemm_outputs, on_cpu

__all__ = ["gemm_naive", "gemm_naive_plain", "LAUNCHES"]

LAUNCHES = 0

_c = ctypes
_ARGTYPES = [
    _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_longlong,     # a, column-major, ld, batch stride
    _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_longlong,     # b
    _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,     # c, batch, m, n, k
    _c.c_void_p, _c.c_int,                                   # stream, device
]


@_trace.plain_twin
def gemm_naive_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: bf16-rounded operands, upcast,
    multiplied and summed in f32 (products of bf16 values are exact)."""
    return gemm_mixed_ref(a, b)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _operand(x: torch.Tensor, rows: int, cols: int) -> tuple[torch.Tensor, bool, int, int]:
    """(g, r, c) -> (a bf16 (g, rows, cols) operand, column-major?, leading
    dimension, batch stride).  Read in place when it already is one the
    kernel takes; else a zero-padded bf16 copy in the same layout."""
    g, r, c = x.shape
    col = x.stride(1) == 1 and x.stride(2) != 1
    ld = x.stride(2) if col else x.stride(1)
    if (x.dtype == torch.bfloat16 and (r, c) == (rows, cols) and (col or x.stride(2) == 1)
            and ld % 8 == 0 and ld >= (rows if col else cols)
            and (g == 1 or x.stride(0) % 16 == 0) and x.data_ptr() % 32 == 0):
        return x, col, ld, x.stride(0)
    alloc = torch.zeros if (r, c) != (rows, cols) else torch.empty
    if col:
        buf = alloc((g, cols, rows), dtype=torch.bfloat16, device=x.device).transpose(1, 2)
    else:
        buf = alloc((g, rows, cols), dtype=torch.bfloat16, device=x.device)
    buf[:, :r, :c].copy_(x)
    return buf, col, (rows if col else cols), rows * cols


def _site(a: torch.Tensor, b: torch.Tensor) -> _trace.KernelSite:
    """The operands as the wrapper hands them: padded to 16-multiples, one
    warp per 16 x 16 output tile, the kernel's only shapes."""
    batch, m, n, k = gemm_dims(a, b)
    mp, np_, kp = _round16(m), _round16(n), _round16(k)
    return _trace.KernelSite(
        kernel="gemm_naive", entry="gemm_naive_launch", mainloop=None, policy="bf16", terms=1,
        contractions=1, outputs=gemm_outputs(a, b),
        blocks=(_trace.Block("a", (batch, mp, kp), (1, 16, 16), divisible=True),
                _trace.Block("b", (batch, kp, np_), (1, 16, 16), divisible=True)))


@functools.cache
def _launcher():
    fn = _build.load("gemm_naive").gemm_naive_launch
    fn.argtypes = _ARGTYPES
    fn.restype = _c.c_int
    return fn


def gemm_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, one warp per 16 x 16 output tile, operands read from
    global memory with no staging; bf16 passes, f32 accumulator.

    a: (m, k) or (g, m, k); b: (k, n) or (g, k, n); any float dtype and
    strides.  Returns f32.  CPU tensors run ``gemm_naive_plain``; CUDA
    tensors launch the kernel or raise.
    """
    global LAUNCHES
    check_operands(a, b)
    if _trace.ACTIVE:
        return _trace.launch(_site(a, b), a, b)
    if on_cpu(a, b):
        return gemm_naive_plain(a, b)
    squeeze = a.dim() == 2
    a3 = a.unsqueeze(0) if squeeze else a
    b3 = b.unsqueeze(0) if squeeze else b
    batch, m, k = a3.shape
    n = b3.shape[2]
    mp, np_, kp = _round16(m), _round16(n), _round16(k)
    c = torch.empty((batch, mp, np_), dtype=torch.float32, device=a.device)
    if c.numel():
        ap, a_col, lda, sab = _operand(a3, mp, kp)
        bp, b_col, ldb, sbb = _operand(b3, kp, np_)
        dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
        _build.check(_launcher()(ap.data_ptr(), int(a_col), lda, sab, bp.data_ptr(), int(b_col),
                                 ldb, sbb, c.data_ptr(), batch, mp, np_, kp,
                                 torch.cuda.current_stream(a.device).cuda_stream, dev),
                     "gemm_naive_launch")
        LAUNCHES += 1
    c = c[:, :m, :n]
    return c[0] if squeeze else c
