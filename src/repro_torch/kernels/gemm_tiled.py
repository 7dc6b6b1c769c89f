"""Tiled bf16 GEMM on the Hopper tensor cores (``csrc/gemm_tiled.cu``).

Replaces the TPU kernel ``repro/kernels/gemm_tiled.py:_gemm_kernel``
(``pallas_call`` at ``gemm_tiled.py:91``): C = A.B with both operands
rounded to bf16 and an f32 accumulator, the paper's "WMMA + shared
memory" surface (its Fig. 6 CUTLASS column).

What bounds it on the H100.  Prefill and training shapes (M > 16) are
bounded by operations once their operands are staged well: 4096^3 is 139
us of bf16 tensor-core work against 20 us of bytes; the prefill MLP (700 x
1152 x 6912 against f32 weights) moves 16 us of bytes against 11 us of
work.  Decode (M <= 16 rows against a 1152 x 262144 table) is a weight
stream, bounded by bytes alone.

The design, by shape:
  M > 16   the Hopper mainloop (``csrc/gemm_sm90.cuh``): a producer
           warpgroup fills a 4-stage ring of 128-byte swizzled tiles (TMA
           for bf16 operands that are contiguous along K or M/N and 16-byte
           aligned; 16-byte loads rounded to bf16 on the way in for f32
           operands and odd strides), one or two consumer warpgroups run
           ``wgmma`` m64n128k16 on it, BM 64 up to 64 rows, else 128.
  M <= 16  the WMMA skinny tile (``csrc/gemm_common.cuh``): 16-row blocks
           stream each weight once with little wasted tensor-core work
           (split-K comes later).
Both read f32 or bf16 operands where they lie, through their strides (the
JAX wrapper's ``astype(bfloat16)`` would write a 0.6 GB bf16 copy of the
unembed table per call in eager PyTorch), and mask the ragged edges in
the kernel (no padded copy).  ``LAUNCHES_BY_LOOP`` counts which mainloop
each launch ran.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["gemm_tiled", "gemm_tiled_plain", "LAUNCHES", "LAUNCHES_BY_LOOP", "MAINLOOPS"]

LAUNCHES = 0
MAINLOOPS = ("wmma", "sm90")      # the C launchers' mainloop ids
LAUNCHES_BY_LOOP = dict.fromkeys(MAINLOOPS, 0)

_c = ctypes
GEMM_ARGTYPES = [
    _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_longlong, _c.c_longlong,   # a
    _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_longlong, _c.c_longlong,   # b
    _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,                  # c, batch, m, n, k
]


def gemm_tiled_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: bf16-rounded operands, upcast,
    multiplied and summed in f32 (products of bf16 values are exact)."""
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


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


def launch_gemm(fn, a: torch.Tensor, b: torch.Tensor, *extra) -> torch.Tensor:
    """Launch a strided (batched) GEMM launcher of the gemm_common.cuh
    family; ``extra`` C ints go between ``k`` and the stream."""
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
                torch.cuda.current_stream(a.device).cuda_stream, dev)
        _build.check(rc, fn.__name__)
    return c[0] if squeeze else c


@functools.cache
def _launcher():
    fn = _build.load("gemm_tiled").gemm_tiled_launch
    fn.argtypes = [*GEMM_ARGTYPES, _c.POINTER(_c.c_int), _c.c_void_p, _c.c_int]
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
    if on_cpu(a, b):
        return gemm_tiled_plain(a, b)
    loop = _c.c_int(-1)
    out = launch_gemm(_launcher(), a, b, _c.byref(loop))
    LAUNCHES += 1
    if loop.value >= 0:
        LAUNCHES_BY_LOOP[MAINLOOPS[loop.value]] += 1
    return out
