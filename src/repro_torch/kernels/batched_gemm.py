"""Batched small GEMMs on the Hopper tensor cores (``csrc/batched_gemm.cu``):
the paper's Fig. 7 workload, (G, n, n) x (G, n, n) -> (G, n, n) with bf16
operands and f32 accumulators and output.

Replaces two TPU kernels of ``repro/kernels/batched_gemm.py``:

  ``_packed_kernel`` (``pallas_call`` at :84)
      ``batched_gemm``: the TPU packs ``pack = tile // n`` matrices
      block-diagonally into one (tile x tile) MXU operand pair (tile 128:
      ``PACK_TILE``; on Hopper it only sets how many matrices a CTA takes) and slices
      the diagonal blocks back out.  Here one CTA takes the same group of
      ``pack`` matrices (the JAX grid's step), stages the group's operands
      once in shared memory, rounding them to bf16 on the way in, and runs
      WMMA only on the diagonal blocks; at n = 8 two matrices share one
      16 x 16 fragment block-diagonally (exact: the off-diagonal blocks
      are zero).  It raises where the JAX wrapper raises (n must divide
      the tile, pack must divide G) and takes n in {8, 16, 32, 64}
      (``PACKED_N``, checked on the CPU too); ``ops.gemm_batched`` sends
      the other divisors of the tile (1, 2, 4, 128) to the naive kernel,
      whose one warp per matrix takes any n, rather than instantiate a
      packed kernel for sizes below a fragment or of one matrix per CTA.
  ``_naive_kernel`` (``pallas_call`` at :120)
      ``batched_gemm_naive``: one warp per matrix, the paper's own Fig. 7
      mapping, its fragments read from global memory element by element
      (``mma.sync`` m16n8k16, the ragged edge zero-filled): any n.

What bounds them on the H100: bytes.  A 16 x 16 product does 8 KFLOP on
2 KB of bf16 operands and writes 1 KB of f32 (4 KB of f32 operands read
where they are f32): ~3 FLOP per byte against the 295 the tensor cores
need, so at any G the floor is the operand and output stream.  The
packed kernel reads each operand once with 16-byte loads; the naive one
issues scalar loads per fragment element, the baseline the paper measured.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import batched_gemm_ref
from repro_torch.kernels.gemm_tiled import on_cpu

__all__ = ["batched_gemm", "batched_gemm_naive", "batched_gemm_plain",
           "batched_gemm_naive_plain", "check_batched", "LAUNCHES", "PACKED_N", "PACK_TILE"]

LAUNCHES = {"batched_gemm": 0, "batched_gemm_naive": 0}
PACKED_N = (8, 16, 32, 64)       # the n the packed kernel is instantiated for
PACK_TILE = 128                  # the JAX kernel's MXU tile: a CTA takes PACK_TILE // n matrices

_c = ctypes


def check_batched(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(G, n) of matching (G, n, n) operands; raises otherwise."""
    if a.dim() != 3 or a.shape != b.shape or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected matching (G, n, n); got {tuple(a.shape)}, {tuple(b.shape)}")
    return a.shape[0], a.shape[1]


def _pack(g: int, n: int) -> int:
    if PACK_TILE % n:
        raise ValueError(f"n={n} must divide the packing tile={PACK_TILE}")
    pack = PACK_TILE // n
    if g % pack:
        raise ValueError(f"G={g} must be a multiple of pack={pack} (pad in ops.py)")
    return pack


def batched_gemm_naive_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a batched product of the
    bf16-rounded operands, upcast and summed in f32."""
    check_batched(a, b)
    return batched_gemm_ref(a, b)


def batched_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The packed kernel's function in plain PyTorch, under its contract
    (n divides ``PACK_TILE``, pack divides G): packing changes nothing
    numerically, each small product being its own diagonal block."""
    g, n = check_batched(a, b)
    _pack(g, n)
    return batched_gemm_ref(a, b)


def _operand(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A contiguous, 16-byte aligned f32 or bf16 operand and its bf16 flag."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, int(x.dtype == torch.bfloat16)


@functools.cache
def _launchers():
    lib = _build.load("batched_gemm")
    packed, naive = lib.batched_gemm_launch, lib.batched_gemm_naive_launch
    packed.argtypes = [_c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p,
                       _c.c_int, _c.c_int, _c.c_int, _c.c_void_p, _c.c_int]
    naive.argtypes = [_c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p,
                      _c.c_int, _c.c_int, _c.c_void_p, _c.c_int]
    packed.restype = naive.restype = _c.c_int
    return packed, naive


def _device_args(x: torch.Tensor) -> tuple[int, int]:
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return torch.cuda.current_stream(x.device).cuda_stream, dev


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, n, n) x (G, n, n) -> (G, n, n) f32, ``pack = PACK_TILE // n``
    matrices per CTA.  Requires n | PACK_TILE and pack | G
    (``ops.gemm_batched`` pads G).  CPU tensors run ``batched_gemm_plain``;
    CUDA tensors launch the kernel or raise."""
    g, n = check_batched(a, b)
    pack = _pack(g, n)
    if n not in PACKED_N:
        raise ValueError(f"the packed kernel takes n in {PACKED_N}; got n={n} "
                         f"(ops.gemm_batched sends it to batched_gemm_naive)")
    if on_cpu(a, b):
        return batched_gemm_plain(a, b)
    a, a16 = _operand(a)
    b, b16 = _operand(b)
    c = torch.empty((g, n, n), dtype=torch.float32, device=a.device)
    if g:
        _build.check(_launchers()[0](a.data_ptr(), a16, b.data_ptr(), b16, c.data_ptr(), g, n,
                                     pack, *_device_args(a)), "batched_gemm_launch")
        LAUNCHES["batched_gemm"] += 1
    return c


def batched_gemm_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, n, n) x (G, n, n) -> (G, n, n) f32, one warp per matrix, any n.
    CPU tensors run ``batched_gemm_naive_plain``; CUDA tensors launch the
    kernel or raise."""
    g, n = check_batched(a, b)
    if on_cpu(a, b):
        return batched_gemm_naive_plain(a, b)
    a, a16 = _operand(a)
    b, b16 = _operand(b)
    c = torch.empty((g, n, n), dtype=torch.float32, device=a.device)
    if g and n:
        _build.check(_launchers()[1](a.data_ptr(), a16, b.data_ptr(), b16, c.data_ptr(), g, n,
                                     *_device_args(a)), "batched_gemm_naive_launch")
        LAUNCHES["batched_gemm_naive"] += 1
    return c
