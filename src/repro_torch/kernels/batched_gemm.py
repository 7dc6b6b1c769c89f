"""Batched small GEMMs on the Hopper tensor cores (``csrc/batched_gemm.cu``):
the paper's Fig. 7 workload, (G, n, n) x (G, n, n) -> (G, n, n) with bf16
operands and f32 accumulators and output.

Replaces two TPU kernels of ``repro/kernels/batched_gemm.py``:

  ``_packed_kernel`` (``pallas_call`` at :84)
      ``batched_gemm``: the TPU packs ``pack = tile // n`` matrices
      block-diagonally into one (tile x tile) MXU operand pair (tile 128:
      ``PACK_TILE``; on Hopper it sets only the contract: n divides the
      tile, pack divides G) and slices the diagonal blocks back out.  Here
      a persistent stream (``packed_schedule``): CTAs walk chunks of
      ``CHUNK`` consecutive elements of each operand (whole matrices, 16 KB
      an operand in bf16) with a grid stride; one producer thread fills a
      ring of 2-4 stages by TMA (128-byte lines, 128B swizzle, so fragment
      reads are free of bank conflicts), eight consumer warps run
      ``mma.sync`` on the diagonal blocks only (at n = 8 two matrices share
      one 16 x 16 fragment block-diagonally: exact, the off-diagonal
      blocks are zero), rounding f32 operands to bf16 in the fragment load,
      and the f32 output leaves by a TMA store from shared memory while the
      next stage's loads are in flight.  It raises where the JAX wrapper
      raises and takes n in {8, 16, 32, 64} (``PACKED_N``, checked on the
      CPU too); ``ops.gemm_batched`` sends the other divisors of the tile
      (1, 2, 4, 128) to the naive kernel, whose one warp per matrix takes
      any n.
  ``_naive_kernel`` (``pallas_call`` at :120)
      ``batched_gemm_naive``: one warp per matrix, the paper's own Fig. 7
      mapping, its fragments read from global memory element by element
      (``mma.sync`` m16n8k16, the ragged edge zero-filled): any n.

What bounds them on the H100: bytes.  A product does n/4 FLOP a byte of
bf16 operands and f32 output (16 at n = 64) against the 295 the tensor
cores need, so at any G the floor is the operand and output stream.  The
packed stream keeps several chunks' loads and one store in flight on
every SM; the naive kernel issues scalar loads per fragment element, the
baseline the paper measured.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _trace
from repro_torch.kernels.ref import batched_gemm_ref
from repro_torch.kernels.gemm_tiled import SMEM_LIMIT, on_cpu, sm_count

__all__ = ["batched_gemm", "batched_gemm_naive", "batched_gemm_plain",
           "batched_gemm_naive_plain", "check_batched", "packed_schedule", "packed_chunks",
           "LAUNCHES", "PACKED_N", "PACK_TILE", "CHUNK"]

LAUNCHES = {"batched_gemm": 0, "batched_gemm_naive": 0}
PACKED_N = (8, 16, 32, 64)       # the n the packed kernel is instantiated for
PACK_TILE = 128                  # the JAX kernel's MXU tile: G must be a multiple of PACK_TILE // n
CHUNK = 8192                     # elements of each operand a stage holds (csrc: CHUNK)
OUT_BYTES = 4 * CHUNK            # a chunk's f32 output buffer
MAX_STAGES = 4

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


def packed_schedule(g: int, n: int, a_bf16: bool, b_bf16: bool, sms: int) -> dict:
    """The packed stream's launch: ``chunks`` chunks of ``CHUNK``
    elements of each operand (8192 / n^2 whole matrices; the last one
    ragged), ``grid`` persistent CTAs over them (two an SM where both
    operands are bf16 and a ring of 2 stages fits twice, one an SM with
    up to ``MAX_STAGES`` otherwise), a ring of ``stages`` and ``smem``
    bytes of shared memory a CTA (the 1024-byte alignment slack, the
    ring, the output buffer and two mbarriers a stage)."""
    stage = CHUNK * ((2 if a_bf16 else 4) + (2 if b_bf16 else 4))
    fixed = 1024 + OUT_BYTES
    if a_bf16 and b_bf16:
        per_sm, stages = 2, 2
    else:
        per_sm = 1
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (stage + 16))
    chunks = -(-g * n * n // CHUNK)
    return {"chunks": chunks, "grid": min(chunks, per_sm * sms), "stages": stages,
            "per_sm": per_sm, "smem": fixed + stages * (stage + 16)}


def packed_chunks(cta: int, grid: int, chunks: int) -> range:
    """The chunks CTA ``cta`` of a ``grid``-CTA launch takes, in order."""
    return range(cta, chunks, grid)


@_trace.plain_twin
def batched_gemm_naive_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a batched product of the
    bf16-rounded operands, upcast and summed in f32."""
    check_batched(a, b)
    return batched_gemm_ref(a, b)


@_trace.plain_twin
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
                       _c.c_longlong, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p, _c.c_int]
    naive.argtypes = [_c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p,
                      _c.c_int, _c.c_int, _c.c_void_p, _c.c_int]
    packed.restype = naive.restype = _c.c_int
    return packed, naive


def _device_args(x: torch.Tensor) -> tuple[int, int]:
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return torch.cuda.current_stream(x.device).cuda_stream, dev


def _site(kernel: str, entry: str, a: torch.Tensor, b: torch.Tensor,
          **fields) -> _trace.KernelSite:
    return _trace.KernelSite(kernel=kernel, entry=entry, mainloop=None, policy="bf16", terms=1,
                             contractions=1, outputs=((tuple(a.shape), torch.float32),),
                             **fields)


def _packed_site(a: torch.Tensor, b: torch.Tensor) -> _trace.KernelSite:
    """The packed stream as ``packed_schedule`` hands it to the launcher:
    ``grid`` persistent CTAs, CTA c starting on chunk c of each operand
    (``packed_chunks``), the matrices packed ``PACK_TILE // n`` to a tile."""
    g, n = check_batched(a, b)
    plan = packed_schedule(g, n, a.dtype == torch.bfloat16, b.dtype == torch.bfloat16,
                           _trace.AUDIT_SMS)
    chunks = (_trace.Block(x, (plan["chunks"] * CHUNK,), (CHUNK,), lambda c: (c,))
              for x in "ab")
    return _site("batched_gemm", "batched_gemm_launch", a, b, grid=(plan["grid"],),
                 blocks=(*chunks, _trace.Block("pack", (g,), (_pack(g, n),), divisible=True)))


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, n, n) x (G, n, n) -> (G, n, n) f32 by the packed stream
    (``packed_schedule``).  Requires n | PACK_TILE and PACK_TILE // n | G
    (``ops.gemm_batched`` pads G).  CPU tensors run ``batched_gemm_plain``;
    CUDA tensors launch the kernel or raise."""
    g, n = check_batched(a, b)
    _pack(g, n)
    if n not in PACKED_N:
        raise ValueError(f"the packed kernel takes n in {PACKED_N}; got n={n} "
                         f"(ops.gemm_batched sends it to batched_gemm_naive)")
    if _trace.ACTIVE:
        return _trace.launch(_packed_site(a, b), a, b)
    if on_cpu(a, b):
        return batched_gemm_plain(a, b)
    a, a16 = _operand(a)
    b, b16 = _operand(b)
    c = torch.empty((g, n, n), dtype=torch.float32, device=a.device)
    if g:
        stream, dev = _device_args(a)
        plan = packed_schedule(g, n, bool(a16), bool(b16), sm_count(dev))
        _build.check(_launchers()[0](a.data_ptr(), a16, b.data_ptr(), b16, c.data_ptr(), g, n,
                                     plan["grid"], plan["stages"], stream, dev),
                     "batched_gemm_launch")
        LAUNCHES["batched_gemm"] += 1
    return c


def batched_gemm_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, n, n) x (G, n, n) -> (G, n, n) f32, one warp per matrix, any n.
    CPU tensors run ``batched_gemm_naive_plain``; CUDA tensors launch the
    kernel or raise."""
    g, n = check_batched(a, b)
    if _trace.ACTIVE:
        return _trace.launch(_site("batched_gemm_naive", "batched_gemm_naive_launch", a, b,
                                   grid=(g,)), a, b)
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
