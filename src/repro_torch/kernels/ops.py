"""Dispatch over the port's batched GEMM kernels (twin of
``repro.kernels.ops``).

Backends mirror the paper's three programming surfaces:

  backend="torch"       -> the vendor path (cuBLAS; the twin of ``xla``)
  backend="cuda"        -> the staged, packed kernel (the CUTLASS column;
                           ``pallas``)
  backend="cuda_naive"  -> the unstaged per-warp kernel (raw WMMA;
                           ``pallas_naive``)

``gemm_batched`` (the paper's Fig. 7 many-small-GEMM path) has no
registry family and is the entry point of the batched kernels.  The JAX
module's deprecated ``gemm`` shim has no twin here: the port has no
legacy callers, and a policy-routed GEMM is ``repro_torch.core.ops.gemm``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.batched_gemm import (PACK_TILE, PACKED_N, batched_gemm,
                                              batched_gemm_naive, check_batched)
from repro_torch.kernels.ref import batched_gemm_ref

__all__ = ["gemm_batched"]


def gemm_batched(a: torch.Tensor, b: torch.Tensor, *, backend: str = "cuda") -> torch.Tensor:
    """Batched (G, n, n) small GEMMs, bf16 operands, f32 out.

    ``cuda`` packs ``PACK_TILE // n`` matrices per CTA and pads G to that
    multiple; the divisors of the tile the packed kernel is not built for
    (``n`` in 1, 2, 4, 128) run the naive kernel (one warp per matrix, any
    n), and an ``n`` that does not divide the tile raises, as in the JAX
    package; ``n > PACK_TILE`` leaves nothing to pack and goes to
    ``torch``, as the JAX package sends it to ``xla``.  ``cuda_naive``
    runs one warp per matrix; ``torch`` is one ``bmm`` of the bf16-rounded
    operands (TF32 is off on the card)."""
    g, n = check_batched(a, b)
    if backend == "torch":
        return batched_gemm_ref(a, b)
    if backend == "cuda_naive":
        return batched_gemm_naive(a, b)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    pack = PACK_TILE // n
    if pack == 0:
        # n > PACK_TILE: the packing kernel is built for MANY small problems
        return gemm_batched(a, b, backend="torch")
    if PACK_TILE % n:
        raise ValueError(f"n={n} must divide the packing tile={PACK_TILE}")
    if n not in PACKED_N:
        return batched_gemm_naive(a, b)
    pad = (-g) % pack
    if pad:
        a = torch.cat([a, a.new_zeros((pad, n, n))])
        b = torch.cat([b, b.new_zeros((pad, n, n))])
    return batched_gemm(a, b)[:g]
