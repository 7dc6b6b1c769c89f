"""Fused precision-refined GEMM on the Hopper tensor cores
(``csrc/gemm_refined.cu``).

Replaces the TPU kernel ``repro/kernels/gemm_refined.py:_refined_kernel``
(``pallas_call`` at ``gemm_refined.py:113``): the paper's Eq. 2-3 in one
kernel.  Each operand tile is split into bf16 hi/lo on its way into
shared memory and the policy's passes run on the staged terms — 2 for
refine_a (a_lo.b_hi + a_hi.b_hi), 3 for bf16x3 (+ a_hi.b_lo), 4 for
refine_ab (+ a_lo.b_lo) — the small terms in their own f32 accumulator,
added before the leading term.

What bounds it on the H100: on the serve path it runs the unembed at
``logits="refine_ab"``, 4 x 1152 against the 262144 x 1152 f32 table,
so the 1.2 GB table read bounds it (4 passes of 4 rows are little
tensor-core work).  The design reads the f32 table once, in place, as
an NT view (no transposed or padded copy, no bf16 hi/lo copies in
device memory: the split happens in registers), with the same tiles and
register double buffering as ``gemm_tiled``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import precision as prec
from repro_torch.kernels import _build
from repro_torch.kernels.gemm_tiled import (GEMM_ARGTYPES, check_operands,
                                            launch_gemm, on_cpu)

__all__ = ["gemm_refined", "gemm_refined_plain", "LAUNCHES", "POLICY_CODES"]

LAUNCHES = 0

POLICY_CODES = {"refine_a": 1, "bf16x3": 2, "refine_ab": 3}


def gemm_refined_plain(a: torch.Tensor, b: torch.Tensor,
                       policy: str = "refine_ab") -> torch.Tensor:
    """The same function in plain PyTorch: the policy's bf16 terms,
    upcast, multiplied in f32 and summed smallest first."""
    if policy not in POLICY_CODES:
        raise ValueError(f"policy {policy!r} not in {sorted(POLICY_CODES)}")
    a_terms, b_terms = prec.operand_terms(a, b, policy)
    out = None
    for ta, tb in prec.policy_terms(policy):
        part = torch.matmul(a_terms[ta].float(), b_terms[tb].float())
        out = part if out is None else out + part
    return out


@functools.cache
def _launcher():
    fn = _build.load("gemm_refined").gemm_refined_launch
    fn.argtypes = [*GEMM_ARGTYPES, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def gemm_refined(a: torch.Tensor, b: torch.Tensor, *,
                 policy: str = "refine_ab") -> torch.Tensor:
    """Fused refined C = A @ B (refine_a / bf16x3 / refine_ab), f32 out.

    Shapes and strides as ``gemm_tiled``.  CPU tensors run
    ``gemm_refined_plain``; CUDA tensors launch the kernel or raise.
    """
    global LAUNCHES
    if policy not in POLICY_CODES:
        raise ValueError(f"policy {policy!r} not in {sorted(POLICY_CODES)}")
    check_operands(a, b)
    if on_cpu(a, b):
        return gemm_refined_plain(a, b, policy)
    out = launch_gemm(_launcher(), a, b, POLICY_CODES[policy])
    LAUNCHES += 1
    return out
