"""Fused precision-refined GEMM on the Hopper tensor cores
(``csrc/gemm_refined.cu``).

Replaces the TPU kernel ``repro/kernels/gemm_refined.py:_refined_kernel``
(``pallas_call`` at ``gemm_refined.py:113``): the paper's Eq. 2-3 in one
kernel.  Each operand is split into bf16 hi = bf16(x) and lo = bf16(x -
hi) inside the kernel and the policy's terms run on the tensor cores --
refine_a a_lo.b_hi + a_hi.b_hi, bf16x3 + a_hi.b_lo, refine_ab + a_lo.b_lo
-- the small terms (``core/precision.py:policy_terms`` order) issued before
the leading term.  A bf16 operand's lo is
identically zero, so the kernel skips every term that reads it
(``kept_terms``): refine_ab on a bf16 A (the forward, dTable, the decode
unembed) runs 2 terms, not 4, with the same result.

What bounds it on the H100, and the design, by regime:
  M > 16   training's unembed (2048 x 1152 against the 262144 x 1152 f32
           table: the forward, dX = g.table, dTable = x^T.g) is bounded by
           tensor-core work, 2-4 bf16 passes of 0.62 TFLOP (2.5-5.0 ms at
           989 TFLOP/s).  The refined wgmma mainloop
           (``csrc/gemm_refined_sm90.cuh``): a producer warpgroup fills a
           ring of 128-byte swizzled planes (a bf16 operand's hi by TMA, an
           f32 operand's hi and lo converted from one read of each
           element), two consumer warpgroups issue ``wgmma`` m64n128k16 per
           kept term into one accumulator, added into an f32 total every
           16 ``wgmma`` (the tensor cores' own accumulation loses
           precision with K).  Where the 128 x 128 tiles
           leave most SMs idle in a last wave (dX: 144 tiles on 132 SMs) the
           host splits K into whole waves (``gemm_tiled.sm90_splits``) and
           the last CTA of a tile sums the f32 partials in split order.
  M <= 16  decode's unembed (4 x 1152 against the f32 table) is a weight
           stream, bounded by the table's 1.2 GB.  The split-K weight stream
           of ``gemm_tiled`` (``csrc/gemm_splitk.cuh``), its fragments split
           into hi and lo from shared memory and a second accumulator for
           the small terms; its split count is ``splitk_splits`` (the same
           staging and CTAs an SM).
Both read f32 operands in place through their strides (no hi/lo or padded
copy in device memory) and mask the ragged edges.  ``LAUNCHES_BY_LOOP``
counts which mainloop each launch ran (``sm90`` above M = 16, ``splitk`` at
or below; ``wmma``, the WMMA tile of earlier versions, never).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import precision as prec
from repro_torch.kernels import _build, _trace
from repro_torch.kernels.gemm_tiled import (GEMM_ARGTYPES, MAINLOOPS, SM90_BK, SPLIT_ARGTYPES,
                                            SPLITK_BK, check_operands, gemm_dims, gemm_outputs,
                                            launch_gemm, on_cpu, sm90_splits, sm90_workspace,
                                            sm_count, split_ranges, split_site_fields,
                                            split_workspace, splitk_splits)

__all__ = ["gemm_refined", "gemm_refined_plain", "gemm_refined_splitk_plain", "kept_terms",
           "refined_splits", "LAUNCHES", "LAUNCHES_BY_LOOP", "POLICY_CODES"]

LAUNCHES = 0
LAUNCHES_BY_LOOP = dict.fromkeys(MAINLOOPS, 0)

POLICY_CODES = {"refine_a": 1, "bf16x3": 2, "refine_ab": 3}


def _check_policy(policy: str) -> None:
    if policy not in POLICY_CODES:
        raise ValueError(f"policy {policy!r} not in {sorted(POLICY_CODES)}")


@_trace.plain_twin
def gemm_refined_plain(a: torch.Tensor, b: torch.Tensor,
                       policy: str = "refine_ab") -> torch.Tensor:
    """The same function in plain PyTorch: the policy's bf16 terms,
    upcast, multiplied in f32 and summed smallest first."""
    _check_policy(policy)
    a_terms, b_terms = prec.operand_terms(a, b, policy)
    out = None
    for ta, tb in prec.policy_terms(policy):
        part = torch.matmul(a_terms[ta].float(), b_terms[tb].float())
        out = part if out is None else out + part
    return out


def kept_terms(policy: str, a_bf16: bool, b_bf16: bool) -> tuple[tuple[int, int], ...]:
    """The policy's (a_term, b_term) pairs, in ``policy_terms`` order, that
    the kernels multiply: every pair but those that read a bf16 operand's
    lo (term 1), which is identically zero (the term set of
    ``csrc/common.cuh:term_set``)."""
    _check_policy(policy)
    return tuple((ta, tb) for ta, tb in prec.policy_terms(policy)
                 if not (ta and a_bf16) and not (tb and b_bf16))


def gemm_refined_splitk_plain(a: torch.Tensor, b: torch.Tensor, policy: str,
                              splits: int) -> torch.Tensor:
    """The split kernels' sum in plain PyTorch: each split's terms over its
    64-deep K tiles (``split_ranges``), small terms first, then the leading
    one, the partials added in split order (the last CTA's reduction).  At
    ``splits=1`` it is ``gemm_refined_plain``."""
    out = None
    for lo, hi in split_ranges(-(-a.shape[-1] // SPLITK_BK), splits):
        ks = slice(lo * SPLITK_BK, hi * SPLITK_BK)
        part = gemm_refined_plain(a[..., ks], b[..., ks, :], policy)
        out = part if out is None else out + part
    return out


def refined_splits(batch: int, m: int, n: int, k: int, sms: int) -> int:
    """The K splits of a launch: ``splitk_splits`` at M <= 16 (the weight
    stream), ``sm90_splits`` above (the wgmma mainloop)."""
    return (splitk_splits if m <= 16 else sm90_splits)(batch, m, n, k, sms)


def _site(a: torch.Tensor, b: torch.Tensor, policy: str) -> _trace.KernelSite:
    batch, m, n, k = gemm_dims(a, b)
    splits = refined_splits(batch, m, n, k, _trace.AUDIT_SMS)
    return _trace.KernelSite(
        kernel="gemm_refined", entry="gemm_refined_launch",
        mainloop="splitk" if m <= 16 else "sm90", policy=policy,
        terms=len(prec.policy_terms(policy)), contractions=1, outputs=gemm_outputs(a, b),
        **split_site_fields(-(-k // (SPLITK_BK if m <= 16 else SM90_BK)), splits))


@functools.cache
def _launcher():
    fn = _build.load("gemm_refined").gemm_refined_launch
    fn.argtypes = [*GEMM_ARGTYPES, ctypes.c_int, *SPLIT_ARGTYPES, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def gemm_refined(a: torch.Tensor, b: torch.Tensor, *,
                 policy: str = "refine_ab") -> torch.Tensor:
    """Fused refined C = A @ B (refine_a / bf16x3 / refine_ab), f32 out.

    Shapes and strides as ``gemm_tiled``.  CPU tensors run
    ``gemm_refined_plain``; CUDA tensors launch the kernel or raise.
    """
    global LAUNCHES
    _check_policy(policy)
    check_operands(a, b)
    if _trace.ACTIVE:
        return _trace.launch(_site(a, b, policy), a, b)
    if on_cpu(a, b):
        return gemm_refined_plain(a, b, policy)
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    m = a.shape[-2]
    splits = refined_splits(a.shape[0] if a.dim() == 3 else 1, m, b.shape[-1], a.shape[-1],
                            sm_count(index))
    if m <= 16:
        ws = split_workspace(index, stream)
    else:
        ws = sm90_workspace(index, stream) if splits > 1 else (None, 0, None, 0)
    loop = ctypes.c_int(-1)
    out = launch_gemm(_launcher(), a, b, POLICY_CODES[policy], splits, *ws, ctypes.byref(loop),
                      stream=stream)
    LAUNCHES += 1
    if loop.value >= 0:
        LAUNCHES_BY_LOOP[MAINLOOPS[loop.value]] += 1
    return out
