"""Precision splitting & policy (twin of ``repro.core.precision``).

The paper (Markidis et al., IPDPSW'18, Eq. 1-3) recovers fp32 accuracy
from a narrow-precision matrix unit by carrying the rounding residual as
a second narrow operand:

    R_A = A_single - A_half                                   (Eq. 1)
    A B ~= R_A B_h + A_h B_h                                  (Eq. 2)
    A B ~= R_A R_B + A_h R_B + R_A B_h + A_h B_h              (Eq. 3)

The narrow type is bfloat16 (the tensor cores' bf16 inputs, f32
accumulators), so each split recovers 8 mantissa bits.  The ladder:

    f32      exact                         1 pass
    bf16     plain mixed precision         1 pass
    refine_a Eq. 2, split A only           2 passes
    bf16x3   Eq. 3 minus R_A R_B           3 passes
    refine_ab Eq. 3 exactly                4 passes
    bf16x6   3-way split, 2nd-order terms  6 passes

and below bf16 the quantized rungs (fp8 e4m3 / int8 under a per-tensor
power-of-two scale, 1 pass; the error-corrected ``x3`` variants, 3
passes).  Every split and quantized term is bit-equal to the JAX
package's on the CPU: ``Tensor.to(torch.bfloat16)`` rounds to nearest
even like ``astype(bfloat16)``, and ``torch.round`` rounds half to even
like ``jnp.round``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

import torch

__all__ = [
    "POLICIES",
    "QUANT_FORMATS",
    "tile_terms",
    "PrecisionPolicy",
    "num_passes",
    "quant_format",
    "quantize_pow2",
    "qdq",
    "qdq_split2",
    "split2",
    "split3",
    "merge2",
    "policy_terms",
    "split_for_policy",
    "operand_terms",
]

POLICIES: tuple[str, ...] = (
    "fp8",
    "int8",
    "fp8x3",
    "int8x3",
    "bf16",
    "refine_a",
    "bf16x3",
    "refine_ab",
    "bf16x6",
    "f32",
)

_PASSES = {
    "fp8": 1,
    "int8": 1,
    "fp8x3": 3,
    "int8x3": 3,
    "bf16": 1,
    "refine_a": 2,
    "bf16x3": 3,
    "refine_ab": 4,
    "bf16x6": 6,
    "f32": 1,
}


def num_passes(policy: str) -> int:
    """Number of narrow-precision tensor-core passes the policy costs."""
    if policy not in _PASSES:
        raise ValueError(f"unknown precision policy {policy!r}; one of {POLICIES}")
    return _PASSES[policy]


def split2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` into (hi, lo) bf16 with ``hi + lo ~= x`` (Eq. 1)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split ``x`` into (hi, mid, lo) bf16 carrying ~the full 24 bits."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def merge2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Reconstruct fp32 from a (hi, lo) split."""
    return hi.float() + lo.float()


# ===================================================== quantized down-rungs

# Storage dtype and the largest magnitude the scale maps onto (e4m3 keeps
# a binade of headroom, as in the JAX package).
QUANT_FORMATS: dict[str, tuple[torch.dtype, float]] = {
    "fp8": (torch.float8_e4m3fn, 224.0),
    "int8": (torch.int8, 127.0),
}


def quant_format(policy: str) -> str:
    """The quantized storage format ("fp8"/"int8") behind a down-rung."""
    base = policy[:-2] if policy.endswith("x3") else policy
    if base not in QUANT_FORMATS:
        raise ValueError(f"policy {policy!r} is not a quantized rung")
    return base


_LN2 = math.log(2.0)


def _pow2_scale(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """Power-of-two ``s`` with ``qmax * s >= max|x|`` (scalar).

    The JAX package's ``exp2`` evaluates as ``exp(e * ln 2)`` in f32 on
    XLA:CPU, which can land an ulp off the exact power of two (e.g. for
    2**-17); the port computes it the same way so the scale, and every
    quantized term, stays bit-equal to the reference.
    """
    amax = x.float().abs().max()
    amax = torch.clamp(amax, min=1e-30)
    e = torch.ceil(torch.log2(amax / qmax))
    return torch.exp(e * e.new_full((), _LN2))


def quantize_pow2(x: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to ``(q, scale)`` with a per-tensor pow2 scale."""
    dtype, qmax = QUANT_FORMATS[fmt]
    x = x.float()
    s = _pow2_scale(x, qmax)
    y = x / s
    if fmt == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(dtype)
    else:
        q = y.to(dtype)
    return q, s


class _QDQ(torch.autograd.Function):
    """Quantize-dequantize with a straight-through gradient (the twin of
    the JAX ``custom_jvp``): the tangent passes through as bf16."""

    @staticmethod
    def forward(ctx, x, fmt):
        q, s = quantize_pow2(x, fmt)
        return (q.float() * s).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16), None


def qdq(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Quantize-dequantize ``x`` through ``fmt``; returns exact bf16."""
    return _QDQ.apply(x, fmt)


def qdq_split2(x: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (qdq(x), qdq(x - hi)): the error-corrected x3 split."""
    x = x.float()
    hi = qdq(x, fmt)
    lo = qdq(x - hi.float(), fmt)
    return hi, lo


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-layer-family precision policy for every matmul in a model."""

    default: str = "bf16"
    attention: str | None = None  # q/k/v/o projections + attn logits
    mlp: str | None = None        # dense FFN matmuls
    moe: str | None = None        # expert einsums
    logits: str | None = None     # final vocab projection
    embed: str | None = None      # embedding lookups / patch projections

    _PRECISION_FIELDS = ("default", "attention", "mlp", "moe", "logits",
                         "embed")

    def __post_init__(self) -> None:
        for name in self._PRECISION_FIELDS:
            v = getattr(self, name)
            if v is not None and v not in POLICIES:
                raise ValueError(
                    f"{type(self).__name__}.{name}={v!r} not in {POLICIES}")

    def for_(self, family: str) -> str:
        v = getattr(self, family, None)
        return v if v is not None else self.default

    @classmethod
    def uniform(cls, policy: str) -> PrecisionPolicy:
        return cls(default=policy)

    @classmethod
    def mixed_hpc(cls) -> PrecisionPolicy:
        """The paper's HPC recommendation: refine where error accumulates."""
        return cls(default="bf16", logits="bf16x3", attention="refine_a")


def policy_terms(policy: str) -> Sequence[tuple[int, int]]:
    """(a_term, b_term) index pairs each policy multiplies, smallest
    magnitude first (index 0 = hi, 1 = lo or mid, 2 = lo of split3)."""
    if policy in ("bf16", "fp8", "int8"):
        return ((0, 0),)
    if policy in ("fp8x3", "int8x3"):
        return ((1, 0), (0, 1), (0, 0))
    if policy == "refine_a":
        return ((1, 0), (0, 0))
    if policy == "bf16x3":
        return ((1, 0), (0, 1), (0, 0))
    if policy == "refine_ab":
        return ((1, 1), (1, 0), (0, 1), (0, 0))
    if policy == "bf16x6":
        return ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
    raise ValueError(f"policy {policy!r} has no term decomposition")


def split_for_policy(x: torch.Tensor, policy: str) -> tuple[torch.Tensor, ...]:
    """Operand splits required by ``policy`` (1-, 2- or 3-way)."""
    if policy == "bf16":
        return (x.to(torch.bfloat16),)
    if policy in ("fp8", "int8"):
        return (qdq(x, policy),)
    if policy in ("fp8x3", "int8x3"):
        return qdq_split2(x, quant_format(policy))
    if policy in ("refine_a", "bf16x3", "refine_ab"):
        return split2(x)
    if policy == "bf16x6":
        return split3(x)
    raise ValueError(f"policy {policy!r} has no split")


def tile_terms(x: torch.Tensor, policy: str, tile: Sequence[int]) -> tuple[torch.Tensor, ...]:
    """``split_for_policy`` with the quantized rungs' pow2 scales taken per
    tile, as a kernel takes them over each tile it stages: ``tile[d]`` is
    the extent of a tile along dim d (0: the whole dim), tiles starting at
    index 0; the other rungs split elementwise.  A per-tensor ``qdq`` is
    the case of one tile (every extent 0)."""
    if policy not in ("fp8", "int8", "fp8x3", "int8x3"):
        return split_for_policy(x, policy)
    fmt = quant_format(policy)
    dtype, qmax = QUANT_FORMATS[fmt]
    x = x.float()
    pads, blocked = [], []
    for n, t in zip(x.shape, tile):
        t = t or max(n, 1)
        pads.append((-n) % t)
        blocked += [(n + pads[-1]) // t, t]
    xp = torch.nn.functional.pad(x, [v for p in reversed(pads) for v in (0, p)])
    xb = xp.reshape(blocked)
    inner = tuple(range(1, 2 * x.dim(), 2))

    def one(v):
        amax = torch.clamp(v.abs().amax(dim=inner, keepdim=True), min=1e-30)
        e = torch.ceil(torch.log2(amax / qmax))
        sc = torch.exp(e * e.new_full((), _LN2))
        y = v / sc
        q = torch.clamp(torch.round(y), -qmax, qmax).to(dtype) if fmt == "int8" else y.to(dtype)
        return (q.float() * sc).to(torch.bfloat16)

    terms = [one(xb)]
    if policy.endswith("x3"):
        terms.append(one(xb - terms[0].float()))
    crop = tuple(slice(0, n) for n in x.shape)
    return tuple(t.reshape(xp.shape)[crop] for t in terms)


def operand_terms(a: torch.Tensor, b: torch.Tensor, policy: str,
                  ) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Both operands' narrow terms; ``bf16``/``refine_a`` never split B."""
    a_terms = split_for_policy(a, policy)
    b_terms = ((b.to(torch.bfloat16),) if policy in ("bf16", "refine_a")
               else split_for_policy(b, policy))
    return a_terms, b_terms
