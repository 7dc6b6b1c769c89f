"""Policy-routed matmuls (twin of ``repro.core.refined_matmul``).

``peinsum`` is the single entry point every model matmul goes through: a
thin router over the op registry.  ``policy`` is a precision string
(the ``torch`` reference path) or a ``Route`` /
``ExecutionPolicy.for_(family)`` whose ``backends`` mapping selects the
GEMM impl (``cuda`` runs the hand-written kernels).
"""

from __future__ import annotations

import torch

from repro_torch.core import ops

__all__ = ["peinsum", "pmatmul", "refined_matmul"]


def peinsum(spec: str, a: torch.Tensor, b: torch.Tensor,
            policy: str | ops.Route = "bf16") -> torch.Tensor:
    """Two-operand einsum computed under a precision policy / route; f32 out."""
    return ops.routed_einsum(spec, a, b, policy)


def pmatmul(a: torch.Tensor, b: torch.Tensor,
            policy: str | ops.Route = "bf16") -> torch.Tensor:
    """Policy-routed ``a @ b`` (contract last dim of a with first of b)."""
    if a.dim() < 1 or b.dim() != 2:
        raise ValueError(f"pmatmul expects (..., k) x (k, n); got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    return peinsum("...k,kn->...n", a, b, policy)


def refined_matmul(a: torch.Tensor, b: torch.Tensor,
                   policy: str | ops.Route = "refine_ab",
                   *, backend: str | None = None) -> torch.Tensor:
    """Paper-shaped 2-D GEMM under a policy; ``backend`` overrides the
    route's GEMM impl."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("refined_matmul is the 2-D GEMM entry point")
    if backend is not None:
        return ops.gemm(a, b, policy=policy, backend=backend)
    return peinsum("mk,kn->mn", a, b, policy)
