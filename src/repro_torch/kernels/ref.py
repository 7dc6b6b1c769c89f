"""Plain PyTorch oracles for the port's kernels (twin of
``repro.kernels.ref``), for the tests and ``chip_smoke.py``.

They follow the kernels' accumulation semantics (bf16 inputs, f32
accumulation), so a comparison is exact up to the order of f32 sums,
not up to precision.  ``wkv6_ref`` is the exact O(S) sequential
recurrence, independent of any chunking.
"""

from __future__ import annotations

import torch

from repro_torch.core import precision as prec

__all__ = [
    "gemm_mixed_ref",
    "gemm_refined_ref",
    "batched_gemm_ref",
    "wkv6_ref",
    "batched_gemm_packed_ref",
]


def gemm_mixed_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A@B with bf16 inputs and f32 accumulation (one pass)."""
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def gemm_refined_ref(a: torch.Tensor, b: torch.Tensor, policy: str = "refine_ab",
                     ) -> torch.Tensor:
    """Multi-pass refined GEMM (the paper's Eq. 2/3 ladder), unfused."""
    a_terms = prec.split_for_policy(a, policy)
    if policy in ("bf16", "refine_a"):
        b_terms: tuple[torch.Tensor, ...] = (b.to(torch.bfloat16),)
    else:
        b_terms = prec.split_for_policy(b, policy)
    out = None
    for ta, tb in prec.policy_terms(policy):
        part = torch.matmul(a_terms[ta].float(), b_terms[tb].float())
        out = part if out is None else out + part
    return out


def batched_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, n, k) x (G, k, m) -> (G, n, m), bf16 in, f32 accumulate."""
    return torch.bmm(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
             u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact O(S) sequential WKV6 recurrence (oracle for kernels/wkv6).

    r/k/v/logw: (B, S, H, K); u: (H, K).  Per head:
        out_t = r_t . (S + u (.) k_t v_t^T);  S' = diag(e^logw_t) S + k_t v_t^T
    Returns (out (B, S, H, K) f32, final state (B, H, K, K) f32).
    """
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    b, s, h, kd = r.shape
    state = torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B, H, K, K)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                                 (state + u[None, :, :, None] * kv).float()))
        state = state * torch.exp(logw[:, t])[..., None] + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, state


def batched_gemm_packed_ref(a: torch.Tensor, b: torch.Tensor, pack: int) -> torch.Tensor:
    """Oracle for the packed batched kernel: packing ``pack`` small
    products changes nothing numerically (each is its own diagonal
    block), so it is ``batched_gemm_ref``; ``pack`` mirrors the kernel's
    signature."""
    del pack
    return batched_gemm_ref(a, b)
