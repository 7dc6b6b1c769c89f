"""The GEMM family (twin of ``repro.core.ops.gemm``): 2-D-reducible
einsums over registered GEMM impls.

  ``torch``  the reference: policy-decomposed chains of f32 einsums on
             the bf16-rounded terms (the paper's cuBLAS column; the
             twin of ``xla``).  Parity oracle and fallback target.
  ``cuda``   the hand-written Hopper kernels (the twin of ``pallas``):
             ``gemm_tiled`` for bf16, the fused ``gemm_refined`` for
             refine_a / bf16x3 / refine_ab, and ``gemm_lowp`` for fp8 /
             int8 / fp8x3 / int8x3 with per-tile scales on ``repro``'s
             quantization grid (``tiles.tile_for``).
  ``cuda_naive``  the paper's unstaged Listing-1 kernel, ``gemm_naive``
             (the twin of ``pallas_naive``): bf16 only; every other
             rung runs as bf16 passes through it, f32 on the reference.

The router (``routed_einsum``) lowers a two-operand spec to one
(batched) 2-D GEMM by permuting and reshaping (views where possible),
runs f32 on the reference (no narrow-pass decomposition exists for it),
and decomposes every rung an impl does not fuse into bf16 passes through
that impl, summed smallest first (bf16x6 on ``cuda``; the fp8/int8 rungs
on ``torch``, with one power-of-two scale per tensor).  Specs that are not 2-D-reducible go to the reference.
Gradients of a lowered einsum run through the same route (``_LoweredEinsum``,
the twin of ``_lowered_einsum``): dA and dB are two more routed einsums,
at the route's precision on the route's impl, so a model trains on the
kernels it serves on (over a mesh dA is sharded as the forward is, and dB
is computed whole on every rank: see ``_LoweredEinsum.backward``).  Their transposed operands reach the kernels as
views: ``dW = x^T.g`` has an M-contiguous A, ``dX = g.W^T`` a K-major B.
"""

from __future__ import annotations

import dataclasses
import functools
import string

import numpy as np
import torch

from repro_torch.core import precision as prec
from repro_torch.core.ops import registry, shard
from repro_torch.core.ops.registry import (LADDER_BOUNDS, OpSpec, Partitioning,
                                           register_family, register_impl)
from repro_torch.core.ops.route import Route, as_route
from repro_torch.core.ops.tiles import tile_for
from repro_torch.kernels.gemm_lowp import LOWP_POLICIES, gemm_lowp
from repro_torch.kernels.gemm_naive import gemm_naive
from repro_torch.kernels.gemm_refined import gemm_refined
from repro_torch.kernels.gemm_tiled import gemm_tiled

__all__ = ["routed_einsum", "gemm", "torch_policy_einsum"]


def _make_problem(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.uniform(-1, 1, (48, 132)).astype(np.float32)),
        "b": torch.from_numpy(rng.uniform(-1, 1, (132, 40)).astype(np.float32)),
    }


def _oracle(problem: dict) -> np.ndarray:
    return (problem["a"].double() @ problem["b"].double()).numpy()


register_family(OpSpec(
    family="gemm",
    contract="fn(a (..., m, k), b (..., k, n), *, policy) -> f32 "
             "(..., m, n); at most one leading batch dim",
    reference="torch",
    label="backend",
    layer_families=(),
    make_problem=_make_problem,
    run=lambda problem, route: gemm(problem["a"], problem["b"], policy=route),
    oracle=_oracle,
    error_bound=lambda policy: LADDER_BOUNDS[policy],
    grad_args=("a",),
    audit_meshes=("tp=3", "dp=2,tp=2"),
))


# --------------------------------------------------------- torch reference

def torch_policy_einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
                        policy: str) -> torch.Tensor:
    """The vendor-path einsum: 1..6 chained f32 einsums per the policy.

    Each pass multiplies two bf16-rounded terms upcast to f32 (products of
    bf16 values are exact in f32, and f32 accumulation is what the tensor
    cores do), summed smallest-magnitude first.
    """
    if policy == "f32":
        return torch.einsum(spec, a.float(), b.float())
    a_terms, b_terms = prec.operand_terms(a, b, policy)
    out = None
    for ta, tb in prec.policy_terms(policy):
        part = torch.einsum(spec, a_terms[ta].float(), b_terms[tb].float())
        out = part if out is None else out + part
    return out


# Canonical TP scheme: column-parallel (b's n dim sharded; each output
# column whole on one rank -- bit-equal); the shard builder switches to
# row-parallel (k split + f32 all-reduce) when only k divides.
_GEMM_PARTITIONING = Partitioning(
    specs=(("a", ("dp", None)), ("b", (None, "tp")), ("out", ("dp", "tp"))),
    collectives=("psum_f32:tp",),
)


@register_impl("gemm", "torch", fused_policies=prec.POLICIES, features=("vjp",),
               partitioning=_GEMM_PARTITIONING)
def _torch_gemm(a, b, *, policy):
    return torch_policy_einsum("...mk,...kn->...mn", a, b, policy)


# The kernels read operands through their strides, mask ragged edges and
# pick their own tiles, so the router hands them views: the unembed's
# transposed 262144 x 1152 table is never copied or padded.  The quantized
# rungs take repro's quantization grid, TileConfig(256, 256, 256) clamped
# to the problem, as its router picks it for the pallas impl; the kernel
# masks the ragged tile where repro pads it with zeros.
@register_impl("gemm", "cuda",
               fused_policies=("fp8", "int8", "fp8x3", "int8x3",
                               "bf16", "refine_a", "bf16x3", "refine_ab"),
               features=("vjp",), partitioning=_GEMM_PARTITIONING)
def _cuda_gemm(a, b, *, policy):
    if policy == "bf16":
        return gemm_tiled(a, b)
    if policy in LOWP_POLICIES:
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        t = tile_for("cuda", m, n, k).clamp(m, n, k)
        return gemm_lowp(a, b, policy=policy, bm=t.bm, bn=t.bn, bk=t.bk)
    return gemm_refined(a, b, policy=policy)


# The paper's Fig. 6 "WMMA without shared memory" column: the refine_ab
# unembed on this impl is four naive bf16 passes summed at the router.
# Its wrapper pads every operand to 16-multiples (the WMMA fragment), the
# one port GEMM whose kernel takes only tile-divisible shapes.  It declares
# no Partitioning (as ``pallas_naive``), so a mesh route rejects it.
@register_impl("gemm", "cuda_naive", fused_policies=("bf16",), features=("vjp",),
               pads_to_tiles=True)
def _cuda_naive_gemm(a, b, *, policy):
    assert policy == "bf16", policy
    return gemm_naive(a, b)


# ============================================================ einsum router

@dataclasses.dataclass(frozen=True)
class _Plan:
    """Static lowering recipe: einsum spec -> (batched) 2-D GEMM."""

    a_perm: tuple[int, ...]      # a -> (batch..., m..., k...)
    b_perm: tuple[int, ...]      # b -> (batch..., k..., n...)
    batch: int                   # product of batch dims (0 = unbatched)
    m: int
    n: int
    k: int
    out_shape: tuple[int, ...]   # (batch..., m..., n...) before out_perm
    out_perm: tuple[int, ...]    # -> the spec's requested output order


def _expand_ellipsis(spec: str, a_ndim: int, b_ndim: int) -> str | None:
    """Concretize '...' with fresh labels (on at most one operand)."""
    if "..." not in spec:
        return spec
    lhs, out = spec.split("->")
    a_spec, b_spec = lhs.split(",")
    if "..." in a_spec and "..." in b_spec:
        return None
    used = set(spec) - {".", ",", "-", ">"}
    fresh = [c for c in string.ascii_letters if c not in used]
    if "..." in a_spec:
        n_extra = a_ndim - (len(a_spec) - 3)
    else:
        n_extra = b_ndim - (len(b_spec) - 3)
    if n_extra < 0 or n_extra > len(fresh):
        return None
    ell = "".join(fresh[:n_extra])
    return (f"{a_spec.replace('...', ell)},{b_spec.replace('...', ell)}"
            f"->{out.replace('...', ell)}")


@functools.lru_cache(maxsize=512)
def _plan_2d(spec: str, a_shape: tuple[int, ...], b_shape: tuple[int, ...],
             ) -> _Plan | None:
    """Classify a concrete two-operand spec as a (batched) 2-D GEMM, or
    None when it is not transpose+reshape around one GEMM."""
    spec = _expand_ellipsis(spec, len(a_shape), len(b_shape))
    if spec is None or "->" not in spec:
        return None
    lhs, out = spec.split("->")
    if "," not in lhs:
        return None
    a_l, b_l = lhs.split(",")
    if (len(set(a_l)) != len(a_l) or len(set(b_l)) != len(b_l)
            or len(set(out)) != len(out)):
        return None
    if len(a_l) != len(a_shape) or len(b_l) != len(b_shape):
        return None
    a_set, b_set, o_set = set(a_l), set(b_l), set(out)
    if not o_set <= (a_set | b_set):
        return None
    dim = {}
    for labels, shape in ((a_l, a_shape), (b_l, b_shape)):
        for lab, d in zip(labels, shape):
            if dim.setdefault(lab, d) != d:
                return None
    shared = a_set & b_set
    k_labs = [c for c in a_l if c in shared and c not in o_set]
    batch_labs = [c for c in out if c in shared]
    m_labs = [c for c in a_l if c in a_set - b_set]
    n_labs = [c for c in b_l if c in b_set - a_set]
    if not k_labs:
        return None
    if any(c not in o_set for c in m_labs + n_labs):
        return None
    a_perm = tuple(a_l.index(c) for c in batch_labs + m_labs + k_labs)
    b_perm = tuple(b_l.index(c) for c in batch_labs + k_labs + n_labs)

    def prod(labs):
        return int(np.prod([dim[c] for c in labs], dtype=np.int64))

    pre_out = batch_labs + m_labs + n_labs
    return _Plan(
        a_perm=a_perm, b_perm=b_perm,
        batch=prod(batch_labs) if batch_labs else 0,
        m=prod(m_labs), n=prod(n_labs), k=prod(k_labs),
        out_shape=tuple(dim[c] for c in pre_out),
        out_perm=tuple(pre_out.index(c) for c in out))


def _impl_gemm_2d(impl: registry.KernelImpl, a: torch.Tensor, b: torch.Tensor,
                  route: Route) -> torch.Tensor:
    """One policy-routed 2-D GEMM on an arbitrary-shape problem; a leading
    batch dim (a batched plan) passes through to the impl, which launches
    once with a batch stride where the JAX router vmaps."""
    caps = impl.capabilities
    precision = route.precision
    if precision == "f32" and "f32" not in caps.fused_policies:
        # no narrow-pass decomposition exists for exact f32: reference path
        return torch_policy_einsum("...mk,...kn->...mn", a, b, "f32")

    if precision in caps.fused_policies:
        out = impl.fn(a, b, policy=precision)
    else:
        # Paper Fig. 5: refinement as chained narrow GEMMs through the
        # requested impl, summed smallest first.
        a_terms, b_terms = prec.operand_terms(a, b, precision)
        out = None
        for ta, tb in prec.policy_terms(precision):
            part = impl.fn(a_terms[ta], b_terms[tb], policy="bf16")
            out = part if out is None else out + part
    return out


def _execute_plan(plan: _Plan, a: torch.Tensor, b: torch.Tensor,
                  route: Route) -> torch.Tensor:
    impl = registry.get_impl("gemm", route.impl("gemm"))
    at = a.permute(plan.a_perm)
    bt = b.permute(plan.b_perm)
    if plan.batch:
        # batched contractions run unsharded, as in repro (the big weight
        # matmuls are unbatched)
        at = at.reshape(plan.batch, plan.m, plan.k)
        bt = bt.reshape(plan.batch, plan.k, plan.n)
        out = _impl_gemm_2d(impl, at, bt, shard.unsharded_route(route))
    else:
        at = at.reshape(plan.m, plan.k)
        bt = bt.reshape(plan.k, plan.n)
        if shard.active_mesh(route.mesh) is not None and impl.capabilities.partitioning:
            out = shard.sharded_gemm_2d(impl, at, bt, route)
        else:
            out = _impl_gemm_2d(impl, at, bt, route)
    return out.reshape(plan.out_shape).permute(plan.out_perm)


class _LoweredEinsum(torch.autograd.Function):
    """A lowered einsum whose backward contractions run the same route.
    For a two-operand spec with unique labels, dA = einsum(out, b -> a)
    and dB = einsum(a, out -> b); autograd through the impl would not
    reproduce the JAX backward's arithmetic."""

    @staticmethod
    def forward(ctx, spec, route, plan, a, b):
        ctx.save_for_backward(a, b)
        ctx.spec, ctx.route = spec, route
        return _execute_plan(plan, a, b, route)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        lhs, out = _expand_ellipsis(ctx.spec, a.dim(), b.dim()).split("->")
        a_spec, b_spec = lhs.split(",")
        da = db = None
        if ctx.needs_input_grad[3]:
            da = routed_einsum(f"{out},{b_spec}->{a_spec}", g, b, ctx.route).to(a.dtype)
        if ctx.needs_input_grad[4]:
            # over a mesh every rank holds a and g whole, so it computes the
            # weight-side gradient whole: no collective, where a sharded one
            # would be gathered whole again (``core.ops.shard``)
            db = routed_einsum(f"{a_spec},{out}->{b_spec}", a, g,
                               shard.unsharded_route(ctx.route)).to(b.dtype)
        return None, None, None, da, db


def routed_einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
                  policy: str | Route = "bf16") -> torch.Tensor:
    """Two-operand einsum under a (precision, backends) route.

    f32 out always.  Non-reference impls need a 2-D-reducible spec;
    anything else runs the reference, so the call never fails on spec
    structure.
    """
    route = as_route(policy)
    name = route.impl("gemm")
    if name == "torch" and shard.active_mesh(route.mesh) is None:
        return torch_policy_einsum(spec, a, b, route.precision)
    registry.get_impl("gemm", name)      # unknown impls fail loudly
    plan = _plan_2d(spec, tuple(a.shape), tuple(b.shape))
    if plan is None:
        return torch_policy_einsum(spec, a, b, route.precision)
    return _LoweredEinsum.apply(spec, route, plan, a, b)


def gemm(a: torch.Tensor, b: torch.Tensor, *, policy: str | Route = "bf16",
         backend: str | None = None) -> torch.Tensor:
    """Policy-routed C = A @ B through a registry impl (2-D entry)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm expects (m,k) x (k,n); got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    route = as_route(policy)
    if backend is not None:
        route = route.with_impl("gemm", backend)
    return routed_einsum("mk,kn->mn", a, b, route)
