"""The grouped family (twin of ``repro.core.ops.grouped``): the ragged
expert GEMM of the MoE FFN.

E per-expert GEMMs whose row counts are data-dependent (the paper's
Fig.-7 batched-GEMM regime).  An impl computes

    out[r] = x[r] @ w[e]   for every row r in group e's region,

over a flat token buffer sorted by group with each group's region
aligned to ``bm`` (``grouped_tiles(...).bm``): group e occupies rows
[offsets[e], offsets[e+1]), interior offsets are bm-multiples, padding
rows are zero and come back zero.

  ``torch``         the reference (twin of ``xla``): a gather into the
                    worst-case (E, C = N, D) dispatch tensor, one
                    ``ecd,edf->ecf`` policy einsum and a scatter back.
                    Dropless; the parity oracle, not a production path.
  ``cuda_grouped``  ``kernels.gemm_grouped`` (twin of ``pallas_grouped``):
                    one hand-written kernel walks the sorted buffer, each
                    row tile against its group's weights, with the dx and
                    dW kernels behind its ``autograd.Function``.  It fuses
                    bf16, refine_a, bf16x3 and refine_ab; f32 runs the
                    reference (no narrow-pass decomposition exists for
                    it), and a route asking it for bf16x6 or a quantized
                    rung fails at route build.

The alignment ``bm`` travels from the dispatcher to the impl as the
``bm`` keyword of ``grouped_matmul`` (``repro`` pins it on its route's
tiles); it comes from the global problem, so an expert-parallel rank
(``core.ops.shard``) keeps the alignment its offsets were built with.

Impl contract: fn(x (N,D) sorted+aligned, w (E,D,F), group_offsets
(E+1,) int32, *, route, bm, group_counts=None) -> f32 (N,F).
``group_counts`` (E,), on the device, is each run's real row count (the
rows before its zero padding): an impl may skip the padding with it
(``cuda_grouped``'s 16-row tiles do) or ignore it (``torch``); the result
is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ops import registry, shard
from repro_torch.core.ops.gemm import torch_policy_einsum
from repro_torch.core.ops.registry import (LADDER_BOUNDS, OpSpec, Partitioning,
                                           register_family, register_impl)
from repro_torch.core.ops.route import Route, as_route
from repro_torch.core.ops.tiles import (TileConfig, align_group_counts, set_default_tiles,
                                        tile_for)
from repro_torch.kernels import gemm_grouped

__all__ = ["grouped_matmul", "grouped_tiles"]


def _make_problem(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    e, d, f, bm = 3, 36, 24, gemm_grouped.ROW_TILE
    sizes = np.array([10, 0, 13])
    aligned = align_group_counts(sizes, bm)
    offsets = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
    x = np.zeros((int(offsets[-1]), d), np.float32)
    valid = np.zeros(int(offsets[-1]), bool)
    for g in range(e):
        x[offsets[g]:offsets[g] + sizes[g]] = rng.uniform(-1, 1, (sizes[g], d))
        valid[offsets[g]:offsets[g] + sizes[g]] = True
    return {
        "x": torch.from_numpy(x),
        "w": torch.from_numpy(rng.uniform(-1, 1, (e, d, f)).astype(np.float32)),
        "offsets": torch.from_numpy(offsets),
        "bm": bm,
        "_valid": valid,
    }


def _oracle(problem: dict) -> np.ndarray:
    x, w = problem["x"].double().numpy(), problem["w"].double().numpy()
    off = problem["offsets"].numpy()
    out = np.zeros((x.shape[0], w.shape[2]))
    for g in range(w.shape[0]):
        out[off[g]:off[g + 1]] = (x[off[g]:off[g + 1]].astype(np.float64)
                                   @ w[g].astype(np.float64))
    return out


register_family(OpSpec(
    family="grouped",
    contract="fn(x (N,D) sorted+aligned, w (E,D,F), group_offsets (E+1,) int32, *, "
             "route, bm, group_counts=None) -> f32 (N,F); bm is the group alignment, "
             "group_counts each run's real rows",
    reference="torch",
    label="grouped backend",
    layer_families=("moe",),
    make_problem=_make_problem,
    run=lambda problem, route: grouped_matmul(problem["x"], problem["w"], problem["offsets"],
                                              policy=route, bm=problem["bm"]),
    oracle=_oracle,
    error_bound=lambda policy: LADDER_BOUNDS[policy],
    grad_args=("x",),
    audit_meshes=("ep=3,tp=2",),
))


def grouped_tiles(policy: str | Route, m: int, n: int, k: int) -> TileConfig:
    """The tiles the grouped impl runs (m, n, k) with: ``bm`` is the
    group alignment the dispatcher pads each run to.  m is the real
    token-assignment count."""
    return tile_for(as_route(policy).impl("grouped"), m, n, k)


# Expert parallel: weights shard E; each rank runs its window of the
# sorted buffer against its experts (zero-weight sentinel groups take the
# rows outside it) and an f32 all-reduce over the expert axis reassembles
# the disjoint regions.  tp additionally column-shards F.
_GROUPED_PARTITIONING = Partitioning(
    specs=(("x", (None, None)), ("w", ("ep", None, "tp")), ("out", (None, "tp"))),
    collectives=("psum_f32:ep",),
)


@register_impl("grouped", "torch", fused_policies=registry.ALL_POLICIES, features=("vjp",),
               partitioning=_GROUPED_PARTITIONING)
def _torch_grouped_matmul(x, w, group_offsets, *, route: Route, bm: int, group_counts=None):
    """Reference: gather into the worst-case (E, C = N, D) dispatch
    tensor, one policy einsum, scatter back (C = N: every group could own
    every row, so this is the memory-heavy oracle).  ``group_counts`` is
    not read: the padding rows are zero and come back zero."""
    n = x.shape[0]
    off = group_offsets.long()
    idx = off[:-1, None] + torch.arange(n, device=x.device)[None]      # (E, C)
    valid = idx < off[1:, None]
    idx_c = idx.clamp(max=n - 1)
    xe = torch.where(valid[..., None], x[idx_c], torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    he = torch_policy_einsum("ecd,edf->ecf", xe, w, route.precision)
    contrib = torch.where(valid[..., None], he, 0.0)
    out = torch.zeros((n, w.shape[2]), dtype=torch.float32, device=x.device)
    return out.index_add(0, idx_c.reshape(-1), contrib.reshape(-1, w.shape[2]))


# The kernel reads bm only: the alignment, at least one 16-row WMMA
# fragment (repro's clamp gives 8 at a 4-slot decode).
set_default_tiles("cuda_grouped", TileConfig(bm=128), row_quantum=gemm_grouped.ROW_TILE)


@register_impl("grouped", "cuda_grouped", policies=registry.ALL_POLICIES,
               fused_policies=tuple(gemm_grouped.POLICY_CODES), features=("vjp",),
               partitioning=_GROUPED_PARTITIONING)
def _cuda_grouped_matmul(x, w, group_offsets, *, route: Route, bm: int, group_counts=None):
    return gemm_grouped.grouped(x, w, group_offsets, bm=bm, policy=route.precision,
                                group_counts=group_counts)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
                   policy: str | Route = "bf16", bm: int,
                   group_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Ragged grouped-GEMM dispatch (the MoE expert contraction).

    x: (N, D) token rows sorted by group, runs aligned to ``bm``; w: (E,
    D, F); group_offsets: (E+1,) int32.  Returns f32 (N, F).  ``policy``
    is a precision string (the reference impl) or a route whose grouped
    entry names a registered impl; ``bm`` is the alignment the dispatcher
    padded each run to (``grouped_tiles(policy, N, F, D).bm``);
    ``group_counts`` (E,), on the device, each run's real rows before that
    padding (optional: an impl may skip the padding with it; the result is
    the same).  Differentiable on every impl.
    """
    route = as_route(policy)
    impl = registry.get_impl("grouped", route.impl("grouped"))
    if shard.active_mesh(route.mesh) is not None and impl.capabilities.partitioning:
        return shard.sharded_grouped_matmul(impl, x, w, group_offsets, route, bm=bm,
                                            group_counts=group_counts)
    return impl.fn(x, w, group_offsets, route=shard.unsharded_route(route), bm=bm,
                   group_counts=group_counts)
