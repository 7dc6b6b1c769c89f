"""Mixture-of-Experts FFN (twin of ``repro.models.moe``): a top-k router
and two dispatch layouts.

The router runs in f32 on the ``torch`` reference (routing decisions are
precision-sensitive and cheap) and picks the top-k experts per token;
ties go to the lower expert index, as ``jax.lax.top_k`` breaks them.
What follows depends on the route's ``grouped`` impl:

``torch`` (the family's reference, the default) — capacity-padded
  dispatch (Switch semantics): position-in-expert by a (T*k, E) cumsum,
  an (E, C, D) gather, assignments past ``capacity`` DROPPED, the
  experts as the ``ecd,edf->ecf`` policy einsum through the GEMM family,
  and a gate-weighted scatter-add back.

any other impl (``cuda_grouped``) — sort-based DROPLESS dispatch: a
  stable argsort of the assignments by expert, each expert's run padded
  only to the alignment ``bm`` (at least one tile), and three
  ``grouped_matmul`` calls (wi, wg, wo), each given the real per-expert
  counts (``group_counts``), with which the kernel's 16-row decode tiles
  that hold only padding read no weights.  No token is dropped and every
  output row is its own dot product, so a token's output does not
  depend on the rest of its batch.  Each token's k contributions are
  gathered back and summed in the JAX package's scatter order (by
  expert), so the result is the same on every run, with no atomics.

Nothing reads counts or offsets on the host: the buffer has the static
size ``round_up(T*k, bm) + E*bm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.core.ops import Route
from repro_torch.core.refined_matmul import peinsum
from repro_torch.models import layers as L

__all__ = ["init_moe", "moe_ffn"]


def init_moe(gen: torch.Generator, d: int, d_ff: int, num_experts: int,
             mlp_kind: str) -> dict:
    p = {
        "router": L.init_linear(gen, d, num_experts),
        "wi": L.init_linear(gen, d, d_ff, stack=(num_experts,)),
        "wo": L.init_linear(gen, d_ff, d, stack=(num_experts,), scale=d_ff ** -0.5),
    }
    if mlp_kind == "swiglu":
        p["wg"] = L.init_linear(gen, d, d_ff, stack=(num_experts,))
    return p


def _activate(h: torch.Tensor, g: torch.Tensor | None, mlp_kind: str) -> torch.Tensor:
    if mlp_kind == "swiglu":
        return F.silu(g) * h
    if mlp_kind == "squared_relu":
        return F.relu(h).square()
    return F.gelu(h, approximate="tanh")


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index (a
    stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ===================================================== capacity dispatch

def _capacity_ffn(p: dict, xf: torch.Tensor, gate_vals, expert_idx, *,
                  num_experts: int, top_k: int, capacity: int, mlp_kind: str,
                  policy, dtype) -> torch.Tensor:
    """The capacity-padded reference dispatch.  xf: (T, D) -> (T, D) f32."""
    t, dev = xf.shape[0], xf.device
    flat_expert = expert_idx.reshape(-1)                            # (T*k,)
    onehot = F.one_hot(flat_expert, num_experts).to(torch.int32)
    pos_in_expert = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = pos_in_expert < capacity

    # dispatch[e, c] = the token filling slot c of expert e; assignments
    # over capacity write the dummy row E, which is dropped
    tok_ids = torch.arange(t * top_k, device=dev) // top_k
    e_safe = torch.where(keep, flat_expert, num_experts)
    c_safe = torch.where(keep, pos_in_expert, 0)
    dispatch = torch.zeros((num_experts + 1, capacity), dtype=torch.long, device=dev)
    dispatch[e_safe, c_safe] = tok_ids
    filled = torch.zeros((num_experts + 1, capacity), dtype=torch.bool, device=dev)
    filled[e_safe, c_safe] = keep
    dispatch, filled = dispatch[:num_experts], filled[:num_experts]

    xe = xf[dispatch] * filled[..., None].to(dtype)                 # (E, C, D)
    h = peinsum("ecd,edf->ecf", xe, p["wi"]["w"], policy)
    g = peinsum("ecd,edf->ecf", xe, p["wg"]["w"], policy) if mlp_kind == "swiglu" else None
    h = _activate(h, g, mlp_kind)
    ye = peinsum("ecf,efd->ecd", h.to(dtype), p["wo"]["w"], policy)

    slot_gate = torch.zeros((num_experts + 1, capacity), dtype=torch.float32, device=dev)
    slot_gate = slot_gate.index_put((e_safe, c_safe),
                                    torch.where(keep, gate_vals.reshape(-1), 0.0))
    slot_gate = slot_gate[:num_experts]
    out = torch.zeros((t, xf.shape[1]), dtype=torch.float32, device=dev)
    contrib = ye * slot_gate[..., None]
    return out.index_add(0, dispatch.reshape(-1), contrib.reshape(-1, xf.shape[1]))


# ======================================================= sorted dispatch

def _sorted_ffn(p: dict, xf: torch.Tensor, gate_vals, expert_idx, *,
                num_experts: int, top_k: int, mlp_kind: str, route: Route,
                dtype) -> torch.Tensor:
    """Dropless sort-based dispatch onto the grouped family.
    xf: (T, D) -> (T, D) f32."""
    t, d = xf.shape
    tk, dev = t * top_k, xf.device
    d_ff = p["wi"]["w"].shape[-1]
    # one alignment for the dispatcher and the kernel
    bm = ops.grouped_tiles(route, tk, d_ff, d).bm

    flat_expert = expert_idx.reshape(-1)                            # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    # a scatter, not bincount: bincount reads the largest id back to the
    # host on CUDA; int32, as the kernels read it (group_counts)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))
    aligned = ops.align_group_counts(counts, bm)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(aligned, 0).to(torch.int32)])  # (E+1,)
    n_buf = ops.round_up(tk, bm) + num_experts * bm                 # >= sum(aligned)

    # destination row of each sorted assignment: its group's aligned
    # start plus its rank within the group
    sorted_e = flat_expert[order]
    group_first = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(tk, device=dev) - group_first[sorted_e]
    dest = offsets[:-1].long()[sorted_e] + rank                     # (T*k,)
    tok = order // top_k

    xs = torch.zeros((n_buf, d), dtype=dtype, device=dev).index_put((dest,), xf[tok].to(dtype))
    # the real counts let a 16-row tile that holds only padding skip its
    # expert's weights (the result is the same)
    kw = dict(policy=route, bm=bm, group_counts=counts)
    h = ops.grouped_matmul(xs, p["wi"]["w"], offsets, **kw)
    g = ops.grouped_matmul(xs, p["wg"]["w"], offsets, **kw) if mlp_kind == "swiglu" else None
    h = _activate(h, g, mlp_kind)
    ys = ops.grouped_matmul(h.to(dtype), p["wo"]["w"], offsets, **kw)

    # Combine.  JAX scatter-adds ys[dest] * gate in sorted order, so each
    # token sums its k contributions by ascending expert, starting from 0:
    # gather each token's k sorted positions, order them, add in turn.
    gates = gate_vals.reshape(-1)[order]                            # (T*k,)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(tk, device=dev))
    pos = inv.reshape(t, top_k).sort(dim=1).values                  # (T, k)
    contrib = ys[dest[pos]] * gates[pos][..., None]                 # (T, k, D)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for s in range(top_k):
        out = out + contrib[:, s]
    return out


# ================================================================== FFN

def moe_ffn(p: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float, mlp_kind: str, policy: str | Route,
            router_policy: str = "f32", dropless: bool = False,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32).

    ``dropless`` lifts the reference path's capacity to the worst case
    (T*k): the decode path passes it, since dropping would make a token
    depend on its batch.  The sorted path is dropless by construction.
    """
    b, s, d = x.shape
    t = b * s
    dtype = x.dtype
    xf = x.reshape(t, d)

    logits = peinsum("td,de->te", xf, p["router"]["w"], router_policy)
    probs = torch.softmax(logits.float(), dim=-1)                   # (T, E)
    gate_vals, expert_idx = _top_k(probs, top_k)                    # (T, k)

    # load-balancing loss, Mixtral form: the density counts every top-k
    # assignment, not only the top-1 column
    density = F.one_hot(expert_idx, num_experts).float().mean(dim=(0, 1))
    aux_loss = num_experts * torch.sum(density * probs.mean(dim=0))

    route = ops.as_route(policy)
    if route.uses_reference("grouped"):
        if dropless:
            capacity = t * top_k
        else:
            capacity = max(int(capacity_factor * top_k * t / num_experts), top_k)
        out = _capacity_ffn(p, xf, gate_vals, expert_idx, num_experts=num_experts,
                            top_k=top_k, capacity=capacity, mlp_kind=mlp_kind,
                            policy=policy, dtype=dtype)
    else:
        out = _sorted_ffn(p, xf, gate_vals, expert_idx, num_experts=num_experts,
                          top_k=top_k, mlp_kind=mlp_kind, route=route, dtype=dtype)
    return out.to(dtype).reshape(b, s, d), aux_loss
