"""Residual-compensated gradient compression: the paper's Eq. 1 residual
applied to the data-parallel all-reduce (twin of
``repro.optim.compression``).

Each rank sends ``hi = bf16(g)`` (half the bytes of f32) and keeps the
residual ``g - hi`` in a local f32 error-feedback buffer that is added
into the NEXT step's gradient before compression.  Over two steps the
full f32 gradient crosses the wire: the paper's "distribute the
un-representable portion to another 16-bit number", with the second
number sent one step later.

The bf16 payloads are all-gathered and summed in f32 in rank order, then
divided by the group size, so every rank gets the same mean and a
one-rank group returns ``hi`` exactly (``repro``'s ``pmean`` over one
device).  Exposed two ways, as in ``repro``:
  * ``compressed_pmean(grads, error, axis_name, mesh)`` over a tree;
  * ``make_compressed_allreduce(mesh, axis_name)`` over one flat vector
    (``flatten_tree`` / ``unflatten_tree``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.ops import shard
from repro_torch.core.ops.shard import MeshSpec
from repro_torch.core.precision import split2
from repro_torch.core.tree import leaves, tree_map

__all__ = ["init_error_state", "compressed_pmean", "compress_mean", "make_compressed_allreduce",
           "flatten_tree", "unflatten_tree"]


def init_error_state(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)


def _mean_hi(hi: torch.Tensor, mesh: MeshSpec | None, axis_name: str) -> torch.Tensor:
    """Mean over the ranks of ``axis_name`` of their bf16 payloads,
    summed in f32 in rank order."""
    if mesh is None or dict(mesh.axis_items()).get(axis_name, 1) == 1:
        return hi.float()
    m = shard._Mesh(mesh)
    parts = shard._all_gather(hi[None], 0, m, axis_name)
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    return total / parts.shape[0]


def compress_mean(g: torch.Tensor, e: torch.Tensor, mesh: MeshSpec | None,
                  axis_name: str = "data") -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf: (the bf16-wire mean over ``axis_name``, the new f32
    error)."""
    g32 = g.float() + e                      # inject the carried residual
    hi, _ = split2(g32)                      # bf16 wire payload
    new_e = g32 - hi.float()                 # paper Eq. 1 residual
    return _mean_hi(hi, mesh, axis_name), new_e


def compressed_pmean(grads: Any, error: Any, axis_name: str = "data",
                     mesh: MeshSpec | None = None) -> tuple[Any, Any]:
    """bf16-wire mean over ``axis_name`` of ``mesh`` with f32 error
    feedback: (mean gradients, new error), both f32 trees."""
    pairs = [compress_mean(g, e, mesh, axis_name) for g, e in zip(leaves(grads), leaves(error))]
    it_g, it_e = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return tree_map(lambda _: next(it_g), grads), tree_map(lambda _: next(it_e), grads)


# -------------------------------------------------- flat-vector variant

def flatten_tree(tree: Any) -> tuple[torch.Tensor, Any, list]:
    ls = leaves(tree)
    shapes = [(tuple(x.shape), x.dtype) for x in ls]
    return torch.cat([x.float().reshape(-1) for x in ls]), tree, shapes


def unflatten_tree(flat: torch.Tensor, treedef: Any, shapes) -> Any:
    out, off = [], 0
    for shape, dtype in shapes:
        n = 1
        for s in shape:
            n *= s
        out.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    it = iter(out)
    return tree_map(lambda _: next(it), treedef)


def make_compressed_allreduce(mesh: MeshSpec | None, axis_name: str = "data"):
    """Flat-vector compressed all-reduce: (this rank's flat gradient, its
    flat error) -> (the f32 mean over ``axis_name``, the new error)."""

    def reduce(g: torch.Tensor, e: torch.Tensor):
        return compress_mean(g, e, mesh, axis_name)

    return reduce
