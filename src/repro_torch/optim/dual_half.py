"""(hi, lo) bf16 master weights: the paper's operand split applied to
optimizer storage (twin of ``repro.optim.dual_half``).

An f32 master weight is carried as two bf16 tensors (the paper's Eq. 1:
``lo = bf16(w - bf16(w))``, ``core.precision.split2``).  ``hi + lo``
keeps at least 15 significand bits, enough for Adam updates at LM
learning rates, and both halves are narrow: the hi half is the serving
checkpoint, with no cast pass.  Over the port's param trees
(``core.tree``); nothing calls it by default, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.precision import merge2, split2
from repro_torch.core.tree import leaves, tree_map

__all__ = ["DualHalf", "to_dual", "from_dual", "apply_update"]


class DualHalf(NamedTuple):
    hi: Any   # bf16 tree, also the serving / checkpoint weights
    lo: Any   # bf16 tree, the Eq. 1 residuals


def _unzip(template: Any, pairs: list) -> DualHalf:
    """Two trees shaped like ``template`` from (hi, lo) pairs in walk order."""
    his, los = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return DualHalf(hi=tree_map(lambda _: next(his), template),
                    lo=tree_map(lambda _: next(los), template))


@torch.no_grad()
def to_dual(params: Any) -> DualHalf:
    return _unzip(params, [split2(p) for p in leaves(params)])


@torch.no_grad()
def from_dual(dual: DualHalf) -> Any:
    return tree_map(merge2, dual.hi, dual.lo)


@torch.no_grad()
def apply_update(dual: DualHalf, updates: Any) -> DualHalf:
    """w = (hi + lo) + update in f32, split again: only the storage is
    narrow."""
    pairs = [split2(merge2(h, lo) + u.float())
             for h, lo, u in zip(leaves(dual.hi), leaves(dual.lo), leaves(updates))]
    return _unzip(dual.hi, pairs)
