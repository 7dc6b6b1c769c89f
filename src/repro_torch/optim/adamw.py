"""AdamW, the cosine schedule and global-norm clipping over the port's
param trees (twin of ``repro.optim.adamw``).

f32 moments; decoupled weight decay on tensors with ``ndim >= 2`` only;
gradients clipped by their global norm.  ``step`` updates the params
and the moments IN PLACE (the JAX package returns new trees): at
gemma3-1b's 5.2 GB of f32 params that saves a second copy of params and
moments per step.  The schedule and the bias corrections are computed
on f32 tensors, as the JAX code computes them on f32 arrays.

A leaf is updated in slices of its first dimension, blocks of rows of at
most ``SLICE`` elements (one row at least), each with the whole-leaf
expression: an elementwise update sliced changes no bit, and its
temporaries (the scaled gradient, the moment terms, the step) are a few
slices where they were a few leaves.  A row block is a view whatever the
leaf's strides, so a transposed gradient (the unembed table's, from the
``x^T g`` product) is read in place and a param written in place; a flat
``reshape`` of it would copy the leaf.  On one card that is what lets a
large table train beside its moments: command-r-35b's 256000 x 8192 f32
embedding is 8.39 GB, and four leaf-sized temporaries beside params,
gradients, m and v do not fit.  ``global_norm`` sums the squares of a
leaf of more than ``SLICE`` elements block by block; a smaller leaf keeps
the whole-leaf sum, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "init", "step", "cosine_schedule",
           "global_norm", "SLICE"]

# the most elements of a leaf one update or squared sum touches at once
# (256 MB of f32)
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor        # scalar int32
    m: Any                    # f32 tree, mirrors params
    v: Any                    # f32 tree, mirrors params


def init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _row_blocks(x: torch.Tensor) -> list[torch.Tensor]:
    """Views of ``x``: blocks of its first dimension of at most ``SLICE``
    elements (one row at least); a 0-d tensor as one block of one."""
    if x.dim() == 0:
        return [x.view(1)]
    rows = max(1, SLICE // max(1, x.numel() // max(1, x.shape[0])))
    return [x[i:i + rows] for i in range(0, x.shape[0], rows)]


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    if x.numel() <= SLICE:
        return x.float().square().sum()
    return sum(b.float().square().sum() for b in _row_blocks(x))


def global_norm(tree: Any) -> torch.Tensor:
    sq = sum(_square_sum(x) for x in leaves(tree))
    return torch.sqrt(sq)


def _update(cfg: AdamWConfig, p, g, m, v, *, scale, lr, b1c, b2c, decay: bool) -> None:
    """The AdamW update of one slice, in place on ``p``, ``m`` and ``v``."""
    g = g.float()
    if scale is not None:
        g = g * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)


@torch.no_grad()
def step(cfg: AdamWConfig, state: AdamWState, params: Any, grads: Any, *,
         gnorm: torch.Tensor | None = None,
         ) -> tuple[Any, AdamWState, dict[str, torch.Tensor]]:
    """One AdamW update, in place.  Returns (params, state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``.  ``gnorm`` is the
    global norm when ``grads`` hold only this rank's blocks of the
    gradients (a sharded run), computed from ``grads`` otherwise."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    t = state.step + 1
    lr = cosine_schedule(cfg, t)
    b1c = 1 - cfg.b1 ** t.float()
    b2c = 1 - cfg.b2 ** t.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        for ps, gs, ms, vs in zip(*(_row_blocks(x) for x in (p, g, m, v))):
            _update(cfg, ps, gs, ms, vs, scale=scale, lr=lr, b1c=b1c, b2c=b2c,
                    decay=p.dim() >= 2)  # decoupled weight decay on matrices only
    state = AdamWState(step=t.to(torch.int32), m=state.m, v=state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
