"""AdamW, the cosine schedule and global-norm clipping over the port's
param trees (twin of ``repro.optim.adamw``).

f32 moments; decoupled weight decay on tensors with ``ndim >= 2`` only;
gradients clipped by their global norm.  ``step`` updates the params
and the moments IN PLACE (the JAX package returns new trees): at
gemma3-1b's 5.2 GB of f32 params that saves a second copy of params and
moments per step.  The schedule and the bias corrections are computed
on f32 tensors, as the JAX code computes them on f32 arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "init", "step", "cosine_schedule",
           "global_norm"]


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


def global_norm(tree: Any) -> torch.Tensor:
    sq = sum(x.float().square().sum() for x in leaves(tree))
    return torch.sqrt(sq)


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
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state = AdamWState(step=t.to(torch.int32), m=state.m, v=state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
