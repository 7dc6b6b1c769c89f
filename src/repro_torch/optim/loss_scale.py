"""Dynamic loss scaling for narrow-precision training (twin of
``repro.optim.loss_scale``).

bf16 has f32's exponent range, so overflow is rare (unlike the paper's
fp16, which saturates at 65504), but tiny gradients still vanish below
bf16's 2^-7-relative resolution when activations are kept narrow.  The
standard guard: scale the loss up, unscale the gradients, halve the
scale on a non-finite gradient (never below 1), double it after every
``growth_interval`` finite steps in a row.  The state is torch scalars on
one device; no train path calls it by default, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves, tree_map
from repro_torch.runtime.device import resolve_device

__all__ = ["LossScaleState", "init", "scale_loss", "unscale_and_check", "update"]


class LossScaleState(NamedTuple):
    scale: torch.Tensor           # f32 scalar
    good_steps: torch.Tensor      # int32 scalar: finite steps in a row
    growth_interval: int = 200


def init(initial: float = 2.0 ** 15, growth_interval: int = 200,
         device: torch.device | str = "cuda") -> LossScaleState:
    """A fresh state on ``device``: the card unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    return LossScaleState(scale=torch.tensor(initial, dtype=torch.float32, device=dev),
                          good_steps=torch.zeros((), dtype=torch.int32, device=dev),
                          growth_interval=growth_interval)


def scale_loss(state: LossScaleState, loss: torch.Tensor) -> torch.Tensor:
    return loss * state.scale


def unscale_and_check(state: LossScaleState, grads: Any) -> tuple[Any, torch.Tensor]:
    """(the gradients in f32 times 1 / scale, a bool scalar: all finite)."""
    inv = 1.0 / state.scale
    grads = tree_map(lambda g: g.float() * inv, grads)
    finite = torch.ones((), dtype=torch.bool, device=state.scale.device)
    for g in leaves(grads):
        finite = finite & torch.isfinite(g).all()
    return grads, finite


def update(state: LossScaleState, all_finite) -> LossScaleState:
    finite = torch.as_tensor(all_finite, dtype=torch.bool, device=state.scale.device)
    good = torch.where(finite, state.good_steps + 1, torch.zeros_like(state.good_steps))
    grow = good >= state.growth_interval
    scale = torch.where(finite, torch.where(grow, state.scale * 2.0, state.scale),
                        torch.clamp(state.scale * 0.5, min=1.0))
    good = torch.where(grow, torch.zeros_like(good), good)
    return LossScaleState(scale=scale, good_steps=good, growth_interval=state.growth_interval)
