"""Train-step builder (twin of ``repro.runtime.train_step``): loss,
gradients, microbatch accumulation and AdamW.

``policy`` is a ``PrecisionPolicy`` (every matmul on the ``torch``
reference) or an ``ExecutionPolicy`` whose ``backends`` route the GEMMs
to ``cuda`` and attention to ``cuda_fused``: the routed einsum's and the
flash attention's ``autograd.Function``s keep the backward on the same
kernels.  Microbatches are a Python loop that accumulates f32 gradients
and divides by their count (the JAX package scans).  The step updates
params and optimizer state in place (``optim.adamw``) and returns them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import api
from repro_torch.optim import adamw

__all__ = ["make_train_step", "make_loss_fn"]


def make_loss_fn(cfg: ModelConfig, policy: PrecisionPolicy, *,
                 remat: bool = True):
    def loss_fn(params, batch):
        return api.loss_fn(params, batch, cfg, policy=policy, remat=remat)
    return loss_fn


def _grads(loss_fn, params, batch) -> tuple[Any, dict]:
    """(gradient tree, metrics) of one (micro)batch; every param leaf
    must carry ``requires_grad``."""
    total, metrics = loss_fn(params, batch)
    flat = torch.autograd.grad(total, leaves(params))
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    policy: PrecisionPolicy, *, microbatches: int = 1,
                    remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); batch holds (B, S) ``tokens`` and ``labels`` tensors."""
    loss_fn = make_loss_fn(cfg, policy, remat=remat)

    def train_step(params: Any, opt_state: adamw.AdamWState, batch: dict):
        if microbatches == 1:
            grads, metrics = _grads(loss_fn, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} not divisible by microbatches {microbatches}")
            n = b // microbatches
            g_sum = loss_sum = aux_sum = None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, m = _grads(loss_fn, params, mb)
                g = tree_map(lambda x: x.float(), g)
                if g_sum is None:
                    g_sum, loss_sum, aux_sum = g, m["loss"], m["aux_loss"]
                else:
                    g_sum = tree_map(torch.add, g_sum, g)
                    loss_sum, aux_sum = loss_sum + m["loss"], aux_sum + m["aux_loss"]
            grads = tree_map(lambda x: x / microbatches, g_sum)
            metrics = {"loss": loss_sum / microbatches,
                       "aux_loss": aux_sum / microbatches}
        params, opt_state, om = adamw.step(opt_cfg, opt_state, params, grads)
        return params, opt_state, dict(metrics, **om)

    return train_step
