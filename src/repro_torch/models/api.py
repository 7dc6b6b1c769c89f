"""Family-dispatching facade (twin of ``repro.models.api``) for the
``dense`` and ``moe`` families, the ``ssm`` family's RWKV-6 stacks and
the ``hybrid`` family (zamba2):
runtime/ and launch/ talk to models only through this module.  ``policy`` is a ``PrecisionPolicy`` (matmuls on the
``torch`` reference) or an ``ExecutionPolicy`` (plus the
``backends: {family: impl}`` routing onto the CUDA kernels).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer as T
from repro_torch.runtime.device import resolve_device

__all__ = ["AUX_LOSS_WEIGHT", "init_params", "init_cache", "loss_fn", "prefill", "decode"]

# weight of the MoE load-balancing loss in the training loss
AUX_LOSS_WEIGHT = 0.01


def _ported(cfg: ModelConfig) -> None:
    T.check_kinds(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Params on ``device``, drawn from ``generator``."""
    _ported(cfg)
    return T.init_params(cfg, generator, device)


def init_cache(cfg: ModelConfig, batch: int, s_ctx: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> list:
    """Dense decode cache (an ``AttnCache`` per attention sublayer, an
    ``RWKVState`` per rwkv6 sublayer, a ``MambaState`` per mamba2
    sublayer) on ``device``: the card unless the caller asks for the CPU."""
    _ported(cfg)
    return T.init_cache(cfg, batch, s_ctx, dtype, resolve_device(device))


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: PrecisionPolicy, remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Training loss for one (micro)batch of tokens and labels (B, S).
    Returns (loss + AUX_LOSS_WEIGHT * aux, {"loss", "aux_loss"}); the aux
    loss is the MoE load-balancing loss (0 for the dense family)."""
    _ported(cfg)
    logits, _, aux = T.forward(params, batch["tokens"], cfg, policy=policy,
                               mode="train", remat=remat)
    loss = T.lm_loss(logits, batch["labels"])
    return loss + AUX_LOSS_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


def prefill(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: PrecisionPolicy):
    """Context ingestion.  Returns (last-position logits (B,1,V), cache)."""
    _ported(cfg)
    logits, cache, _ = T.forward(params, batch["tokens"], cfg, policy=policy,
                                 mode="prefill", last_only=True)
    return logits, cache


def decode(params: dict, cache: list, tokens: torch.Tensor, pos, cfg: ModelConfig,
           *, policy: PrecisionPolicy):
    """One decode step: tokens (B,1), ``pos`` the per-row position vector
    (B,) (a scalar broadcasts).  Updates ``cache`` in place."""
    _ported(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.dim() == 0:
        pos = pos.expand(tokens.shape[0])
    logits, cache, _ = T.forward(params, tokens, cfg, policy=policy, mode="decode",
                                 cache=cache, pos=pos)
    return logits, cache
