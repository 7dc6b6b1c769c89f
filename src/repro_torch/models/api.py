"""Family-dispatching facade (twin of ``repro.models.api``) for the
``dense`` family: runtime/ and launch/ talk to models only through
this module.  ``policy`` is a ``PrecisionPolicy`` (matmuls on the
``torch`` reference) or an ``ExecutionPolicy`` (plus the
``backends: {family: impl}`` routing onto the CUDA kernels).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer as T
from repro_torch.runtime.device import resolve_device

__all__ = ["init_params", "init_cache", "loss_fn", "prefill", "decode"]


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported; only 'dense'")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Params on ``device``, drawn from ``generator``."""
    _dense(cfg)
    return T.init_params(cfg, generator, device)


def init_cache(cfg: ModelConfig, batch: int, s_ctx: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> list:
    """Dense decode cache (an ``AttnCache`` per attention sublayer) on
    ``device``: the card unless the caller asks for the CPU."""
    _dense(cfg)
    return T.init_cache(cfg, batch, s_ctx, dtype, resolve_device(device))


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: PrecisionPolicy, remat: bool = False,
            ) -> tuple[torch.Tensor, dict]:
    """Training loss for one (micro)batch of tokens and labels (B, S).
    Returns (total, {"loss", "aux_loss"}); the dense family has no
    auxiliary loss, so total is the LM loss."""
    _dense(cfg)
    logits, _ = T.forward(params, batch["tokens"], cfg, policy=policy,
                          mode="train", remat=remat)
    loss = T.lm_loss(logits, batch["labels"])
    return loss, {"loss": loss, "aux_loss": torch.zeros((), device=loss.device)}


def prefill(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: PrecisionPolicy):
    """Context ingestion.  Returns (last-position logits (B,1,V), cache)."""
    _dense(cfg)
    logits, cache = T.forward(params, batch["tokens"], cfg, policy=policy,
                              mode="prefill", last_only=True)
    return logits, cache


def decode(params: dict, cache: list, tokens: torch.Tensor, pos, cfg: ModelConfig,
           *, policy: PrecisionPolicy):
    """One decode step: tokens (B,1), ``pos`` the per-row position vector
    (B,) (a scalar broadcasts).  Updates ``cache`` in place."""
    _dense(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.dim() == 0:
        pos = pos.expand(tokens.shape[0])
    return T.forward(params, tokens, cfg, policy=policy, mode="decode",
                     cache=cache, pos=pos)
