"""Family-dispatching facade (twin of ``repro.models.api``) for every
family: dense, moe, the ssm family's RWKV-6 stacks, hybrid (zamba2),
audio (whisper's encoder-decoder, ``models.encdec``) and vlm (internvl2's
image prefix, ``models.vlm``).  runtime/ and launch/ talk to models only
through this module.  ``policy`` is a ``PrecisionPolicy`` (matmuls on the
``torch`` reference) or an ``ExecutionPolicy`` (plus the
``backends: {family: impl}`` routing onto the CUDA kernels).  Every
family trains through ``loss_fn``: the audio family's batches carry the
encoder's ``frames``, the vlm family's its ``image_embeds``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.runtime.device import resolve_device

__all__ = ["AUX_LOSS_WEIGHT", "init_params", "init_cache", "loss_fn", "prefill", "decode",
           "context_len"]

# weight of the MoE load-balancing loss in the training loss
AUX_LOSS_WEIGHT = 0.01


def _ported(cfg: ModelConfig) -> None:
    T.check_kinds(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Params on ``device``, drawn from ``generator``."""
    _ported(cfg)
    if cfg.family == "audio":
        return E.init_params(cfg, generator, device)
    return T.init_params(cfg, generator, device)


def context_len(cfg: ModelConfig, seq_len: int) -> int:
    """Decode-cache capacity for ``seq_len`` text tokens (the image tokens
    extend the VLM's context)."""
    if cfg.family == "vlm":
        return seq_len + cfg.num_image_tokens
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, s_ctx: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> list:
    """Dense decode cache (an ``AttnCache`` per attention sublayer, a
    cross_attn one of ``encoder_seq`` rows, an ``RWKVState`` per rwkv6
    sublayer, a ``MambaState`` per mamba2 sublayer) on ``device``: the card
    unless the caller asks for the CPU."""
    _ported(cfg)
    return T.init_cache(cfg, batch, s_ctx, dtype, resolve_device(device))


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: PrecisionPolicy, remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Training loss for one (micro)batch of tokens and labels (B, S), with
    ``frames`` (B, encoder_seq, D) for audio and ``image_embeds`` (B,
    num_image_tokens, D) for vlm, whose loss scores the text rows only.
    Returns (loss + AUX_LOSS_WEIGHT * aux, {"loss", "aux_loss"}); the aux
    loss is the MoE load-balancing loss (0 without MoE sublayers)."""
    _ported(cfg)
    if cfg.family == "audio":
        logits, _, aux = E.forward(params, batch["tokens"], batch.get("frames"), cfg,
                                   policy=policy, mode="train", remat=remat)
        loss = T.lm_loss(logits, batch["labels"])
    elif cfg.family == "vlm":
        logits, _, aux = V.forward(params, batch["tokens"], batch.get("image_embeds"), cfg,
                                   policy=policy, mode="train", remat=remat)
        loss = V.vlm_loss(logits, batch["labels"], cfg.num_image_tokens)
    else:
        logits, _, aux = T.forward(params, batch["tokens"], cfg, policy=policy,
                                   mode="train", remat=remat)
        loss = T.lm_loss(logits, batch["labels"])
    return loss + AUX_LOSS_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


def prefill(params: dict, batch: dict, cfg: ModelConfig, *,
            policy: PrecisionPolicy):
    """Context ingestion: ``batch["tokens"]`` (B, S), with
    ``batch["frames"]`` (B, encoder_seq, D) for audio and
    ``batch["image_embeds"]`` (B, num_image_tokens, D) for vlm.  Returns
    (last-position logits (B,1,V), cache)."""
    _ported(cfg)
    if cfg.family == "audio":
        logits, cache, _ = E.forward(params, batch["tokens"], batch["frames"], cfg,
                                     policy=policy, mode="prefill", last_only=True)
    elif cfg.family == "vlm":
        logits, cache, _ = V.forward(params, batch["tokens"], batch["image_embeds"], cfg,
                                     policy=policy, mode="prefill", last_only=True)
    else:
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
