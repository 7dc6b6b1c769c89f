"""InternVL2-style VLM over the port's stack (twin of
``repro.models.vlm``): a stubbed ViT frontend and a dense LM backbone.

The InternViT tower is a stub: the model takes precomputed patch
embeddings (B, num_image_tokens, d_model), already projected into the
LM's embedding space, and prepends them to the token embeddings; the loss
masks the image positions.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer as T

__all__ = ["forward", "vlm_loss"]


def forward(params: dict, tokens: torch.Tensor | None,
            image_embeds: torch.Tensor | None, cfg: ModelConfig, *,
            policy: PrecisionPolicy, mode: str = "train",
            cache: list | None = None, pos: torch.Tensor | None = None,
            last_only: bool = False, remat: bool = False):
    """train / prefill: the image rows (B, N_img, D) then the text tokens
    (B, S_text), one sequence [img; text]; decode: one token against the
    cache (whose rows count the image's)."""
    if mode in ("train", "prefill") and image_embeds is None:
        raise ValueError(f"{cfg.name}: {mode} needs the image rows (image_embeds)")
    return T.forward(params, tokens, cfg, policy=policy, mode=mode, cache=cache, pos=pos,
                     last_only=last_only, remat=remat,
                     extra_embeds=image_embeds if mode != "decode" else None)


def vlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             num_image_tokens: int) -> torch.Tensor:
    """Cross entropy on the text positions only (the image positions have
    logits too, but no labels)."""
    return T.lm_loss(logits[:, num_image_tokens:], labels)
