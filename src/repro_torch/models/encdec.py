"""Whisper-style encoder-decoder over the port's stack (twin of
``repro.models.encdec``).

The conv audio frontend is a stub: the encoder takes precomputed frame
embeddings (B, encoder_seq, d_model).  The encoder's self-attention is
bidirectional; the decoder carries its self-attention KV caches and, per
``cross_attn`` sublayer, the keys and values projected once from the
encoder's output at prefill.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "encode", "forward"]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """The decoder's params (``transformer.init_params``, with its learned
    ``pos_embed``), then the encoder's flat sublayer list ``enc_layers``,
    ``enc_final_norm`` and the learned ``enc_pos_embed`` table, drawn from
    ``generator`` on ``device``."""
    params = T.init_params(cfg, generator, device)
    dev = torch.device(device)
    params["enc_layers"] = [T.init_layer(kind, cfg, generator, dev)
                            for kind in layer_kinds(cfg, encoder=True)]
    params["enc_final_norm"] = L.init_rmsnorm(cfg.d_model, dev)
    params["enc_pos_embed"] = {"table": 0.02 * torch.randn(
        (cfg.encoder_seq, cfg.d_model), generator=generator, device=dev,
        dtype=torch.float32)}
    return params


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           policy: PrecisionPolicy, remat: bool = False) -> torch.Tensor:
    """frames (B, encoder_seq, D), the stub frontend's embeddings -> the
    encoder's hidden states (B, encoder_seq, D) in the activation dtype."""
    enc_x, _, _ = T.forward(params, None, cfg, policy=policy, mode="encode",
                            extra_embeds=frames, remat=remat)
    return enc_x


def forward(params: dict, tokens: torch.Tensor, frames: torch.Tensor | None,
            cfg: ModelConfig, *, policy: PrecisionPolicy, mode: str = "train",
            cache: list | None = None, pos: torch.Tensor | None = None,
            last_only: bool = False, remat: bool = False):
    """The whole enc-dec step: at train and prefill ``frames`` go through
    the encoder first; at decode the cross caches carry the encoder's keys
    and values and ``frames`` is unused."""
    enc_x = None
    if mode in ("train", "prefill"):
        if frames is None:
            raise ValueError(f"{cfg.name}: {mode} needs the encoder's frames")
        enc_x = encode(params, frames, cfg, policy=policy, remat=remat)
    return T.forward(params, tokens, cfg, policy=policy, mode=mode, cache=cache, pos=pos,
                     last_only=last_only, remat=remat, enc_x=enc_x)
