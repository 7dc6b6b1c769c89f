"""Serve-step constructors (twin of ``repro.runtime.serve_step``), dense KV.

``make_prefill`` ingests a context and returns a cache padded to the
decode capacity; ``make_engine_tick`` decodes one token for every slot
at its own position and applies the per-slot lifecycle masks on the
device, so the host reads back only (B,) vectors per tick.  The steps
run under ``torch.no_grad``: params that carry ``requires_grad`` (a
trained model) build no autograd graph while serving.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import api
from repro_torch.models.attention import AttnCache
from repro_torch.models.transformer import cache_capacity

__all__ = ["pad_cache", "make_prefill", "make_decode", "make_engine_tick"]


def pad_cache(cache: list, cfg: ModelConfig, s_ctx: int) -> list:
    """Pad every attention cache along its sequence dim to its decode
    capacity (ring caches are already window-sized)."""
    out = []
    for kind, c in zip(layer_kinds(cfg), cache):
        cap = cache_capacity(kind, cfg, s_ctx)
        if cap is not None and isinstance(c, AttnCache) and c.k.shape[1] < cap:
            pad = (0, 0, 0, 0, 0, cap - c.k.shape[1])
            c = AttnCache(k=F.pad(c.k, pad), v=F.pad(c.v, pad))
        out.append(c)
    return out


def make_prefill(cfg: ModelConfig, policy: PrecisionPolicy, *, s_ctx: int):
    """prefill(params, batch) -> (next-token logits, capacity cache)."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache = api.prefill(params, batch, cfg, policy=policy)
        return logits, pad_cache(cache, cfg, s_ctx)

    return prefill


def make_decode(cfg: ModelConfig, policy: PrecisionPolicy):
    """decode(params, cache, tokens (B,1), pos (B,)) -> (logits, cache)."""

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        return api.decode(params, cache, tokens, pos, cfg, policy=policy)

    return decode


def make_engine_tick(cfg: ModelConfig, policy: PrecisionPolicy, *,
                     eos_id: int, max_ctx: int):
    """One continuous-batching engine tick.

    tick(params, cache, last_tok (B,), pos (B,), active (B,) bool,
         remaining (B,)) -> (cache, next_tok, pos, remaining, active,
                             finished)

    Every slot decodes at its own position; inactive rows keep their
    state (their output is discarded), active rows advance, spend one
    token of budget, and finish on EOS, budget or context exhaustion.
    """

    @torch.no_grad()
    def tick(params, cache, last_tok, pos, active, remaining):
        logits, cache = api.decode(params, cache, last_tok[:, None], pos, cfg,
                                   policy=policy)
        sampled = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        nxt = torch.where(active, sampled, last_tok)
        new_pos = torch.where(active, pos + 1, pos)
        new_rem = torch.where(active, remaining - 1, remaining)
        finished = active & ((nxt == eos_id) | (new_rem <= 0)
                             | (new_pos >= max_ctx - 1))
        return cache, nxt, new_pos, new_rem, active & ~finished, finished

    return tick
