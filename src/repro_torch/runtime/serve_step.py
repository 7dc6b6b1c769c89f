"""Serve-step constructors (twin of ``repro.runtime.serve_step``).

``make_prefill`` ingests a context and returns a dense cache padded to
the decode capacity; ``make_engine_tick`` decodes one token for every
slot at its own position and applies the per-slot lifecycle masks on the
device, so the host reads back only (B,) vectors per tick.  The steps
run under ``torch.no_grad``: params that carry ``requires_grad`` (a
trained model) build no autograd graph while serving.

``init_paged_cache`` builds the paged decode cache for any family: a page
pool per attention sublayer (each occurrence of zamba2's shared block its
own, in the context class), and one page table per capacity class
(global layers at the context, local layers at the window) shared by the
layers of that class; recurrent state (``RWKVState``, ``MambaState``) and
whisper's cross-attention caches (``encoder_seq`` rows each) stay dense
and MoE sublayers hold nothing, as in ``repro``.  A stack without
attention has no classes and no pools.  ``paged_classes`` sizes the pools.
``make_prefill`` hands the batch (``tokens``, and ``frames`` or
``image_embeds`` for the audio and vlm families) to ``api.prefill``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.ops import paged as paged_kv
from repro_torch.models import api
from repro_torch.models.attention import AttnCache
from repro_torch.models.transformer import cache_capacity, check_kinds, recurrent_state
from repro_torch.runtime.device import resolve_device

__all__ = ["pad_cache", "make_prefill", "make_decode", "make_engine_tick",
           "attn_cache_walk", "paged_classes", "init_paged_cache"]


def attn_cache_walk(cfg: ModelConfig, s_ctx: int):
    """Yield ``(index, kind, cap)`` for every growable attention sublayer
    of the flat layer list (cross-attention, at the encoder's length, is
    not one): the capacity classes of the paged pools."""
    for i, kind in enumerate(layer_kinds(cfg)):
        cap = cache_capacity(kind, cfg, s_ctx)
        if cap is not None:
            yield i, kind, cap


def paged_classes(cfg: ModelConfig, batch: int, s_ctx: int, *,
                  page_size: int, num_pages: int | None = None) -> dict[int, int]:
    """Each capacity class (global context, local window) -> its pool
    size in pages.  The default, full capacity plus the trash page, never
    refuses a request; smaller pools trade admission backpressure for
    memory."""
    caps = sorted({cap for *_, cap in attn_cache_walk(cfg, s_ctx)})
    return {cap: (num_pages if num_pages is not None
                  else 1 + batch * paged_kv.num_logical_pages(cap, page_size))
            for cap in caps}


def init_paged_cache(cfg: ModelConfig, batch: int, s_ctx: int, *,
                     page_size: int, quant: str | None = None,
                     num_pages: int | None = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cuda") -> list:
    """The decode cache with a ``PagedKVCache`` pool per growable attention
    sublayer, a dense ``RWKVState`` per rwkv6 sublayer, a dense
    ``MambaState`` per mamba2 sublayer, a dense ``AttnCache`` of
    ``encoder_seq`` rows per cross_attn sublayer and None per mlp or moe
    sublayer, on ``device``.  Every table entry
    starts on the trash page (0); the engine owns allocation
    (``launch/serve.py``).  The layers of one capacity class share one
    page-table tensor: a slot's page ids are the same in each of their
    pools."""
    dev = resolve_device(device)
    classes = paged_classes(cfg, batch, s_ctx, page_size=page_size,
                            num_pages=num_pages)
    tables = {cap: torch.zeros((batch, paged_kv.num_logical_pages(cap, page_size)),
                               dtype=torch.int32, device=dev) for cap in classes}
    cache: list = [recurrent_state(kind, cfg, batch, dev, dtype) for kind in check_kinds(cfg)]
    for i, _, cap in attn_cache_walk(cfg, s_ctx):
        cache[i] = paged_kv.init_paged(
            batch, cap, cfg.num_kv_heads, cfg.head_dim, page_size=page_size,
            num_pages=classes[cap], quant=quant, dtype=dtype, device=dev,
            page_table=tables[cap])
    return cache


def pad_cache(cache: list, cfg: ModelConfig, s_ctx: int) -> list:
    """Pad every growable dense attention cache along its sequence dim to
    its decode capacity (ring caches are already window-sized); paged
    pools, cross-attention caches (the encoder's length: rows of zeros
    there would be keys the decoder attends to) and recurrent
    ``RWKVState`` / ``MambaState`` leaves (O(1) in the context) pass
    through untouched."""
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
