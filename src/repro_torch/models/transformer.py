"""Decoder-only LM over the config's segment programs (twin of
``repro.models.transformer``), for the dense and moe families (kinds
``attn``, ``attn_local``, ``mlp`` and ``moe``) and the ssm family's
RWKV-6 stacks (every kind ``rwkv6``; zamba2's ``mamba2`` /
``shared_attn`` are not ported and raise).

The JAX package stacks each segment's params on a ``count`` axis and
runs ``lax.scan``; the port keeps one flat list of sublayers in the same
execution order (``configs.base.layer_kinds``) and runs a Python loop.
``params["layers"][i]`` and ``cache[i]`` belong to sublayer ``i``.
``forward`` returns the MoE sublayers' load-balancing loss summed over
the stack, as the JAX package's third value.
With ``remat`` each period of a segment's pattern (one scan step in the
JAX package, which wraps it in ``jax.checkpoint``) runs under
``torch.utils.checkpoint``: its activations are recomputed in the
backward instead of kept.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models.attention import AttnCache, attention, init_attn

__all__ = ["init_params", "forward", "init_cache", "lm_loss"]

_ATTN_KINDS = ("attn", "attn_local")
FAMILIES = ("dense", "moe", "ssm")
# the kinds each ported family may hold
_FAMILY_KINDS = {"dense": (*_ATTN_KINDS, "mlp", "moe"), "moe": (*_ATTN_KINDS, "mlp", "moe"),
                 "ssm": ("rwkv6",)}


def check_kinds(cfg: ModelConfig) -> list[str]:
    """The flat layer kinds of a ported stack; raises on a family or a
    kind the port does not run (zamba2's mamba2 / shared_attn among them)."""
    kinds = layer_kinds(cfg)
    allowed = _FAMILY_KINDS.get(cfg.family, ())
    bad = sorted({k for k in kinds if k not in allowed})
    if bad or not allowed:
        raise ValueError(f"{cfg.name}: the port runs dense/moe stacks of attn/attn_local/"
                         f"mlp/moe and ssm stacks of rwkv6; got family {cfg.family!r}, "
                         f"kinds {bad}")
    return kinds


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Random params on ``device``, drawn from ``generator`` (which must
    live there), with the JAX package's shapes and scales."""
    kinds = check_kinds(cfg)
    dev = torch.device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw params on {dev}")
    params: dict[str, Any] = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model),
        "final_norm": L.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(generator, cfg.vocab_size, cfg.d_model)
    layers = []
    for kind in kinds:
        if kind in _ATTN_KINDS:
            layers.append({"norm": L.init_rmsnorm(cfg.d_model, dev),
                           **init_attn(generator, cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       bias=cfg.qkv_bias)})
        elif kind == "moe":
            layers.append({"norm": L.init_rmsnorm(cfg.d_model, dev),
                           **M.init_moe(generator, cfg.d_model, cfg.d_ff,
                                        cfg.num_experts, cfg.mlp_kind)})
        elif kind == "rwkv6":
            layers.append(R.init_rwkv6(generator, cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim))
        else:
            layers.append({"norm": L.init_rmsnorm(cfg.d_model, dev),
                           **L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                        cfg.mlp_kind, bias=cfg.mlp_bias)})
    params["layers"] = layers
    return params


def cache_capacity(kind: str, cfg: ModelConfig, s_ctx: int) -> int | None:
    """Rows of a sublayer's KV cache: the context for global layers, the
    window (at most) for local ones, None for stateless sublayers."""
    if kind == "attn" or (kind == "attn_local" and cfg.window is None):
        return s_ctx
    if kind == "attn_local":
        return min(s_ctx, cfg.window)
    return None


def init_cache(cfg: ModelConfig, batch: int, s_ctx: int,
               dtype: torch.dtype, device: torch.device | str) -> list:
    """Pre-allocated decode cache on ``device``: an ``AttnCache`` per
    attention sublayer, an f32 ``RWKVState`` per rwkv6 sublayer, None per
    mlp or moe sublayer."""
    cache: list = []
    for kind in check_kinds(cfg):
        if kind == "rwkv6":
            cache.append(R.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                                           device=device))
            continue
        cap = cache_capacity(kind, cfg, s_ctx)
        if cap is None:
            cache.append(None)
            continue
        shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
        cache.append(AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                               v=torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def _sublayer(kind: str, p: dict, x: torch.Tensor, *, cfg: ModelConfig,
              policy: PrecisionPolicy, mode: str, cache, pos):
    """One pre-norm residual sublayer.  Returns (x, new cache or None,
    aux loss or None).  An rwkv6 layer carries its own two norms and
    residuals, so it is dispatched before the shared pre-norm."""
    if kind == "rwkv6":
        x, st = R.rwkv6_layer(p, x, head_dim=cfg.rwkv_head_dim, policy=policy.for_("mlp"),
                              state=cache if mode == "decode" else None, chunk=cfg.rwkv_chunk,
                              norm_eps=cfg.norm_eps, return_state=(mode == "prefill"))
        return x, st, None
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    if kind in _ATTN_KINDS:
        out, nc = attention(
            p, xn, mode=mode, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            policy=policy.for_("attention"), rope_theta=cfg.rope_theta,
            window=cfg.window if kind == "attn_local" else None,
            softcap=cfg.attn_logit_softcap,
            cache=cache if mode == "decode" else None, pos=pos)
        return x + out, (nc if mode != "train" else None), None
    if kind == "moe":
        out, aux = M.moe_ffn(
            p, xn, num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp_kind,
            policy=policy.for_("moe"), dropless=(mode == "decode"))
        return x + out, None, aux
    return x + L.mlp(p, xn, cfg.mlp_kind, policy.for_("mlp")), None, None


def _periods(cfg: ModelConfig) -> list[tuple[int, int]]:
    """[start, stop) sublayer ranges of every period of every segment."""
    out, i = [], 0
    for seg in cfg.segments:
        for _ in range(seg.count):
            out.append((i, i + len(seg.pattern)))
            i += len(seg.pattern)
    return out


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            policy: PrecisionPolicy, mode: str = "train",
            cache: list | None = None, pos: torch.Tensor | None = None,
            last_only: bool = False, remat: bool = False,
            ) -> tuple[torch.Tensor, list, torch.Tensor]:
    """Run the LM stack.  tokens (B, S) int; mode train | prefill |
    decode; decode takes the per-row ``pos`` (B,) and updates ``cache``
    in place.  ``last_only`` projects only the last position onto the
    vocabulary (each row of the unembed is independent, so its logits
    equal the full projection's last row).  ``remat`` (train) recomputes
    each period's activations in the backward.  Returns (logits f32,
    cache, aux loss f32: the MoE sublayers' sum, 0 without them).
    """
    kinds = check_kinds(cfg)
    dtype = getattr(torch, cfg.activation_dtype)
    x = L.embed(params["embed"], tokens, dtype)
    new_cache: list = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start, stop in _periods(cfg):
        def period(x, start=start, stop=stop):
            ncs, a = [], torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(start, stop):
                x, nc, ai = _sublayer(kinds[i], params["layers"][i], x, cfg=cfg,
                                      policy=policy, mode=mode, pos=pos,
                                      cache=cache[i] if cache is not None else None)
                ncs.append(nc)
                if ai is not None:
                    a = a + ai
            return x, ncs, a

        if remat and mode == "train":
            x, ncs, a = checkpoint(period, x, use_reentrant=False)
        else:
            x, ncs, a = period(x)
        new_cache.extend(ncs)
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    table = params["embed" if cfg.tie_embeddings else "unembed"]
    return L.unembed(table, x, policy.for_("logits")), new_cache, aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in f32 (labels already shifted): the mean
    of logsumexp minus the label logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()
