"""Decoder-only LM over the config's segment programs (twin of
``repro.models.transformer``), for the dense and moe families (kinds
``attn``, ``attn_local``, ``mlp`` and ``moe``), the ssm family's RWKV-6
stacks (every kind ``rwkv6``) and the hybrid family (zamba2: ``mamba2``
and ``shared_attn``).

The JAX package stacks each segment's params on a ``count`` axis and
runs ``lax.scan``; the port keeps one flat list of sublayers in the same
execution order (``configs.base.layer_kinds``) and runs a Python loop.
``params["layers"][i]`` and ``cache[i]`` belong to sublayer ``i``.  A
``shared_attn`` sublayer's slot in ``params["layers"]`` is an empty
dict: its block (norm, attention, norm, MLP) lives once in
``params["shared"]`` and is applied at every occurrence, while each
occurrence keeps a KV cache of its own.
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
from repro_torch.models import ssm as S
from repro_torch.models.attention import AttnCache, attention, init_attn

__all__ = ["init_params", "forward", "init_cache", "recurrent_state", "lm_loss"]

_ATTN_KINDS = ("attn", "attn_local")
FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the kinds each ported family may hold
_FAMILY_KINDS = {"dense": (*_ATTN_KINDS, "mlp", "moe"), "moe": (*_ATTN_KINDS, "mlp", "moe"),
                 "ssm": ("rwkv6",), "hybrid": ("mamba2", "shared_attn")}


def check_kinds(cfg: ModelConfig) -> list[str]:
    """The flat layer kinds of a ported stack; raises on a family or a
    kind the port does not run (whisper's audio family with cross_attn,
    internvl2's vlm family)."""
    kinds = layer_kinds(cfg)
    allowed = _FAMILY_KINDS.get(cfg.family, ())
    bad = sorted({k for k in kinds if k not in allowed})
    if bad or not allowed:
        raise ValueError(f"{cfg.name}: the port runs dense/moe stacks of attn/attn_local/"
                         f"mlp/moe, ssm stacks of rwkv6 and hybrid stacks of mamba2/"
                         f"shared_attn; got family {cfg.family!r}, kinds {bad}")
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
        elif kind == "mamba2":
            layers.append(S.init_mamba2(generator, cfg.d_model, cfg.ssm_head_dim,
                                        cfg.ssm_state, cfg.conv_width))
        elif kind == "shared_attn":
            layers.append({})               # its params live in params["shared"]
        else:
            layers.append({"norm": L.init_rmsnorm(cfg.d_model, dev),
                           **L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                        cfg.mlp_kind, bias=cfg.mlp_bias)})
    params["layers"] = layers
    if "shared_attn" in kinds:
        params["shared"] = {
            "norm1": L.init_rmsnorm(cfg.d_model, dev),
            "attn": init_attn(generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim),
            "norm2": L.init_rmsnorm(cfg.d_model, dev),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind),
        }
    return params


def cache_capacity(kind: str, cfg: ModelConfig, s_ctx: int) -> int | None:
    """Rows of a sublayer's KV cache: the context for global layers (a
    shared block's occurrences among them), the window (at most) for local
    ones, None for stateless and recurrent sublayers."""
    if kind in ("attn", "shared_attn") or (kind == "attn_local" and cfg.window is None):
        return s_ctx
    if kind == "attn_local":
        return min(s_ctx, cfg.window)
    return None


def recurrent_state(kind: str, cfg: ModelConfig, batch: int,
                    device: torch.device | str):
    """A recurrent sublayer's zero decode state on ``device`` (an f32
    ``RWKVState`` for rwkv6, an f32 ``MambaState`` for mamba2); None for
    every other kind.  Dense in both KV layouts."""
    if kind == "rwkv6":
        return R.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_head_dim, device=device)
    if kind == "mamba2":
        return S.init_mamba_state(batch, cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state,
                                  cfg.conv_width, device=device)
    return None


def init_cache(cfg: ModelConfig, batch: int, s_ctx: int,
               dtype: torch.dtype, device: torch.device | str) -> list:
    """Pre-allocated decode cache on ``device``: an ``AttnCache`` per
    attention sublayer (each shared_attn occurrence its own), the
    ``recurrent_state`` of each rwkv6 or mamba2 sublayer, None per mlp or
    moe sublayer."""
    cache: list = []
    for kind in check_kinds(cfg):
        state = recurrent_state(kind, cfg, batch, device)
        cap = cache_capacity(kind, cfg, s_ctx)
        if state is not None or cap is None:
            cache.append(state)
            continue
        shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
        cache.append(AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                               v=torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def _sublayer(kind: str, p: dict, x: torch.Tensor, *, cfg: ModelConfig,
              policy: PrecisionPolicy, mode: str, cache, pos, shared: dict | None):
    """One pre-norm residual sublayer.  Returns (x, new cache or None,
    aux loss or None).  An rwkv6 or mamba2 layer carries its own norms and
    residuals, and a shared_attn block its two, so they are dispatched
    before the sublayer pre-norm."""
    if kind == "rwkv6":
        x, st = R.rwkv6_layer(p, x, head_dim=cfg.rwkv_head_dim, policy=policy.for_("mlp"),
                              state=cache if mode == "decode" else None, chunk=cfg.rwkv_chunk,
                              norm_eps=cfg.norm_eps, return_state=(mode == "prefill"))
        return x, st, None
    if kind == "mamba2":
        x, st = S.mamba2_layer(p, x, head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
                               conv_width=cfg.conv_width, policy=policy.for_("mlp"),
                               chunk=cfg.ssm_chunk, state=cache if mode == "decode" else None,
                               norm_eps=cfg.norm_eps, return_state=(mode == "prefill"))
        return x, st, None
    if kind == "shared_attn":
        out, nc = attention(
            shared["attn"], L.rmsnorm(shared["norm1"], x, cfg.norm_eps), mode=mode,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            policy=policy.for_("attention"), rope_theta=cfg.rope_theta,
            softcap=cfg.attn_logit_softcap, cache=cache if mode == "decode" else None, pos=pos)
        x = x + out
        xn2 = L.rmsnorm(shared["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(shared["mlp"], xn2, cfg.mlp_kind, policy.for_("mlp"))
        return x, (nc if mode != "train" else None), None
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
                                      cache=cache[i] if cache is not None else None,
                                      shared=params.get("shared"))
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
