"""The LM stack over the config's segment programs (twin of
``repro.models.transformer``), for every family: dense and moe (kinds
``attn``, ``attn_local``, ``mlp`` and ``moe``), the ssm family's RWKV-6
stacks (every kind ``rwkv6``), the hybrid family (zamba2: ``mamba2`` and
``shared_attn``), audio (whisper's decoder: ``attn``, ``cross_attn``,
``mlp``; its encoder, ``attn`` and ``mlp`` run in ``mode="encode"``) and
vlm (internvl2: a dense stack whose input starts with ``extra_embeds``).

The JAX package stacks each segment's params on a ``count`` axis and
runs ``lax.scan``; the port keeps one flat list of sublayers in the same
execution order (``configs.base.layer_kinds``) and runs a Python loop.
``params["layers"][i]`` and ``cache[i]`` belong to sublayer ``i``.  A
``shared_attn`` sublayer's slot in ``params["layers"]`` is an empty
dict: its block (norm, attention, norm, MLP) lives once in
``params["shared"]`` and is applied at every occurrence, while each
occurrence keeps a KV cache of its own.
An encoder-decoder keeps its encoder's sublayers in a second flat list,
``params["enc_layers"]`` (the JAX package's ``enc_seg*``), with
``enc_final_norm`` and a learned ``enc_pos_embed`` table; a stack without
RoPE (``rope_theta=None``) adds the rows of ``pos_embed`` to its inputs.
A ``cross_attn`` sublayer projects the encoder's output through its
``wk`` / ``wv`` once at train and prefill, keeps the result as its cache
(``encoder_seq`` rows, never padded or paged) and reads it at decode.
``forward`` returns the MoE sublayers' load-balancing loss summed over
the stack, as the JAX package's third value.
With ``remat`` each period of a segment's pattern (one scan step in the
JAX package, which wraps it in ``jax.checkpoint``) runs under
``torch.utils.checkpoint`` in every mode, an encoder's periods included:
its activations are recomputed in the backward instead of kept.  The
serve paths pass ``remat=False``.
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
from repro_torch.runtime.act_sharding import constrain

__all__ = ["init_params", "init_layer", "forward", "init_cache", "recurrent_state",
           "lm_loss"]

_ATTN_KINDS = ("attn", "attn_local", "cross_attn")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# the kinds each family may hold (an audio config's encoder: attn and mlp)
_FAMILY_KINDS = {"dense": ("attn", "attn_local", "mlp", "moe"),
                 "moe": ("attn", "attn_local", "mlp", "moe"),
                 "ssm": ("rwkv6",), "hybrid": ("mamba2", "shared_attn"),
                 "audio": ("attn", "cross_attn", "mlp"), "vlm": ("attn", "attn_local", "mlp")}
_ENCODER_KINDS = ("attn", "mlp")


def check_kinds(cfg: ModelConfig) -> list[str]:
    """The flat layer kinds of a stack the port runs; raises on a family
    or a kind it does not know, on an audio config without an encoder (or
    a non-audio config with one), and on an ``encoder_layers`` that is not
    the encoder segments' depth."""
    kinds = layer_kinds(cfg)
    allowed = _FAMILY_KINDS.get(cfg.family, ())
    bad = sorted({k for k in kinds if k not in allowed})
    enc = layer_kinds(cfg, encoder=True)
    bad_enc = sorted({k for k in enc if k not in _ENCODER_KINDS})
    enc_depth = sum(seg.count for seg in cfg.encoder_segments)
    if cfg.encoder_layers != enc_depth:
        raise ValueError(f"{cfg.name}: encoder_layers={cfg.encoder_layers} but the "
                         f"encoder segments hold {enc_depth} layers")
    if bad or bad_enc or not allowed or bool(enc) != (cfg.family == "audio"):
        raise ValueError(f"{cfg.name}: the port runs the families {FAMILIES} with the kinds "
                         f"{_FAMILY_KINDS} (an audio encoder of {_ENCODER_KINDS}); got family "
                         f"{cfg.family!r}, kinds {bad}, encoder kinds {bad_enc or enc}")
    return kinds


def init_layer(kind: str, cfg: ModelConfig, generator: torch.Generator,
               dev: torch.device) -> dict:
    """One sublayer's random params (an empty dict for ``shared_attn``,
    whose params live in ``params["shared"]``)."""
    if kind in _ATTN_KINDS:
        return {"norm": L.init_rmsnorm(cfg.d_model, dev),
                **init_attn(generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, bias=cfg.qkv_bias)}
    if kind == "moe":
        return {"norm": L.init_rmsnorm(cfg.d_model, dev),
                **M.init_moe(generator, cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.mlp_kind)}
    if kind == "rwkv6":
        return R.init_rwkv6(generator, cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim)
    if kind == "mamba2":
        return S.init_mamba2(generator, cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state,
                             cfg.conv_width)
    if kind == "shared_attn":
        return {}
    return {"norm": L.init_rmsnorm(cfg.d_model, dev),
            **L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, bias=cfg.mlp_bias)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict:
    """Random params on ``device``, drawn from ``generator`` (which must
    live there), with the JAX package's shapes and scales: the decoder
    stack (an encoder-decoder's encoder is ``models.encdec``'s)."""
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
    params["layers"] = [init_layer(kind, cfg, generator, dev) for kind in kinds]
    if "shared_attn" in kinds:
        params["shared"] = {
            "norm1": L.init_rmsnorm(cfg.d_model, dev),
            "attn": init_attn(generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim),
            "norm2": L.init_rmsnorm(cfg.d_model, dev),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind),
        }
    if cfg.rope_theta is None and cfg.family != "ssm":
        # learned positional embeddings (whisper's decoder)
        params["pos_embed"] = {"table": 0.02 * torch.randn(
            (max(32_768, cfg.encoder_seq), cfg.d_model), generator=generator,
            device=dev, dtype=torch.float32)}
    return params


def cache_capacity(kind: str, cfg: ModelConfig, s_ctx: int) -> int | None:
    """Rows of a sublayer's growable KV cache: the context for global
    layers (a shared block's occurrences among them), the window (at most)
    for local ones; None for stateless and recurrent sublayers and for
    cross-attention, whose cache is the encoder's length (never padded to
    the context or paged)."""
    if kind in ("attn", "shared_attn") or (kind == "attn_local" and cfg.window is None):
        return s_ctx
    if kind == "attn_local":
        return min(s_ctx, cfg.window)
    return None


def recurrent_state(kind: str, cfg: ModelConfig, batch: int,
                    device: torch.device | str, dtype: torch.dtype = torch.bfloat16):
    """A sublayer's fixed-size zero decode state on ``device``: an f32
    ``RWKVState`` for rwkv6, an f32 ``MambaState`` for mamba2, and for
    cross_attn an ``AttnCache`` of ``encoder_seq`` rows in ``dtype``; None
    for every other kind.  Dense in both KV layouts."""
    if kind == "rwkv6":
        return R.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_head_dim, device=device)
    if kind == "mamba2":
        return S.init_mamba_state(batch, cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state,
                                  cfg.conv_width, device=device)
    if kind == "cross_attn":
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device))
    return None


def init_cache(cfg: ModelConfig, batch: int, s_ctx: int,
               dtype: torch.dtype, device: torch.device | str) -> list:
    """Pre-allocated decode cache on ``device``: an ``AttnCache`` per
    attention sublayer (each shared_attn occurrence its own; a cross_attn
    one of ``encoder_seq`` rows), the ``recurrent_state`` of each rwkv6 or
    mamba2 sublayer, None per mlp or moe sublayer."""
    cache: list = []
    for kind in check_kinds(cfg):
        state = recurrent_state(kind, cfg, batch, device, dtype)
        cap = cache_capacity(kind, cfg, s_ctx)
        if state is not None or cap is None:
            cache.append(state)
            continue
        shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
        cache.append(AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                               v=torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def _sublayer(kind: str, p: dict, x: torch.Tensor, *, cfg: ModelConfig,
              policy: PrecisionPolicy, mode: str, cache, pos, shared: dict | None,
              enc_x: torch.Tensor | None = None):
    """One pre-norm residual sublayer.  Returns (x, new cache or None,
    aux loss or None).  An rwkv6 or mamba2 layer carries its own norms and
    residuals, and a shared_attn block its two, so they are dispatched
    before the sublayer pre-norm.  ``enc_x``: the encoder's output, which a
    cross_attn sublayer projects at train and prefill."""
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
    if kind == "cross_attn":
        if mode == "decode":
            ckv = cache
        else:       # train / prefill: project the encoder's output once
            b, se, _ = enc_x.shape
            apol = policy.for_("attention")
            ckv = AttnCache(*(L.linear(p[w], enc_x, apol).reshape(
                b, se, cfg.num_kv_heads, cfg.head_dim).to(x.dtype) for w in ("wk", "wv")))
        out, _ = attention(p, xn, mode=mode, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                           policy=policy.for_("attention"), rope_theta=None,
                           softcap=cfg.attn_logit_softcap, cross_kv=ckv, pos=pos)
        return x + out, (ckv if mode in ("prefill", "decode") else None), None
    if kind in _ATTN_KINDS:
        out, nc = attention(
            p, xn, mode=mode, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            policy=policy.for_("attention"), rope_theta=cfg.rope_theta,
            window=cfg.window if kind == "attn_local" else None,
            softcap=cfg.attn_logit_softcap, causal=(mode != "encode"),
            cache=cache if mode == "decode" else None, pos=pos)
        return x + out, (nc if mode in ("prefill", "decode") else None), None
    if kind == "moe":
        out, aux = M.moe_ffn(
            p, xn, num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp_kind,
            policy=policy.for_("moe"), dropless=(mode == "decode"))
        return x + out, None, aux
    return x + L.mlp(p, xn, cfg.mlp_kind, policy.for_("mlp")), None, None


def _periods(segments) -> list[tuple[int, int]]:
    """[start, stop) sublayer ranges of every period of every segment."""
    out, i = [], 0
    for seg in segments:
        for _ in range(seg.count):
            out.append((i, i + len(seg.pattern)))
            i += len(seg.pattern)
    return out


def forward(params: dict, tokens: torch.Tensor | None, cfg: ModelConfig, *,
            policy: PrecisionPolicy, mode: str = "train",
            cache: list | None = None, pos: torch.Tensor | None = None,
            last_only: bool = False, remat: bool = False,
            extra_embeds: torch.Tensor | None = None,
            enc_x: torch.Tensor | None = None,
            ) -> tuple[torch.Tensor, list, torch.Tensor]:
    """Run the LM stack.  tokens (B, S) int; mode train | prefill |
    decode | encode; decode takes the per-row ``pos`` (B,) and updates
    ``cache`` in place.  ``extra_embeds`` (B, S_x, D) go before the token
    embeddings (the VLM's image rows; with ``tokens`` None they are the
    whole input, the encoder's frames).  ``enc_x``: the encoder's output
    for the cross_attn sublayers.  ``mode="encode"`` runs the encoder's
    stack (``enc_layers``, bidirectional) and returns its final-normed
    hidden states in place of logits.  ``last_only`` projects only the
    last position onto the vocabulary (each row of the unembed is
    independent, so its logits equal the full projection's last row).
    ``remat`` recomputes each period's activations in the backward (the
    encoder's too).  Returns (logits f32 | hidden states, cache, aux loss f32:
    the MoE sublayers' sum, 0 without them).
    """
    check_kinds(cfg)
    encode = mode == "encode"
    kinds = layer_kinds(cfg, encoder=encode)
    layers = params["enc_layers" if encode else "layers"]
    dtype = getattr(torch, cfg.activation_dtype)
    if tokens is None:
        x = extra_embeds.to(dtype)
    else:
        x = L.embed(params["embed"], tokens, dtype)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(dtype), x], dim=1)
    x = constrain(x, "residual")
    pe_key = "enc_pos_embed" if encode else "pos_embed"
    if cfg.rope_theta is None and pe_key in params:
        table = params[pe_key]["table"]
        if mode == "decode":    # one row per slot, at its own position
            x = x + table[pos.long().expand(x.shape[0])].to(dtype)[:, None, :]
        else:
            x = x + table[:x.shape[1]].to(dtype)[None]
    new_cache: list = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start, stop in _periods(cfg.encoder_segments if encode else cfg.segments):
        def period(x, start=start, stop=stop):
            ncs, a = [], torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(start, stop):
                x, nc, ai = _sublayer(kinds[i], layers[i], x, cfg=cfg,
                                      policy=policy, mode=mode, pos=pos,
                                      cache=cache[i] if cache is not None else None,
                                      shared=params.get("shared"), enc_x=enc_x)
                x = constrain(x, "residual")   # pin (B: dp, S, D: replicated)
                ncs.append(nc)
                if ai is not None:
                    a = a + ai
            return x, ncs, a

        if remat:
            x, ncs, a = checkpoint(period, x, use_reentrant=False)
        else:
            x, ncs, a = period(x)
        new_cache.extend(ncs)
        aux = aux + a
    if encode:
        return L.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps), new_cache, aux
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
