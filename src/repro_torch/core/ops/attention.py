"""The attention family (twin of ``repro.core.ops.attention``): a named
fused op, not a 2-D-reducible einsum.

  ``torch``       the chunked two-GEMM reference (score and value
                  contractions through ``routed_einsum``, online softmax
                  in PyTorch between them); the parity oracle.  Twin of
                  ``xla``.
  ``cuda_fused``  the hand-written flash-attention kernels
                  (``kernels.attention_fused``): the score tile never
                  leaves shared memory and the ladder is fused in the
                  kernel; the backward runs the dq and dk/dv kernels
                  (``vjp``).  Twin of ``pallas_fused``.  It declares only
                  the rungs its kernels fuse (bf16, refine_a, bf16x3,
                  refine_ab, f32), so a route asking it for bf16x6 or a
                  quantized rung fails at route build with the rung named.
                  Its paged decode runs ``kernels.attention_paged``.

The impl object is an ``AttentionOps(forward, decode, paged_decode)``
triple: forward(q, k, v, *, causal, window, softcap, route, kv_chunk),
decode(q, k_cache, v_cache, pos, *, window, softcap, route) and the
optional paged_decode(q, cache, pos, *, window, softcap, route) against a
``core.ops.paged.PagedKVCache``; q (B,Sq,Kv,G,hd) pre-scaled, k/v
(B,Skv,Kv,hd), f32 out.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ops import registry, shard
from repro_torch.core.ops.registry import (LADDER_BOUNDS, OpSpec, Partitioning,
                                           register_family, register_impl)
from repro_torch.core.ops.route import Route, as_route
from repro_torch.kernels import attention_fused, attention_paged

__all__ = ["AttentionOps", "attention_forward", "attention_decode",
           "attention_paged_decode"]


class AttentionOps(NamedTuple):
    """The entry points an attention impl registers."""

    forward: Callable
    decode: Callable
    paged_decode: Callable | None = None


FEATURES = ("decode", "paged_decode", "gqa", "softcap", "masks:causal",
            "masks:sliding", "masks:full")


def _make_problem(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b, s, kv, g, hd = 2, 16, 2, 2, 32

    def r(shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))

    return {"q": r((b, s, kv, g, hd)) * hd ** -0.5,
            "k": r((b, s, kv, hd)), "v": r((b, s, kv, hd))}


def _audit_decode(problem: dict, route: Route) -> torch.Tensor:
    """Decode surface for the static auditor: the make_problem k/v double
    as a post-write dense cache, q's first row as the current token."""
    k = problem["k"]
    pos = torch.full((k.shape[0],), k.shape[1] - 1, dtype=torch.int32, device=k.device)
    return attention_decode(problem["q"][:, :1], k, problem["v"], pos, policy=route)


def _audit_paged_decode(problem: dict, route: Route) -> torch.Tensor:
    """Paged-decode surface: an all-trash bf16 pool (``init_paged``'s
    layout) of the same logical capacity on the problem's device (page
    contents do not matter to a trace)."""
    from repro_torch.core.ops import paged
    k = problem["k"]
    b, s, kv, hd = k.shape
    n_log = paged.num_logical_pages(s, 8)
    shape = (b * n_log + 1, 8, kv, hd)
    cache = paged.PagedKVCache(
        k_pages=torch.zeros(shape, dtype=torch.bfloat16, device=k.device),
        v_pages=torch.zeros(shape, dtype=torch.bfloat16, device=k.device),
        page_table=torch.zeros((b, n_log), dtype=torch.int32, device=k.device),
        k_scale=None, v_scale=None, s_cache=s)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=k.device)
    return attention_paged_decode(problem["q"][:, :1], cache, pos, policy=route)


def _oracle(problem: dict) -> np.ndarray:
    """Dense fp64 causal softmax attention (GQA layout)."""
    qn, kn, vn = (problem[x].double().numpy() for x in ("q", "k", "v"))
    s = qn.shape[1]
    keep = np.arange(s)[None, :] <= np.arange(s)[:, None]
    sc = np.einsum("bqkgd,bskd->bkgqs", qn, kn)
    sc = np.where(keep[None, None, None], sc, -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgqs,bskd->bqkgd", p, vn)


register_family(OpSpec(
    family="attention",
    contract="AttentionOps(forward(q, k, v, *, causal, window, softcap, "
             "route, kv_chunk), decode(q, k_cache, v_cache, pos, *, "
             "window, softcap, route)); q (B,Sq,Kv,G,hd) pre-scaled, "
             "k/v (B,Skv,Kv,hd), f32 out",
    reference="torch",
    label="attention backend",
    layer_families=("attention",),
    make_problem=_make_problem,
    run=lambda problem, route: attention_forward(
        problem["q"], problem["k"], problem["v"], causal=True, policy=route),
    oracle=_oracle,
    error_bound=lambda policy: LADDER_BOUNDS[policy],
    grad_args=("q",),
    # score + value contractions: every pass is two
    audit_contractions=2,
    audit_runs=(("decode", 2, _audit_decode),
                ("paged_decode", 2, _audit_paged_decode)),
    audit_meshes=("dp=4", "dp=2,tp=2"),
))


def _torch_forward(q, k, v, *, causal, window, softcap, route, kv_chunk=2048):
    from repro_torch.models.attention import reference_forward
    return reference_forward(q, k, v, causal=causal, window=window,
                             softcap=softcap, policy=route, kv_chunk=kv_chunk)


def _torch_decode(q, k_cache, v_cache, pos, *, window, softcap, route):
    from repro_torch.models.attention import reference_decode
    return reference_decode(q, k_cache, v_cache, pos, window=window,
                            softcap=softcap, policy=route)


def _torch_paged_decode(q, cache, pos, *, window, softcap, route):
    from repro_torch.models.attention import reference_paged_decode
    return reference_paged_decode(q, cache, pos, window=window,
                                  softcap=softcap, policy=route)


def _fused_forward(q, k, v, *, causal, window, softcap, route, kv_chunk=2048):
    del kv_chunk
    return attention_fused.flash_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        precision=route.precision)


def _fused_decode(q, k_cache, v_cache, pos, *, window, softcap, route):
    return attention_fused.flash_decode(
        q, k_cache, v_cache, pos, window=window, softcap=softcap,
        precision=route.precision)


def _fused_paged_decode(q, cache, pos, *, window, softcap, route):
    return attention_paged.flash_paged_decode(
        q, cache, pos, window=window, softcap=softcap,
        precision=route.precision)


# Batch shards over dp and KV heads over tp for any impl (independent
# slices: bit-equal).  Only the reference additionally sequence-shards
# (sp): its chunked online-softmax walk takes an offset mask, so a KV
# all-gather and local q rows reproduce the one-device arithmetic.  The
# paged pool is per replica and is never sharded.
_ATTN_PARTITIONING_SP = Partitioning(
    specs=(("q", ("dp", "sp", "tp", None, None)),
           ("k", ("dp", None, "tp", None)),
           ("v", ("dp", None, "tp", None)),
           ("out", ("dp", "sp", "tp", None, None))),
    collectives=("all_gather_kv:sp",),
)
_ATTN_PARTITIONING = Partitioning(
    specs=(("q", ("dp", None, "tp", None, None)),
           ("k", ("dp", None, "tp", None)),
           ("v", ("dp", None, "tp", None)),
           ("out", ("dp", None, "tp", None, None))),
)

register_impl("attention", "torch", fused_policies=(),
              features=("vjp", *FEATURES), partitioning=_ATTN_PARTITIONING_SP)(
    AttentionOps(forward=_torch_forward, decode=_torch_decode,
                 paged_decode=_torch_paged_decode))

register_impl("attention", "cuda_fused",
              policies=attention_fused.FUSED_POLICIES,
              fused_policies=attention_fused.FUSED_POLICIES,
              features=("vjp", *FEATURES), partitioning=_ATTN_PARTITIONING)(
    AttentionOps(forward=_fused_forward, decode=_fused_decode,
                 paged_decode=_fused_paged_decode))


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float | None = None,
                      policy: str | Route = "bf16",
                      kv_chunk: int = 2048) -> torch.Tensor:
    """Fused-attention dispatch (train/prefill shapes): q (B,Sq,Kv,G,hd)
    pre-scaled, k/v (B,Skv,Kv,hd); returns (B,Sq,Kv,G,hd) f32."""
    route = as_route(policy)
    impl = registry.get_impl("attention", route.impl("attention"))
    if shard.active_mesh(route.mesh) is not None and impl.capabilities.partitioning:
        return shard.sharded_attention_forward(
            impl, q, k, v, causal=causal, window=window, softcap=softcap, route=route,
            kv_chunk=kv_chunk)
    return impl.fn.forward(q, k, v, causal=causal, window=window,
                           softcap=softcap, route=shard.unsharded_route(route),
                           kv_chunk=kv_chunk)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int | None = None, softcap: float | None = None,
                     policy: str | Route = "bf16") -> torch.Tensor:
    """Single-token decode against the post-write cache at the per-row
    (B,) ``pos``; ``window`` selects ring-buffer vs linear masking."""
    route = as_route(policy)
    impl = registry.get_impl("attention", route.impl("attention"))
    if not impl.capabilities.has("decode"):
        raise ValueError(
            f"attention impl {impl.name!r} does not support capability "
            f"'decode' (features: {sorted(impl.capabilities.features)})")
    if shard.active_mesh(route.mesh) is not None and impl.capabilities.partitioning:
        return shard.sharded_attention_decode(
            impl, q, k_cache, v_cache, pos, window=window, softcap=softcap, route=route)
    return impl.fn.decode(q, k_cache, v_cache, pos, window=window,
                          softcap=softcap, route=shard.unsharded_route(route))


def attention_paged_decode(q: torch.Tensor, cache, pos: torch.Tensor, *,
                           window: int | None = None,
                           softcap: float | None = None,
                           policy: str | Route = "bf16") -> torch.Tensor:
    """Single-token decode against a post-write paged KV cache
    (``core.ops.paged.PagedKVCache``, the current row already written
    through the page table) at the per-row (B,) ``pos``.  Logical rows
    mean what dense rows mean, so the masks are ``attention_decode``'s."""
    route = as_route(policy)
    impl = registry.get_impl("attention", route.impl("attention"))
    if not impl.capabilities.has("paged_decode") or impl.fn.paged_decode is None:
        raise ValueError(
            f"attention impl {impl.name!r} does not support capability "
            f"'paged_decode' (features: {sorted(impl.capabilities.features)}); "
            f"route decode to a paged-capable impl, e.g. "
            f"{registry.reference_impl('attention')!r}")
    return impl.fn.paged_decode(q, cache, pos, window=window, softcap=softcap,
                                route=shard.unsharded_route(route))
