"""GQA attention with RoPE, sliding windows and dense KV caches (twin of
``repro.models.attention``).

The score/softmax/value pipeline dispatches through the attention
family: the ``torch`` reference is the chunked two-GEMM path here
(``reference_forward`` / ``reference_decode``: contractions through
``peinsum``, online softmax between them); ``cuda_fused`` runs the
flash-attention kernels.  Sliding-window layers keep a ring-buffer
cache of ``window`` rows: slot ``t % window`` holds token ``t`` (RoPE
applied at write time with absolute positions).

The decode path writes the current token's K/V row into the cache IN
PLACE (the JAX package returns an updated copy); ``attention`` returns
the same cache object.  A decode cache may also be a paged pool
(``core.ops.paged.PagedKVCache``): the row goes through the page table
to the same logical slot, and the decode runs the family's
``paged_decode``.  Cross-attention (``cross_kv``: keys and values
projected once from the encoder's output) takes no RoPE and no mask and
runs the family's forward at every mode, a decode step at Sq = 1 too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ops
from repro_torch.core.ops import Route
from repro_torch.core.ops import paged as paged_kv
from repro_torch.core.ops.paged import PagedKVCache
from repro_torch.core.refined_matmul import peinsum
from repro_torch.models import layers as L

__all__ = ["init_attn", "attention", "AttnCache", "rope_table", "apply_rope",
           "reference_forward", "reference_decode", "reference_paged_decode"]

NEG_INF = -1e30


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Kv, hd)
    v: torch.Tensor  # (B, S_cache, Kv, hd)


# ------------------------------------------------------------------ rope

def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables for rotate-half RoPE: (...,) -> (..., head_dim/2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (S, hd/2) or (B, S, hd/2), in x's dtype
    (bf16 products and differences round per op, as in the JAX package)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        sin_, cos_ = sin[None, :, None, :], cos[None, :, None, :]
    else:
        sin_, cos_ = sin[:, :, None, :], cos[:, :, None, :]
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ init

def init_attn(gen: torch.Generator, d_model: int, num_heads: int,
              num_kv_heads: int, head_dim: int, *, bias: bool = False) -> dict:
    return {
        "wq": L.init_linear(gen, d_model, num_heads * head_dim, bias=bias),
        "wk": L.init_linear(gen, d_model, num_kv_heads * head_dim, bias=bias),
        "wv": L.init_linear(gen, d_model, num_kv_heads * head_dim, bias=bias),
        "wo": L.init_linear(gen, num_heads * head_dim, d_model, bias=bias,
                            scale=(num_heads * head_dim) ** -0.5),
    }


# ------------------------------------------------- grouped score helpers

def _scores(q, k, policy, softcap):
    """q: (B,Q,Kv,G,hd) x k: (B,S,Kv,hd) -> (B,Kv,G,Q,S) f32."""
    s = peinsum("bqkgd,bskd->bkgqs", q, k, policy)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _values(p, v, policy):
    """p: (B,Kv,G,Q,S) x v: (B,S,Kv,hd) -> (B,Q,Kv,G,hd) f32."""
    return peinsum("bkgqs,bskd->bqkgd", p, v, policy)


def _flash_over_kv(q, k, v, mask_fn, policy, softcap, kv_chunk: int):
    """Online-softmax attention over KV chunks.  mask_fn(q_idx, k_idx)
    -> bool keep-mask broadcastable to (Q, chunk).  f32 out."""
    b, qlen, kvh, grp, hd = q.shape
    s = k.shape[1]
    if s % kv_chunk:  # pad keys to a chunk multiple; mask the tail
        pad = kv_chunk - s % kv_chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        inner = mask_fn
        mask_fn = lambda qi, ki: inner(qi, ki) & (ki < s)  # noqa: E731
    q_idx = torch.arange(qlen, device=q.device)
    m = torch.full((b, kvh, grp, qlen), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, qlen, kvh, grp, hd), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], kv_chunk):
        kc, vc = k[:, start:start + kv_chunk], v[:, start:start + kv_chunk]
        sc = _scores(q, kc, policy, softcap)                    # (B,Kv,G,Q,c)
        keep = mask_fn(q_idx[:, None],
                       start + torch.arange(kv_chunk, device=q.device)[None, :])
        sc = torch.where(keep[None, None, None], sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale.permute(0, 3, 1, 2)[..., None] + _values(
            p.to(q.dtype), vc, policy)
        m = m_new
    return acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]


def reference_forward(q, k, v, *, causal: bool, window: int | None,
                      softcap: float | None, policy, kv_chunk: int = 2048):
    """The chunked two-GEMM attention path: the ``torch`` attention impl
    and the kernels' parity oracle.  q (B,Sq,Kv,G,hd) pre-scaled; k/v
    (B,Skv,Kv,hd); f32 out."""
    if not causal:
        window = None
    if causal and window is not None:
        mask_fn = lambda qi, ki: (ki <= qi) & (ki > qi - window)  # noqa: E731
    elif causal:
        mask_fn = lambda qi, ki: ki <= qi  # noqa: E731
    else:
        mask_fn = lambda qi, ki: (ki >= 0) & (qi >= -1)  # noqa: E731
    return _flash_over_kv(q, k, v, mask_fn, policy, softcap,
                          kv_chunk=min(kv_chunk, k.shape[1]))


def reference_decode(q, k_cache, v_cache, pos, *, window: int | None,
                     softcap: float | None, policy):
    """Single-token decode against the post-write cache at per-row
    positions (ring-buffer mask when ``window`` is set)."""
    s_cache = k_cache.shape[1]
    jdx = torch.arange(s_cache, device=q.device)[None, :]
    pos = pos.to(torch.int64)[:, None]
    if window is not None:
        keep = pos - torch.remainder(pos - jdx, s_cache) >= 0      # (B, S)
    else:
        keep = jdx <= pos
    sc = _scores(q, k_cache, policy, softcap)                      # (B,Kv,G,1,S)
    sc = torch.where(keep[:, None, None, None], sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, dim=-1)
    return _values(pr.to(q.dtype), v_cache, policy)


def reference_paged_decode(q, cache: PagedKVCache, pos, *,
                           window: int | None, softcap: float | None, policy):
    """Paged decode = page-table gather + the unchanged dense decode.

    The gather reproduces the dense per-slot layout row for row (trash
    rows land where never-written dense rows sit and are masked alike), so
    an unquantized paged decode is bitwise the dense decode; int8 pools are
    dequantized by their stored per-row scales first."""
    k, v = paged_kv.gather_dense(cache)
    return reference_decode(q, k.to(q.dtype), v.to(q.dtype), pos,
                            window=window, softcap=softcap, policy=policy)


# ------------------------------------------------------------- attention

def attention(p: dict, x: torch.Tensor, *, mode: str, num_heads: int,
              num_kv_heads: int, head_dim: int, policy: str | Route,
              rope_theta: float | None = 10_000.0,
              window: int | None = None, softcap: float | None = None,
              causal: bool = True, cache: AttnCache | PagedKVCache | None = None,
              pos: torch.Tensor | None = None, cross_kv: AttnCache | None = None,
              kv_chunk: int = 2048,
              ) -> tuple[torch.Tensor, AttnCache | PagedKVCache | None]:
    """Returns (output (B,S,D) in x.dtype, new or updated cache or None).
    mode: "train" | "prefill" | "decode" | "encode" (the encoder's: no
    cache; ``causal=False`` for its bidirectional attention).  With
    ``cross_kv`` the queries attend to those keys and values (no RoPE, no
    mask) and no cache is returned."""
    b, s, _ = x.shape
    grp = num_heads // num_kv_heads
    dtype = x.dtype

    q = L.linear(p["wq"], x, policy).reshape(b, s, num_kv_heads, grp, head_dim)
    q = (q * head_dim ** -0.5).to(dtype)
    if cross_kv is None:
        k = L.linear(p["wk"], x, policy).reshape(b, s, num_kv_heads, head_dim)
        v = L.linear(p["wv"], x, policy).reshape(b, s, num_kv_heads, head_dim)

    new_cache = None
    if cross_kv is not None:
        out = ops.attention_forward(q, cross_kv.k.to(dtype), cross_kv.v.to(dtype),
                                    causal=False, window=None, softcap=softcap,
                                    policy=policy, kv_chunk=kv_chunk)
    elif mode in ("train", "prefill", "encode"):
        if rope_theta is not None:
            sin, cos = rope_table(torch.arange(s, device=x.device), head_dim,
                                  rope_theta, dtype)
            q = apply_rope(q.reshape(b, s, num_heads, head_dim), sin, cos
                           ).reshape(b, s, num_kv_heads, grp, head_dim)
            k = apply_rope(k.to(dtype), sin, cos)
        k, v = k.to(dtype), v.to(dtype)
        out = ops.attention_forward(q, k, v, causal=causal, window=window,
                                    softcap=softcap, policy=policy,
                                    kv_chunk=kv_chunk)
        if mode == "prefill":
            if window is not None and s > window:
                # ring buffer of the last `window` tokens:
                # slot j <- token (s-1) - ((s-1-j) mod window)
                j = torch.arange(window, device=x.device)
                tok = (s - 1) - torch.remainder(s - 1 - j, window)
                new_cache = AttnCache(k=k[:, tok], v=v[:, tok])
            else:
                new_cache = AttnCache(k=k, v=v)
    elif mode == "decode":
        if cache is None or pos is None or s != 1:
            raise ValueError("decode needs a cache, a (B,) pos and one token")
        pos = pos.expand(b)
        is_paged = isinstance(cache, PagedKVCache)
        s_cache = cache.s_cache if is_paged else cache.k.shape[1]
        if rope_theta is not None:
            sin, cos = rope_table(pos[:, None], head_dim, rope_theta, dtype)
            q = apply_rope(q.reshape(b, 1, num_heads, head_dim), sin, cos
                           ).reshape(b, 1, num_kv_heads, grp, head_dim)
            k = apply_rope(k.to(dtype), sin, cos)
        k, v = k.to(dtype), v.to(dtype)
        slot = torch.remainder(pos, s_cache) if window is not None else pos
        new_cache = cache
        if is_paged:
            # the dense write's logical row, through the page table
            # (inactive rows land on the trash page), in place
            paged_kv.write_kv(cache, k[:, 0], v[:, 0], slot)
            out = ops.attention_paged_decode(q, cache, pos, window=window,
                                             softcap=softcap, policy=policy)
        else:
            row = torch.arange(b, device=x.device)
            cache.k[row, slot] = k[:, 0].to(cache.k.dtype)      # in place
            cache.v[row, slot] = v[:, 0].to(cache.v.dtype)
            out = ops.attention_decode(q, cache.k.to(dtype), cache.v.to(dtype), pos,
                                       window=window, softcap=softcap, policy=policy)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.to(dtype).reshape(b, s, num_heads * head_dim)
    return L.linear(p["wo"], out, policy).to(dtype), new_cache
