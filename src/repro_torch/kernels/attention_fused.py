"""Flash attention on the Hopper tensor cores: prefill forward and
single-token decode (``csrc/attention_fused.cu``).

Replaces the TPU kernels ``repro/kernels/attention_fused.py:_fwd_kernel``
(``pallas_call`` at ``:224``, via ``_fwd_impl``) and ``:_decode_kernel``
(``pallas_call`` at ``:579``).  Both walk the KV sequence in tiles of
``BKV`` = 32 rows with the online softmax (running max m, running sum l,
unnormalised output), so the (Sq, Skv) score tensor never reaches device
memory; both contractions (Q.K^T and P.V) run the precision ladder on
the tensor cores (bf16 / refine_a / bf16x3 / refine_ab; f32 on the CUDA
cores).  Masks: causal, sliding window and tail padding for the forward;
the ring-buffer slot rule ``pos - ((pos - c) mod S) >= 0`` (a floor mod)
or the linear ``c <= pos`` for decode, at a per-row ``pos``.  GQA:
query head h reads kv head ``h // G``; decode gives one block per
(row, kv head) covering the group's G query heads so K/V are read once
per group.  Softcap ``cap * tanh(s / cap)`` before masking.

What bounds them on the H100: their roofline bound is bytes (a few MB
per call, microseconds), but at gemma3-1b's head_dim 256 the design is
bounded by shared memory: a 64 x 256 f32 tile is 64 KB, so the TPU's
128 x 128 blocks do not fit.  The design stages Q, K and V
as bf16 hi/lo pairs (or f32) with a 64-row q block and 32-row KV tiles,
and keeps O in shared memory as an f32 accumulator reloaded into WMMA
fragments (217 KB, one block per SM); a q block walks only the KV tiles
its mask reaches (the TPU kernel's ``_block_live`` as loop bounds).
Decode reads the cache once per tick, so bytes bound it; the kernel
reads it in place in its stored type and stops a linear walk at ``pos``.

Each wrapper has a plain PyTorch twin (``*_plain``) that walks the same
32-row tiles with the same online softmax, so kernel and plain version
round p to bf16 at the same points.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import precision as prec
from repro_torch.kernels import _build
from repro_torch.kernels.gemm_tiled import on_cpu

__all__ = ["flash_attention", "flash_attention_plain", "flash_decode",
           "flash_decode_plain", "FUSED_POLICIES", "BKV", "LAUNCHES"]

BKV = 32
NEG_INF = -1e30
POLICY_CODES = {"bf16": 0, "refine_a": 1, "bf16x3": 2, "refine_ab": 3, "f32": 4}
FUSED_POLICIES = tuple(POLICY_CODES)

# Launch counts of the two kernels, keyed by entry point.
LAUNCHES = {"flash_attention": 0, "flash_decode": 0}


# ------------------------------------------------------------ plain twins

def _policy_dot(spec: str, x: torch.Tensor, y: torch.Tensor,
                policy: str) -> torch.Tensor:
    """einsum under the ladder: the policy's bf16 terms upcast and
    multiplied in f32, summed smallest first; f32 is one exact pass."""
    if policy == "f32":
        return torch.einsum(spec, x.float(), y.float())
    x_terms, y_terms = prec.operand_terms(x, y, policy)
    out = None
    for tx, ty in prec.policy_terms(policy):
        part = torch.einsum(spec, x_terms[tx].float(), y_terms[ty].float())
        out = part if out is None else out + part
    return out


def _pad_kv(x: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[1]) % BKV
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def _online_softmax(q, k, v, keep_fn, softcap, precision):
    """The kernels' KV walk: q (B,Sq,Kv,G,hd), k/v (B,Skv,Kv,hd) padded to
    BKV rows; keep_fn(cols) -> bool mask broadcastable to (B,Kv,G,Sq,BKV).
    Returns (B,Sq,Kv,G,hd) f32."""
    b, sq, kvh, g, hd = q.shape
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], BKV):
        s = _policy_dot("bqkgd,bskd->bkgqs", q, k[:, k0:k0 + BKV], precision)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        cols = k0 + torch.arange(BKV, device=q.device)
        s = torch.where(keep_fn(cols), s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = _policy_dot("bkgqs,bskd->bkgqd", p, v[:, k0:k0 + BKV], precision)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel (same tiles, same masks)."""
    sq, skv = q.shape[1], k.shape[1]
    if not causal:
        window = None
    rows = torch.arange(sq, device=q.device)[:, None]

    def keep_fn(cols):
        keep = (cols[None, :] < skv) & (rows < sq)
        if causal:
            keep = keep & (cols[None, :] <= rows)
            if window is not None:
                keep = keep & (cols[None, :] > rows - window)
        return keep

    return _online_softmax(q, _pad_kv(k), _pad_kv(v), keep_fn, softcap, precision)


def flash_decode_plain(q, k_cache, v_cache, pos, *, window: int | None = None,
                       softcap: float | None = None,
                       precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch twin of the decode kernel."""
    s_cache = k_cache.shape[1]
    pos = pos.to(device=q.device, dtype=torch.int64)[:, None]     # (B, 1)

    def keep_fn(cols):
        c = cols[None, :]
        if window is not None:
            keep = (pos - torch.remainder(pos - c, s_cache) >= 0) & (c < s_cache)
        else:
            keep = (c <= pos) & (c < s_cache)
        return keep[:, None, None, None, :]                      # (B,1,1,1,BKV)

    return _online_softmax(q, _pad_kv(k_cache), _pad_kv(v_cache), keep_fn,
                           softcap, precision)


# ---------------------------------------------------------------- kernels

def _inputs(*xs: torch.Tensor) -> tuple[list[torch.Tensor], int]:
    """All f32 or all bf16, contiguous; returns (tensors, in_bf16)."""
    bf16 = all(x.dtype == torch.bfloat16 for x in xs)
    dtype = torch.bfloat16 if bf16 else torch.float32
    return [x.to(dtype).contiguous() for x in xs], int(bf16)


def _check_policy(precision: str) -> None:
    if precision not in POLICY_CODES:
        raise ValueError(f"fused attention runs {FUSED_POLICIES}; got {precision!r}")


def _check_head_dim(hd: int) -> None:
    if hd % 16 or hd > 256:
        raise ValueError(f"head_dim {hd} unsupported: the kernels take multiples "
                         f"of 16 up to 256")


@functools.cache
def _launchers():
    """(forward, decode) C launchers of the built library, typed once."""
    lib = _build.load("attention_fused")
    c = ctypes
    fwd, dec = lib.attention_fwd_launch, lib.attention_decode_launch
    fwd.argtypes = [c.c_void_p] * 4 + [c.c_int] * 9 + [c.c_float, c.c_int, c.c_void_p, c.c_int]
    dec.argtypes = [c.c_void_p] * 5 + [c.c_int] * 7 + [c.c_float, c.c_int, c.c_void_p, c.c_int]
    fwd.restype = dec.restype = c.c_int
    return fwd, dec


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    precision: str = "bf16") -> torch.Tensor:
    """Fused flash attention in the model's GQA layout.

    q: (B, Sq, Kv, G, hd) pre-scaled; k/v: (B, Skv, Kv, hd).  Returns
    (B, Sq, Kv, G, hd) f32.  CPU tensors run the plain twin; CUDA
    tensors launch the kernel or raise.
    """
    _check_policy(precision)
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, precision=precision)
    b, sq, kvh, g, hd = q.shape
    _check_head_dim(hd)
    (q, k, v), in_bf16 = _inputs(q, k, v)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = _launchers()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), in_bf16,
            b, sq, k.shape[1], kvh, g, hd, int(causal),
            int(window) if (causal and window is not None) else 0,
            float(softcap) if softcap is not None else 0.0,
            POLICY_CODES[precision], torch.cuda.current_stream(q.device).cuda_stream,
            _device_index(q))
    _build.check(rc, "attention_fwd_launch")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_decode(q, k_cache, v_cache, pos, *, window: int | None = None,
                 softcap: float | None = None,
                 precision: str = "bf16") -> torch.Tensor:
    """Single-token fused decode against the post-write dense cache.

    q: (B, 1, Kv, G, hd) pre-scaled; caches (B, S, Kv, hd); pos (B,)
    per-row positions.  ``window`` selects the ring mask.  Returns
    (B, 1, Kv, G, hd) f32.
    """
    _check_policy(precision)
    if q.shape[1] != 1:
        raise ValueError("flash_decode is the single-token cell")
    if on_cpu(q, k_cache, v_cache, pos):
        return flash_decode_plain(q, k_cache, v_cache, pos, window=window,
                                  softcap=softcap, precision=precision)
    b, _, kvh, g, hd = q.shape
    _check_head_dim(hd)
    if g > 16:
        raise ValueError(f"decode kernel covers up to 16 query heads per kv head; got {g}")
    (q, k_cache, v_cache), in_bf16 = _inputs(q, k_cache, v_cache)
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = _launchers()[1](q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            pos.data_ptr(), in_bf16, b, k_cache.shape[1], kvh, g, hd,
            int(window is not None), float(softcap) if softcap is not None else 0.0,
            POLICY_CODES[precision], torch.cuda.current_stream(q.device).cuda_stream,
            _device_index(q))
    _build.check(rc, "attention_decode_launch")
    LAUNCHES["flash_decode"] += 1
    return out
