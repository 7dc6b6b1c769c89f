"""Paged-KV decode on the Hopper tensor cores (``csrc/attention_paged.cu``).

Replaces the TPU kernel ``repro/kernels/attention_paged.py:_paged_kernel``
(``pallas_call`` at ``attention_paged.py:163``): single-token decode
against a shared page pool ``(P, page_size, Kv, hd)`` read through a
per-slot page table ``(B, n_log)``.  Logical column ``c`` of slot ``b``
lives at ``(table[b, c // page_size], c % page_size)``; the masks are the
dense decode's (ring layers keep ``pos - ((pos - c) mod s_cache) >= 0``,
linear layers ``c <= pos``), and trash-page columns are always masked
because they lie past ``pos`` or in never-written ring slots.  int8 pools
are dequantized in the kernel, ``k * k_scale[row, head]`` in f32, before
the ladder's dots.

What bounds it on the H100: bytes.  At the serve shape (B = 4, one kv
head, hd 256) a tick reads ~2 MB of bf16 KV on a 512-row ring and ~4 MB
on a 1024-row linear cache; int8 pages halve that, plus 4 bytes of scale
per row and head.  The design: the TPU kernel scalar-prefetches the table
and walks one page per grid step; here a block loads its own table
entries and gathers each row of the dense decode's 32-row KV tile
(``BKV``) through them, reusing the dense kernel's online softmax and
ladder code (``csrc/flash_common.cuh``), its split of the KV walk over
CTAs at the bf16 rung included (``decode_splits``, the dense rule, so
both split alike).  With page sizes that divide 32 an unquantized pool
then sums in the dense kernel's order, which is what makes the paged
engine token-exact against the dense engine on the card.  The walk stops
at ``pos``, so unallocated pages are never read.

The plain twin is ``gather_dense`` followed by ``flash_decode_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.ops.paged import PagedKVCache, gather_dense
from repro_torch.kernels import _build
from repro_torch.kernels import _trace
from repro_torch.kernels.attention_fused import (POLICY_CODES, _check_head_dim,
                                                 _check_policy, _device_index, _sm_count,
                                                 decode_site, decode_splits, flash_decode_plain)
from repro_torch.kernels.gemm_tiled import SPLIT_ARGTYPES, on_cpu, split_workspace

__all__ = ["flash_paged_decode", "flash_paged_decode_plain", "LAUNCHES", "SPLIT_LAUNCHES"]

LAUNCHES = 0
SPLIT_LAUNCHES = 0   # launches whose KV walk ran split over CTAs

# payload codes of the kernel: f32, bf16, int8 with per-row scales
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@_trace.plain_twin
def flash_paged_decode_plain(q, cache: PagedKVCache, pos, *,
                             window: int | None = None,
                             softcap: float | None = None,
                             precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch twin: gather (and dequantize) the pool into the dense
    per-slot layout, then the dense decode kernel's plain twin."""
    k, v = gather_dense(cache)
    return flash_decode_plain(q, k, v, pos, window=window, softcap=softcap,
                              precision=precision)


@functools.cache
def _launcher():
    fn = _build.load("attention_paged").attention_paged_decode_launch
    c = ctypes
    fn.argtypes = [c.c_void_p] * 8 + [c.c_int] * 10 + [c.c_float, c.c_int, *SPLIT_ARGTYPES,
                                                        c.c_void_p, c.c_int]
    fn.restype = c.c_int
    return fn


def flash_paged_decode(q, cache: PagedKVCache, pos, *,
                       window: int | None = None,
                       softcap: float | None = None,
                       precision: str = "bf16") -> torch.Tensor:
    """Single-token fused decode against a post-write paged KV cache.

    q: (B, 1, Kv, G, hd) pre-scaled; ``cache`` a ``PagedKVCache`` whose
    current row was already written (``paged.write_kv``); pos: (B,)
    per-row positions.  ``window`` selects the ring mask, with
    ``s_cache = cache.s_cache``.  Returns (B, 1, Kv, G, hd) f32.  CPU
    tensors run the plain twin; CUDA tensors launch the kernel or raise.
    """
    _check_policy(precision)
    if q.shape[1] != 1:
        raise ValueError("flash_paged_decode is the single-token cell")
    pools = [cache.k_pages, cache.v_pages, cache.page_table]
    if cache.quantized:
        pools += [cache.k_scale, cache.v_scale]
    if _trace.ACTIVE:
        return _trace.launch(decode_site("flash_paged_decode", "attention_paged_decode_launch",
                                         q, cache.s_cache, precision), q, pos, *pools)
    if on_cpu(q, pos, *pools):
        return flash_paged_decode_plain(q, cache, pos, window=window,
                                        softcap=softcap, precision=precision)
    global LAUNCHES, SPLIT_LAUNCHES
    b, _, kvh, g, hd = q.shape
    _check_head_dim(hd)
    if g > 16:
        raise ValueError(f"decode kernel covers up to 16 query heads per kv head; got {g}")
    kv_type = _KV_TYPES.get(cache.k_pages.dtype)
    if kv_type is None or cache.v_pages.dtype != cache.k_pages.dtype:
        raise ValueError(f"paged pools must be f32, bf16 or int8; got "
                         f"{cache.k_pages.dtype} / {cache.v_pages.dtype}")
    if (kv_type == 2) != cache.quantized:
        raise ValueError("int8 pools need their scales, and only int8 pools have them")
    table = cache.page_table
    if table.dtype != torch.int32 or table.shape[0] != b:
        raise ValueError(f"page table must be int32 (B, n_log); got {table.dtype} "
                         f"{tuple(table.shape)}")
    if tuple(cache.k_pages.shape[-2:]) != (kvh, hd):
        raise ValueError(f"pool rows {tuple(cache.k_pages.shape)} do not match q {tuple(q.shape)}")
    q = q if q.dtype in (torch.float32, torch.bfloat16) else q.float()
    q, table = q.contiguous(), table.contiguous()
    kp, vp = cache.k_pages.contiguous(), cache.v_pages.contiguous()
    ks = cache.k_scale.contiguous() if cache.quantized else None
    vs = cache.v_scale.contiguous() if cache.quantized else None
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    index, stream = _device_index(q), torch.cuda.current_stream(q.device).cuda_stream
    splits = decode_splits(b, kvh, cache.s_cache, _sm_count(index), precision)
    rc = _launcher()(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        table.data_ptr(), out.data_ptr(), pos.data_ptr(),
        int(q.dtype == torch.bfloat16), kv_type, b, cache.s_cache, table.shape[1],
        cache.page_size, kvh, g, hd, int(window is not None),
        float(softcap) if softcap is not None else 0.0, POLICY_CODES[precision],
        splits, *split_workspace(index, stream), stream, index)
    _build.check(rc, "attention_paged_decode_launch")
    LAUNCHES += 1
    SPLIT_LAUNCHES += splits > 1
    return out
