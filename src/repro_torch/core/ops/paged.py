"""Paged KV cache (twin of ``repro.core.ops.paged``): fixed-size pages
behind a per-slot page table.

    k_pages / v_pages   (P, page_size, Kv, hd)   physical page payload
    page_table          (B, n_logical) int32     per-slot logical->physical

A logical row keeps the meaning it has in the dense cache (row ``pos``
for linear layers, row ``pos % s_cache`` for ring-buffer sliding-window
layers), so every decode mask applies unchanged; only the storage
indirects through the table: logical row ``j`` of slot ``b`` lives at
``(page_table[b, j // page_size], j % page_size)``.

Physical page 0 is the reserved trash page: freed and never-allocated
table entries point there, so the engine tick, which decodes and writes
every slot, active or not, never writes another slot's pages through a
stale table row.  Allocation starts at page 1 (``launch/serve.py`` owns
the host-side free lists).

Optionally the payload is int8, with one f32 scale per (page row, kv
head) in ``k_scale`` / ``v_scale`` (P, page_size, Kv), set at write time
from the row's amax and applied at read time (the gathered reference
path, or in the paged decode kernel).  ``PAGE_QUANT_BOUND`` is the
declared max-abs output error of an int8-page decode against the dense
f32 cache.

Unlike the JAX package, whose arrays are immutable, ``write_kv`` updates
the pool in place; the engine keeps one page table per capacity class,
shared by every layer of that class (the page ids are the same in each
layer's own pool).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime.device import resolve_device

__all__ = [
    "PagedKVCache",
    "PAGE_QUANT_BOUND",
    "init_paged",
    "write_kv",
    "gather_dense",
    "quantize_rows",
    "num_logical_pages",
]

# Declared max-abs output-error bound for int8-page decode against the
# dense f32 cache (U[-1,1]-scale activations; per-row/head amax scales keep
# the value-side error ~0.5/127 of the row amax).
PAGE_QUANT_BOUND = 5e-2


@dataclasses.dataclass
class PagedKVCache:
    """Paged per-slot KV storage (see the module docstring for the layout)."""

    k_pages: torch.Tensor            # (P, ps, Kv, hd) payload (or int8)
    v_pages: torch.Tensor
    page_table: torch.Tensor         # (B, n_logical) int32, 0 = trash page
    k_scale: torch.Tensor | None     # (P, ps, Kv) f32 when quantized
    v_scale: torch.Tensor | None
    s_cache: int                     # logical capacity per slot

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[-4]


def num_logical_pages(s_cache: int, page_size: int) -> int:
    """Logical pages per slot (capacity rounded up to whole pages)."""
    return -(-s_cache // page_size)


def init_paged(batch: int, s_cache: int, kv_heads: int, head_dim: int, *,
               page_size: int, num_pages: int, quant: str | None = None,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda",
               page_table: torch.Tensor | None = None) -> PagedKVCache:
    """All-zero pool with every table entry on the trash page (0), on
    ``device`` (the card unless the caller asks for the CPU).  A shared
    ``page_table`` may be passed in (one per capacity class)."""
    if quant not in (None, "int8"):
        raise ValueError(f"unsupported KV quantization {quant!r}; "
                         f"one of (None, 'int8')")
    dev = resolve_device(device)
    n_log = num_logical_pages(s_cache, page_size)
    payload = torch.int8 if quant == "int8" else dtype
    shape = (num_pages, page_size, kv_heads, head_dim)

    def scale():
        return (torch.zeros(shape[:3], dtype=torch.float32, device=dev)
                if quant == "int8" else None)

    if page_table is None:
        page_table = torch.zeros((batch, n_log), dtype=torch.int32, device=dev)
    elif tuple(page_table.shape) != (batch, n_log):
        raise ValueError(f"page table {tuple(page_table.shape)} does not fit "
                         f"({batch}, {n_log})")
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=payload, device=dev),
        v_pages=torch.zeros(shape, dtype=payload, device=dev),
        page_table=page_table, k_scale=scale(), v_scale=scale(),
        s_cache=s_cache)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize KV rows with one amax scale per (..., head) row.

    x: (..., hd).  Returns (q int8 (..., hd), scale f32 (...,)) with
    x ~= q * scale[..., None]: amax / 127, then a division (not a
    reciprocal multiply) and round-half-to-even, as the JAX package
    computes it, bit for bit.
    """
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=-1), min=1e-30)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is 1 ulp off now and then
    s = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def write_kv(cache: PagedKVCache, k_row: torch.Tensor, v_row: torch.Tensor,
             slot: torch.Tensor) -> PagedKVCache:
    """Write one (B, Kv, hd) KV row per slot at the LOGICAL row ``slot``
    (B,), in place; returns ``cache``.

    The physical target is ``(page_table[b, slot // ps], slot % ps)``.
    Rows whose table entry is the trash page (inactive or unallocated
    slots) land there harmlessly.  Several inactive slots may write the
    trash page in one call: on CUDA, which of the duplicate writes wins
    is not determined, which does not matter because trash columns are
    always masked.  Quantized pools quantize the row and store its scales
    beside it.
    """
    ps = cache.page_size
    slot = slot.long()
    page = cache.page_table.gather(1, (slot // ps)[:, None])[:, 0].long()
    off = slot % ps
    if cache.quantized:
        qk, sk = quantize_rows(k_row)
        qv, sv = quantize_rows(v_row)
        cache.k_pages[page, off] = qk
        cache.v_pages[page, off] = qv
        cache.k_scale[page, off] = sk
        cache.v_scale[page, off] = sv
    else:
        cache.k_pages[page, off] = k_row.to(cache.k_pages.dtype)
        cache.v_pages[page, off] = v_row.to(cache.v_pages.dtype)
    return cache


def gather_dense(cache: PagedKVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense per-slot view: (B, s_cache, Kv, hd) f32, for k and v.

    Unallocated logical pages gather the trash page; the caller's position
    masks exclude their rows exactly as they exclude never-written dense
    rows.  The reference paged decode is this gather followed by the
    unchanged dense decode.
    """
    table = cache.page_table.long()
    b = table.shape[0]

    def pull(pages, scale):
        x = pages[table].float()                 # (B, n_log, ps, Kv, hd)
        if scale is not None:
            x = x * scale[table][..., None]
        return x.reshape(b, -1, *x.shape[3:])[:, :cache.s_cache]

    return (pull(cache.k_pages, cache.k_scale),
            pull(cache.v_pages, cache.v_scale))
