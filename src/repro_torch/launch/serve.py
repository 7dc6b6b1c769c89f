"""Batched serving entry point (twin of ``repro.launch.serve``).

  * requests enter an admission queue; a free batch slot is assigned;
  * prefill ingests the prompt and copies the slot's cache rows in (or,
    with ``kv_layout="paged"``, scatters them into pages reserved for the
    request before its prefill, int8-quantized with ``kv_quant="int8"``);
  * every engine tick decodes ONE token for ALL slots at their own
    per-slot positions (``serve_step.make_engine_tick``);
  * per-slot active/EOS/length masking happens on the device; the host
    reads back only (B,) vectors per tick, never the logits;
  * finished slots are recycled for queued requests.

A staggered batch produces token for token the same outputs as serving
each request alone, and an unquantized paged engine the same outputs as
the dense one.  Replicas, the gateway, meshes, metrics and the tile cache
wait for their slices (their flags are absent).

    python -m repro_torch.launch.serve --arch gemma3-1b \\
        --backend gemm=cuda --backend attention=cuda_fused \\
        [--kv-layout paged [--kv-quant int8]]
    python -m repro_torch.launch.serve --arch mixtral-8x7b --backend gemm=cuda \\
        --backend attention=cuda_fused --backend grouped=cuda_grouped
    python -m repro_torch.launch.serve --arch rwkv6-7b --backend gemm=cuda
    python -m repro_torch.launch.serve --arch zamba2-7b --backend gemm=cuda \\
        --backend attention=cuda_fused [--kv-layout paged]
    python -m repro_torch.launch.serve --arch whisper-medium --backend gemm=cuda \\
        --backend attention=cuda_fused --max-ctx 1024 [--kv-layout paged]
    python -m repro_torch.launch.serve --arch internvl2-76b --backend gemm=cuda \\
        --backend attention=cuda_fused --max-ctx 1024 [--kv-layout paged]

``--arch`` takes every architecture: gemma3-1b, starcoder2-15b,
command-r-35b and nemotron-4-340b (dense), mixtral-8x7b and dbrx-132b
(moe), rwkv6-7b (RWKV-6), zamba2-7b (Mamba-2 + shared attention),
whisper-medium (encoder-decoder) and internvl2-76b (image prefix).
Recurrent state (RWKV-6's, Mamba-2's conv and SSD state) and whisper's
cross-attention caches stay dense per slot in both KV layouts.  As in
``repro``, a request carries no media: an audio prefill encodes zero
frames and a vlm prefill prepends zero image embeddings, and the image
rows count against the context.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import execution_policy_for, layer_kinds
from repro_torch.core import ops
from repro_torch.core.ops import paged as paged_kv
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import api
from repro_torch.runtime import serve_step
from repro_torch.runtime.device import resolve_device

__all__ = ["ServeEngine", "Request", "QueueFull", "RecoveryMismatch", "main"]


class _PageAllocator:
    """Host-side free list over ONE paged-pool capacity class.

    Physical page 0 is the reserved trash page (freed table entries point
    there) and is never handed out.  ``alloc`` is all-or-nothing: a
    request it cannot satisfy whole gets None and stays queued instead of
    holding pages it cannot use (frees are whole-request too, so a
    blocked head request fits once enough slots recycle)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        self._free.extend(pages)


class QueueFull(RuntimeError):
    """Admission queue at capacity: the engine refuses the request
    instead of buffering unbounded work."""

    def __init__(self, rid: int, depth: int, max_queue: int):
        super().__init__(f"request {rid}: admission queue full "
                         f"({depth}/{max_queue} queued)")
        self.rid = rid
        self.depth = depth
        self.max_queue = max_queue


class RecoveryMismatch(RuntimeError):
    """Token-exact recovery failed: re-prefilling ``prompt +
    out_tokens[:-1]`` predicted a different token than the one already
    emitted, so recovery refuses to fork the stream."""

    def __init__(self, rid: int, index: int, expected: int, got: int):
        super().__init__(
            f"request {rid}: recovery re-prefill predicted token {got} "
            f"at output index {index} but the original stream emitted "
            f"{expected} — replicas are not bit-identical under this policy")
        self.rid = rid
        self.index = index
        self.expected = expected
        self.got = got


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    deadline_ticks: int | None = None   # in engine ticks (virtual time)
    ticks_used: int = 0
    cancelled: bool = False
    expired: bool = False
    # monotonic-clock latency accounting, seconds
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    wall_time: float | None = None

    @property
    def latency_s(self) -> float | None:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_s(self) -> float | None:
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> float | None:
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


class ServeEngine:
    """Slot-based continuous-batching engine with per-slot positions.

    Slot state (last token, position, active mask, remaining budget)
    lives on the device as (B,) tensors and the tick advances all of it.
    The host touches per-slot state only at admission (prefill + cache
    copy) and when draining the per-tick token/finished vectors.

    ``kv_layout="paged"`` replaces each attention cache by a shared page
    pool (``kv_page_size`` rows per page, ``kv_quant`` None or "int8",
    ``kv_pages`` pages per capacity class, default full capacity); the
    engine owns the per-class free lists and each slot's pages.
    """

    def __init__(self, cfg, *, batch_size: int, max_ctx: int,
                 policy: PrecisionPolicy | None = None, eos_id: int = 1,
                 max_queue: int | None = None, device: str | torch.device = "cuda",
                 kv_layout: str = "dense", kv_page_size: int = 8,
                 kv_quant: str | None = None, kv_pages: int | None = None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; one of ('dense', 'paged')")
        if kv_quant is not None and kv_layout != "paged":
            raise ValueError("kv_quant requires kv_layout='paged'")
        self.kv_layout = kv_layout
        self.kv_page_size = kv_page_size
        self.kv_quant = kv_quant
        self.kv_pages = kv_pages
        self._allocators: dict[int, _PageAllocator] = {}
        self._tables: dict[int, torch.Tensor] = {}
        self._slot_pages: list[dict[int, list[int]] | None] = [None] * batch_size
        self.cfg = cfg
        self.batch = batch_size
        self.max_ctx = max_ctx
        self.device = resolve_device(device)
        self.policy = policy or PrecisionPolicy.uniform("bf16")
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.params = None
        self._tick = serve_step.make_engine_tick(cfg, self.policy, eos_id=eos_id,
                                                 max_ctx=max_ctx)
        self._prefill = serve_step.make_prefill(cfg, self.policy, s_ctx=max_ctx)
        self.cache = None
        self.slot_req: list[Request | None] = [None] * batch_size
        z = dict(dtype=torch.int32, device=self.device)
        self.last_tok = torch.zeros(batch_size, **z)
        self.pos = torch.zeros(batch_size, **z)
        self.active = torch.zeros(batch_size, dtype=torch.bool, device=self.device)
        self.remaining = torch.zeros(batch_size, **z)
        self.queue: collections.deque[Request] = collections.deque()
        self.ticks = 0
        self.tokens_generated = 0

    def load(self, params) -> None:
        """Take params already on the engine's device; allocate the cache
        in the activation dtype (decode writes activation rows into it)."""
        self.params = params
        dtype = getattr(torch, self.cfg.activation_dtype)
        if self.kv_layout == "paged":
            self.cache = serve_step.init_paged_cache(
                self.cfg, self.batch, self.max_ctx, page_size=self.kv_page_size,
                quant=self.kv_quant, num_pages=self.kv_pages, dtype=dtype,
                device=self.device)
            classes = serve_step.paged_classes(
                self.cfg, self.batch, self.max_ctx, page_size=self.kv_page_size,
                num_pages=self.kv_pages)
            self._allocators = {cap: _PageAllocator(n) for cap, n in classes.items()}
            self._tables = {cap: self.cache[i].page_table
                            for i, _, cap in serve_step.attn_cache_walk(self.cfg, self.max_ctx)}
        else:
            self.cache = api.init_cache(self.cfg, self.batch, self.max_ctx, dtype,
                                        self.device)

    # ------------------------------------------------------------ slots

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    @property
    def _n_img(self) -> int:
        """Image rows ahead of every VLM prompt (0 for other families)."""
        return api.context_len(self.cfg, 0)

    def _validate(self, req: Request) -> None:
        # a recovered request re-prefills prompt + out_tokens[:-1]
        plen = len(req.prompt) + max(0, len(req.out_tokens) - 1)
        n_img = self._n_img
        if n_img + plen >= self.max_ctx:
            raise ValueError(f"request {req.rid}: prompt length {plen}"
                             f"{f' (+{n_img} image tokens)' if n_img else ''} does not "
                             f"fit the engine context (max_ctx={self.max_ctx})")

    def _prefill_batch(self, toks: np.ndarray) -> dict:
        """The prefill's inputs: the tokens, and zero frames (audio) or zero
        image embeddings (vlm), as ``repro``'s engine feeds them."""
        batch = {"tokens": torch.as_tensor(toks, device=self.device)[None].long()}
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros((1, self.cfg.encoder_seq, self.cfg.d_model),
                                          device=self.device)
        if self.cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros((1, self._n_img, self.cfg.d_model),
                                                device=self.device)
        return batch

    # -------------------------------------------------------- paged KV

    def _pages_needed(self, req: Request, cap: int) -> int:
        """Worst-case page demand of one request in a capacity class:
        linear layers touch rows [0, prompt + budget), ring layers at most
        ``cap`` slots, so ``min(cap, total)`` covers both."""
        total = self._n_img + len(req.prompt) + req.max_new_tokens
        return paged_kv.num_logical_pages(min(cap, total), self.kv_page_size)

    def _alloc_pages(self, req: Request) -> dict[int, list[int]] | None:
        """All-or-nothing allocation across every capacity class."""
        got: dict[int, list[int]] = {}
        for cap, alloc in self._allocators.items():
            pages = alloc.alloc(self._pages_needed(req, cap))
            if pages is None:
                for c, p in got.items():
                    self._allocators[c].free(p)
                return None
            got[cap] = pages
        return got

    def _free_pages(self, alloc_map: dict[int, list[int]], *,
                    slot: int | None = None) -> None:
        """Return a request's pages to the free lists; when the slot's
        table rows were written (it decoded), repoint them at the trash
        page, so that the stale slot's continuing writes in the tick can
        never reach the freed pages."""
        for cap, pages in alloc_map.items():
            self._allocators[cap].free(pages)
        if slot is not None:
            for table in self._tables.values():
                table[slot] = 0

    def _splice_paged(self, cache1: list, slot: int,
                      alloc_map: dict[int, list[int]]) -> None:
        """Write the slot's page-table rows and scatter its padded dense
        prefill KV into the allocated pages, quantizing in int8 pools.
        Every layer of a capacity class uses the same page ids, each in
        its own pool."""
        ps = self.kv_page_size
        pages = {cap: torch.as_tensor(p, dtype=torch.long, device=self.device)
                 for cap, p in alloc_map.items()}
        for i, _, cap in serve_step.attn_cache_walk(self.cfg, self.max_ctx):
            leaf, dense = self.cache[i], cache1[i]      # dense: AttnCache (1, cap, Kv, hd)
            n = len(alloc_map[cap])

            def to_pages(x):
                # (1, cap, Kv, hd) -> the first n logical pages (n, ps, Kv, hd)
                x = x[0].float()
                x = F.pad(x, (0, 0, 0, 0, 0, n * ps - x.shape[0])) if n * ps > x.shape[0] else x
                return x[:n * ps].reshape(n, ps, *x.shape[1:])

            kp, vp = to_pages(dense.k), to_pages(dense.v)
            if leaf.quantized:
                qk, sk = paged_kv.quantize_rows(kp)
                qv, sv = paged_kv.quantize_rows(vp)
                leaf.k_pages[pages[cap]] = qk
                leaf.v_pages[pages[cap]] = qv
                leaf.k_scale[pages[cap]] = sk
                leaf.v_scale[pages[cap]] = sv
            else:
                leaf.k_pages[pages[cap]] = kp.to(leaf.k_pages.dtype)
                leaf.v_pages[pages[cap]] = vp.to(leaf.v_pages.dtype)
        for cap, table in self._tables.items():
            row = torch.zeros(table.shape[1], dtype=torch.int32)
            row[:len(alloc_map[cap])] = torch.as_tensor(alloc_map[cap], dtype=torch.int32)
            table[slot] = row.to(self.device)           # the tail stays on the trash page

    def pages_outstanding(self) -> int:
        """KV pages currently held by slots (0 on an idle engine; a dense
        engine reports 0)."""
        return sum(a.num_pages - 1 - a.available for a in self._allocators.values())

    def submit(self, req: Request) -> None:
        """Queue a request; ValueError for prompts that cannot fit,
        QueueFull at the ``max_queue`` watermark."""
        self._validate(req)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(req.rid, len(self.queue), self.max_queue)
        if req.t_submit is None:
            req.t_submit = time.monotonic()
            req.wall_time = time.time()
        self.queue.append(req)

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False if none is free.

        The prompt's first sampled token counts against the budget and
        may itself be EOS (then the request completes without a slot).
        A request arriving with ``out_tokens`` is a RECOVERY
        re-admission: the engine re-prefills ``prompt + out_tokens[:-1]``
        and checks that the greedy next token equals the last emitted
        one, raising ``RecoveryMismatch`` otherwise.
        """
        slot = self._free_slot()
        if slot is None:
            return False
        self._validate(req)
        if req.t_submit is None:
            req.t_submit = time.monotonic()
            req.wall_time = time.time()
        alloc_map = None
        if self.kv_layout == "paged":
            # reserve pages before the prefill: the demand is a function of
            # prompt length and budget (a recovery's too), so a refusal
            # costs nothing and leaves no first token to roll back
            alloc_map = self._alloc_pages(req)
            if alloc_map is None:
                return False
        resume = len(req.out_tokens) > 0
        toks = (np.concatenate([np.asarray(req.prompt, np.int32),
                                np.asarray(req.out_tokens[:-1], np.int32)])
                if resume else np.asarray(req.prompt, np.int32))
        logits, cache1 = self._prefill(self.params, self._prefill_batch(toks))
        first = int(torch.argmax(logits[0, -1]))
        if resume:
            if first != req.out_tokens[-1]:
                if alloc_map is not None:
                    self._free_pages(alloc_map)
                raise RecoveryMismatch(req.rid, len(req.out_tokens) - 1,
                                       req.out_tokens[-1], first)
        else:
            req.t_admit = time.monotonic()
            req.out_tokens.append(first)
            req.t_first = time.monotonic()
            self.tokens_generated += 1
        if (req.out_tokens[-1] == self.eos_id
                or len(req.out_tokens) >= req.max_new_tokens):
            req.done = True
            req.t_done = time.monotonic()
            if alloc_map is not None:       # tables never written: no repointing
                self._free_pages(alloc_map)
            return True
        # the slot will decode: copy its prefill KV into the batch cache
        if alloc_map is not None:
            self._splice_paged(cache1, slot, alloc_map)
            self._slot_pages[slot] = alloc_map
        # every dense leaf of the slot's state: KV rows (dense layout), the
        # cross-attention K/V of encoder_seq rows and recurrent state (both
        # layouts: RWKVState's three leaves, MambaState's conv and SSD state)
        for full, one in zip(self.cache, cache1):
            if full is not None and not isinstance(full, paged_kv.PagedKVCache):
                for dst, src in zip(full, one):
                    dst[slot] = src[0].to(dst.dtype)
        self.slot_req[slot] = req
        self.last_tok[slot] = req.out_tokens[-1]
        # the next input sits after the image rows and the prompt
        self.pos[slot] = self._n_img + len(toks)
        self.active[slot] = True
        self.remaining[slot] = req.max_new_tokens - len(req.out_tokens)
        return True

    # ------------------------------------------------------------- tick

    def tick(self) -> int:
        """Decode one token for every slot; returns the number of slots
        that were active at entry (= tokens decoded)."""
        active_before = self.active.cpu().numpy()
        n_active = int(active_before.sum())
        if n_active == 0:
            return 0
        (self.cache, self.last_tok, self.pos, self.remaining, self.active,
         finished) = self._tick(self.params, self.cache, self.last_tok,
                                self.pos, self.active, self.remaining)
        nxt = self.last_tok.cpu().numpy()
        fin = finished.cpu().numpy()
        now = time.monotonic()
        for i in np.flatnonzero(active_before):
            r = self.slot_req[i]
            r.out_tokens.append(int(nxt[i]))
            if fin[i]:
                r.done = True
                r.t_done = now
                self.slot_req[i] = None
                if self._slot_pages[i]:
                    self._free_pages(self._slot_pages[i], slot=int(i))
                    self._slot_pages[i] = None
        self.ticks += 1
        self.tokens_generated += n_active
        return n_active

    def step(self) -> int:
        """Expire overdue work, admit what fits, tick, age in-flight work."""
        self._expire_due()
        while self.queue and self.admit(self.queue[0]):
            self.queue.popleft()
        n = self.tick()
        for r in self.queue:
            r.ticks_used += 1
        for r in self.slot_req:
            if r is not None:
                r.ticks_used += 1
        return n

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    # ------------------------------------------------- fault tolerance

    def _release_slot(self, slot: int) -> None:
        """Slot teardown outside the normal finish (cancel, expiry,
        evacuation): unmask the slot in the tick and reclaim its pages."""
        self.slot_req[slot] = None
        self.active[slot] = False
        self.remaining[slot] = 0
        if self._slot_pages[slot]:
            self._free_pages(self._slot_pages[slot], slot=slot)
            self._slot_pages[slot] = None

    def _finish(self, req: Request, *, cancelled: bool = False,
                expired: bool = False) -> None:
        req.done = True
        req.cancelled = cancelled
        req.expired = expired
        req.t_done = time.monotonic()

    def _expire_due(self) -> list[Request]:
        """Terminate every request past its tick deadline."""
        expired: list[Request] = []
        for r in [r for r in self.queue if r.deadline_ticks is not None
                  and r.ticks_used >= r.deadline_ticks]:
            self.queue.remove(r)
            self._finish(r, expired=True)
            expired.append(r)
        for i, r in enumerate(self.slot_req):
            if (r is not None and r.deadline_ticks is not None
                    and r.ticks_used >= r.deadline_ticks):
                self._finish(r, expired=True)
                self._release_slot(i)
                expired.append(r)
        return expired

    def cancel(self, rid: int) -> bool:
        """Abort a request by id; False when unknown or already done."""
        for i, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self._finish(r, cancelled=True)
                self._release_slot(i)
                return True
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                self._finish(r, cancelled=True)
                return True
        return False

    def evacuate(self) -> list[Request]:
        """Strip every unfinished request off this engine (decoding slots
        in slot order with their partial ``out_tokens``, then the queue
        in FIFO order) so they can be re-admitted elsewhere."""
        orphans: list[Request] = []
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self._release_slot(i)
                if not r.done:
                    orphans.append(r)
        while self.queue:
            r = self.queue.popleft()
            if not r.done:
                orphans.append(r)
        return orphans

    def stats(self, requests: list[Request], wall_s: float) -> dict:
        lat = [r.latency_s for r in requests if r.latency_s is not None]
        qs = [r.queue_s for r in requests if r.queue_s is not None]
        ttft = [r.ttft_s for r in requests if r.ttft_s is not None]
        return {
            "requests": len(requests),
            "ticks": self.ticks,
            "tokens": self.tokens_generated,
            "wall_s": wall_s,
            "tok_per_s": self.tokens_generated / max(wall_s, 1e-9),
            "latency_mean_s": float(np.mean(lat)) if lat else 0.0,
            "latency_max_s": float(np.max(lat)) if lat else 0.0,
            "queue_mean_s": float(np.mean(qs)) if qs else 0.0,
            "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
        }

    def run(self, requests: list[Request]) -> dict:
        """Serve all requests to completion; returns per-run stats."""
        t0 = time.monotonic()
        ticks0, tokens0 = self.ticks, self.tokens_generated
        for req in requests:
            self.submit(req)
        guard = 0
        while not self.idle:
            self.step()
            guard += 1
            if guard > 10_000:
                raise RuntimeError("serve loop did not converge")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats = self.stats(requests, time.monotonic() - t0)
        stats["ticks"] -= ticks0
        stats["tokens"] -= tokens0
        stats["tok_per_s"] = stats["tokens"] / max(stats["wall_s"], 1e-9)
        return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="gemma3-1b",
                    help="a ported architecture: " + ", ".join(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-ctx", type=int, default=64)
    ap.add_argument("--policy", default="bf16",
                    help="default precision policy for every matmul")
    ap.add_argument("--backend", action="append", default=None,
                    metavar="FAMILY=IMPL",
                    help="op-registry routing, repeatable: 'family=impl' "
                         f"(families: {', '.join(ops.families())}; impls: "
                         "gemm torch|cuda|cuda_naive, attention torch|cuda_fused, "
                         "grouped torch|cuda_grouped)")
    ap.add_argument("--kv-layout", choices=("dense", "paged"), default="dense",
                    help="attention KV cache layout: 'dense' per-slot ring "
                         "buffers, or 'paged' fixed-size pages behind a "
                         "per-slot page table (allocated on admission, "
                         "freed on slot recycle)")
    ap.add_argument("--kv-page-size", type=int, default=8,
                    help="rows per KV page (paged layout only)")
    ap.add_argument("--kv-quant", choices=("none", "int8"), default="none",
                    help="paged-page payload: int8 pages with per-(row, "
                         "kv-head) f32 scales, dequantized at read time")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="pages per pool class (default: full capacity + the "
                         "trash page; smaller pools trade admission "
                         "backpressure for memory)")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request deadline in engine ticks")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-queue watermark; past it submissions "
                         "raise QueueFull. Default: unbounded")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs; 'cuda' fails without a card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    # the tick decodes against the KV cache every step: demand the
    # attention impl's decode (and paged_decode) capability up front
    attn_caps = ("decode", "paged_decode") if args.kv_layout == "paged" else ("decode",)
    policy = execution_policy_for(
        cfg, default=args.policy, backends=ops.parse_backend_flags(args.backend),
        require={"attention": attn_caps})
    print(f"arch={cfg.name} layers={len(layer_kinds(cfg))} device={device} "
          f"backends={dict(policy.backends)} policy={args.policy} "
          f"kv={args.kv_layout}{'/' + args.kv_quant if args.kv_layout == 'paged' else ''}",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(cfg, gen, device)
    eng = ServeEngine(cfg, batch_size=args.batch, max_ctx=args.max_ctx,
                      policy=policy, max_queue=args.max_queue, device=device,
                      kv_layout=args.kv_layout, kv_page_size=args.kv_page_size,
                      kv_quant=None if args.kv_quant == "none" else args.kv_quant,
                      kv_pages=args.kv_pages)
    eng.load(params)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(2, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    deadline_ticks=args.deadline_ticks)
            for i in range(args.requests)]
    stats = eng.run(reqs)
    print(f"served {stats['requests']} requests in {stats['ticks']} ticks "
          f"({stats['wall_s']:.2f}s, {stats['tok_per_s']:.1f} tok/s, "
          f"mean latency {stats['latency_mean_s'] * 1e3:.0f}ms)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {len(r.out_tokens)} tokens {r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
