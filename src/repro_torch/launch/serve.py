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
the dense one.  ``--replicas`` puts a replica pool in front of the engine
and ``--gateway-port`` the HTTP gateway in front of the pool
(``repro_torch.serve``).  ``--mesh dp=2,tp=2`` (or ``auto`` with
``--nprocs``) serves one engine over a mesh of ranks, one process a rank
(``runtime.world``): every rank runs the same requests through the
mesh-carrying policy, whose routed ops shard over the mesh and hand every
rank the whole result, and rank 0 reports; the paged pool stays per rank.
The tile cache waits for its slice (its flag is absent).

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
    python -m repro_torch.launch.serve --arch gemma3-1b --backend gemm=cuda \\
        --backend attention=cuda_fused --replicas 2 [--gateway-port 8080]
    python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke --device cpu \\
        --backend grouped=cuda_grouped --mesh ep=2,tp=2

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
import sys
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
    """Token-exact recovery failed: replaying the stream (the prompt's
    prefill, then ``out_tokens[:-1]`` decoded one by one) predicted a
    different token than the one already emitted at ``index``, so recovery
    refuses to fork the stream."""

    def __init__(self, rid: int, index: int, expected: int, got: int):
        super().__init__(
            f"request {rid}: recovery replay predicted token {got} "
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
    session: str | None = None   # pool-level affinity key (multi-turn)
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    deadline_ticks: int | None = None   # in engine ticks (virtual time)
    ticks_used: int = 0
    cancelled: bool = False
    expired: bool = False
    recoveries: int = 0          # rehomings after a replica death
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

    ``metrics`` is a duck-typed registry (``counter`` / ``gauge`` /
    ``histogram``, e.g. ``repro_torch.serve.metrics.MetricsRegistry``)
    fed ``repro``'s series labelled ``replica``; the hooks read only host
    values the engine already holds, so they add no device read.
    """

    def __init__(self, cfg, *, batch_size: int, max_ctx: int,
                 policy: PrecisionPolicy | None = None, eos_id: int = 1,
                 max_queue: int | None = None, metrics=None, replica: str = "0",
                 device: str | torch.device = "cuda",
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
        self.metrics = metrics
        self.replica = replica
        self.params = None
        self._tick = serve_step.make_engine_tick(cfg, self.policy, eos_id=eos_id,
                                                 max_ctx=max_ctx)
        self._prefill = serve_step.make_prefill(cfg, self.policy, s_ctx=max_ctx)
        self._decode = serve_step.make_decode(cfg, self.policy)
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
        # a recovered request replays out_tokens[:-1] after its prompt
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

    # -------------------------------------------------------- metrics

    def _m_queue_depth(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge(
                "serve_queue_depth", "requests awaiting a free slot").set(
                    len(self.queue), replica=self.replica)

    def _m_occupancy(self) -> None:
        if self.metrics is not None:
            occupied = sum(r is not None for r in self.slot_req)
            self.metrics.gauge(
                "serve_slot_occupancy",
                "fraction of decode slots holding a request").set(
                    occupied / self.batch, replica=self.replica)

    def submit(self, req: Request) -> None:
        """Queue a request; ValueError for prompts that cannot fit,
        QueueFull at the ``max_queue`` watermark."""
        self._validate(req)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.metrics is not None:
                self.metrics.counter(
                    "serve_requests_rejected",
                    "submissions refused at the queue watermark").inc(
                        replica=self.replica)
            raise QueueFull(req.rid, len(self.queue), self.max_queue)
        if req.t_submit is None:
            req.t_submit = time.monotonic()
            req.wall_time = time.time()
        self.queue.append(req)
        if self.metrics is not None:
            self.metrics.counter(
                "serve_requests_submitted",
                "requests accepted into the admission queue").inc(
                    replica=self.replica)
            self._m_queue_depth()

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False if none is free.

        The prompt's first sampled token counts against the budget and
        may itself be EOS (then the request completes without a slot).
        A request arriving with ``out_tokens`` is a RECOVERY
        re-admission: the engine prefills the prompt, then replays
        ``out_tokens[:-1]`` through the slot one decode step at a time
        (``_replay``), checking that each greedy prediction equals the
        token emitted there and raising ``RecoveryMismatch`` otherwise.
        ``repro`` re-prefills ``prompt + out_tokens[:-1]`` in one call; at
        bf16 activations that prefill's K/V round apart from the decode's
        now and then, and the resumed stream can fork.  The replay writes
        the K/V the stream's own decode wrote, wherever a row's decode does
        not depend on its slot or on the other rows.
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
        toks = np.asarray(req.prompt, np.int32)
        logits, cache1 = self._prefill(self.params, self._prefill_batch(toks))
        first = int(torch.argmax(logits[0, -1]))
        if resume:
            if first != req.out_tokens[0]:
                if alloc_map is not None:
                    self._free_pages(alloc_map)
                raise RecoveryMismatch(req.rid, 0, req.out_tokens[0], first)
        else:
            req.t_admit = time.monotonic()
            req.out_tokens.append(first)
            req.t_first = time.monotonic()
            self.tokens_generated += 1
            if self.metrics is not None:
                self.metrics.histogram(
                    "serve_queue_wait_seconds", "submit-to-admission wait").observe(
                        req.queue_s, replica=self.replica)
                self.metrics.histogram(
                    "serve_ttft_seconds", "submit-to-first-token latency").observe(
                        req.ttft_s, replica=self.replica)
                # the prefill's token is generated here, before the slot ticks
                self.metrics.counter("serve_tokens", "decoded tokens").inc(
                    1, replica=self.replica)
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
        if resume:
            try:
                self._replay(req, slot)
            except RecoveryMismatch:
                if alloc_map is not None:
                    self._free_pages(alloc_map, slot=slot)
                    self._slot_pages[slot] = None
                raise
        self.slot_req[slot] = req
        self.last_tok[slot] = req.out_tokens[-1]
        # the next input sits after the image rows, the prompt and the
        # tokens already fed back
        self.pos[slot] = self._n_img + len(toks) + len(req.out_tokens) - 1
        self.active[slot] = True
        self.remaining[slot] = req.max_new_tokens - len(req.out_tokens)
        return True

    def _replay(self, req: Request, slot: int) -> None:
        """Decode ``out_tokens[:-1]`` through ``slot`` one step at a time
        after its prompt was spliced in, each prediction held to the token
        emitted next.  Each step is a decode of the whole batch, as a tick
        is, so the slot's row is computed as the stream's own ticks computed
        it.  The other rows are left as they were: an attention row rewrites
        the K/V of its pending token at its position, which its next tick
        writes again, and recurrent state, which the decode returns anew,
        is copied back for ``slot`` only."""
        pos0 = self._n_img + len(req.prompt)
        for i, tok in enumerate(req.out_tokens[:-1]):
            toks, pos = self.last_tok.clone(), self.pos.clone()
            toks[slot], pos[slot] = tok, pos0 + i
            logits, new = self._decode(self.params, self.cache, toks[:, None], pos)
            for full, got in zip(self.cache, new):
                if full is not None and not isinstance(full, paged_kv.PagedKVCache):
                    for dst, src in zip(full, got):
                        if src is not dst:
                            dst[slot] = src[slot]
            got_tok = int(torch.argmax(logits[slot, -1]))
            if got_tok != req.out_tokens[i + 1]:
                raise RecoveryMismatch(req.rid, i + 1, req.out_tokens[i + 1], got_tok)

    # ------------------------------------------------------------- tick

    def tick(self) -> int:
        """Decode one token for every slot; returns the number of slots
        that were active at entry (= tokens decoded)."""
        active_before = self.active.cpu().numpy()
        n_active = int(active_before.sum())
        if n_active == 0:
            self._m_occupancy()
            return 0
        t0 = time.monotonic()
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
        if self.metrics is not None:
            dt = now - t0
            self.metrics.histogram(
                "serve_tick_seconds", "one engine decode tick (all active slots)").observe(
                    dt, replica=self.replica)
            # one tick is one token per active slot: a slot's inter-token
            # latency is the tick's duration
            self.metrics.histogram(
                "serve_inter_token_seconds", "per-slot inter-token latency").observe(
                    dt, replica=self.replica)
            self.metrics.counter("serve_tokens", "decoded tokens").inc(
                n_active, replica=self.replica)
            self.metrics.gauge(
                "serve_tokens_per_s", "decode throughput over the last tick").set(
                    n_active / max(dt, 1e-9), replica=self.replica)
            self._m_occupancy()
        return n_active

    def step(self) -> int:
        """Expire overdue work, admit what fits, tick, age in-flight work."""
        self._expire_due()
        while self.queue and self.admit(self.queue[0]):
            self.queue.popleft()
        self._m_queue_depth()
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
        if expired and self.metrics is not None:
            self.metrics.counter(
                "serve_requests_expired",
                "requests terminated at their tick deadline").inc(
                    len(expired), replica=self.replica)
        return expired

    def cancel(self, rid: int) -> bool:
        """Abort a request by id (client disconnect); False when unknown
        or already done."""
        for i, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self._finish(r, cancelled=True)
                self._release_slot(i)
                break
        else:
            for r in self.queue:
                if r.rid == rid:
                    self.queue.remove(r)
                    self._finish(r, cancelled=True)
                    break
            else:
                return False
        if self.metrics is not None:
            self.metrics.counter(
                "serve_requests_cancelled",
                "requests aborted before completion (client disconnect)").inc(
                    replica=self.replica)
        return True

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


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind a least-loaded router with "
                         "session affinity (repro_torch.serve.pool), sharing "
                         "one params tree on the device; 1 = the single engine")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-replica admission-queue watermark; past it "
                         "submissions raise QueueFull (the gateway answers "
                         "429 + Retry-After). Default: unbounded")
    ap.add_argument("--gateway-port", type=int, default=None,
                    help="serve the asyncio HTTP/JSON gateway (token "
                         "streaming, /metrics, /healthz, backpressure) on this "
                         "port instead of running the synthetic batch")
    ap.add_argument("--gateway-host", default="127.0.0.1",
                    help="address the gateway binds (default: loopback only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs; 'cuda' fails without a card")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="device mesh: 'dp=2,tp=2,ep=2' (any subset), 'auto' (fit the "
                         "rank count), or 'none' (default, one device).  Every routed "
                         "impl must declare a Partitioning")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="ranks to start (default: the mesh's size; for --mesh auto the "
                         "visible cards on cuda, 1 on cpu)")
    ap.add_argument("--share-card", action="store_true",
                    help="allow several ranks on one card (gloo collectives)")
    return ap


def _serve_policy(args, cfg, mesh=None):
    # the tick decodes against the KV cache every step: demand the
    # attention impl's decode (and paged_decode) capability up front
    attn_caps = ("decode", "paged_decode") if args.kv_layout == "paged" else ("decode",)
    return execution_policy_for(
        cfg, default=args.policy, backends=ops.parse_backend_flags(args.backend),
        require={"attention": attn_caps}, mesh=mesh)


def _serve_rank(rank: int, world_size: int, argv: list[str], mesh_text: str):
    """One rank of a mesh-served engine (``runtime.world.spawn``)."""
    from repro_torch.core.ops.shard import MeshSpec
    from repro_torch.runtime import world
    args = _parser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    policy = _serve_policy(args, cfg, MeshSpec.parse(mesh_text))
    return _serve(args, cfg, policy, world.rank_device(args.device, rank), report=rank == 0)


def main(argv=None) -> None:
    from repro_torch.runtime import mesh as meshlib
    from repro_torch.runtime import world
    from repro_torch.runtime.monitor import run_header
    argv = list(argv) if argv is not None else None
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    n = args.nprocs
    if n is None and args.mesh is not None and args.mesh.strip().lower() == "auto":
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = meshlib.resolve_mesh_spec(args.mesh, cfg, n_devices=n)
    ranks = mesh.size if mesh is not None else 1
    if n is not None and n != ranks:
        raise SystemExit(f"--mesh {args.mesh!r} places {ranks} rank(s); --nprocs is {n}")
    policy = _serve_policy(args, cfg, mesh)
    print(run_header(args.arch, policy=policy, mesh=policy.mesh), flush=True)
    if ranks == 1:
        _serve(args, cfg, policy, device)
        return
    if args.replicas > 1 or args.gateway_port is not None:
        raise SystemExit("--mesh serves one engine over its ranks; --replicas and "
                         "--gateway-port run replicas on one device")
    world.spawn(_serve_rank, ranks, args=(argv if argv is not None else sys.argv[1:],
                                          mesh.describe()),
                device=device.type, share_card=args.share_card, timeout=86400.0)


def _serve(args, cfg, policy, device, *, report: bool = True) -> dict:
    """Serve the CLI's requests on ``device`` (one rank's engine on a
    mesh); prints the stats where ``report``."""
    print_ = print if report else (lambda *a, **k: None)
    print_(f"arch={cfg.name} layers={len(layer_kinds(cfg))} device={device} "
           f"backends={dict(policy.backends)} policy={args.policy} "
           f"kv={args.kv_layout}{'/' + args.kv_quant if args.kv_layout == 'paged' else ''}",
           flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(cfg, gen, device)
    kv_kwargs = dict(kv_layout=args.kv_layout, kv_page_size=args.kv_page_size,
                     kv_quant=None if args.kv_quant == "none" else args.kv_quant,
                     kv_pages=args.kv_pages)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(2, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    deadline_ticks=args.deadline_ticks)
            for i in range(args.requests)]

    if args.replicas > 1 or args.gateway_port is not None:
        # the serve stack: a replica pool, optionally behind the gateway
        # (imported here: repro_torch.serve imports this module)
        from repro_torch.serve.metrics import MetricsRegistry
        from repro_torch.serve.pool import ReplicaPool
        registry = MetricsRegistry()

        def factory(idx, pol):
            e = ServeEngine(cfg, batch_size=args.batch, max_ctx=args.max_ctx,
                            policy=pol, max_queue=args.max_queue, metrics=registry,
                            replica=str(idx), device=device, **kv_kwargs)
            e.load(params)
            return e

        pool = ReplicaPool(cfg, params, replicas=args.replicas, batch_size=args.batch,
                           max_ctx=args.max_ctx, policy=policy, max_queue=args.max_queue,
                           metrics=registry, engine_factory=factory)
        if args.gateway_port is not None:
            import asyncio

            from repro_torch.serve.gateway import Gateway
            if device.type == "cuda":
                # the pump thread launches every kernel: build them first
                from repro_torch.kernels import _build
                _build.build_all()
            gw = Gateway(pool, host=args.gateway_host, port=args.gateway_port,
                         metrics=registry)
            print(f"gateway: listening on {args.gateway_host}:{args.gateway_port} "
                  f"({args.replicas} replica(s), max_queue={args.max_queue})", flush=True)
            asyncio.run(gw.serve_forever())
            return
        stats = pool.run(reqs)
        print_(f"pool served {stats['requests']} requests across {stats['replicas']} "
               f"replicas ({stats['wall_s']:.2f}s, {stats['tok_per_s']:.1f} tok/s)")
        for r in reqs[:3]:
            print_(f"  req {r.rid}: {len(r.out_tokens)} tokens {r.out_tokens[:8]}...")
        return stats

    eng = ServeEngine(cfg, batch_size=args.batch, max_ctx=args.max_ctx,
                      policy=policy, max_queue=args.max_queue, device=device,
                      **kv_kwargs)
    eng.load(params)
    stats = eng.run(reqs)
    print_(f"served {stats['requests']} requests in {stats['ticks']} ticks "
           f"({stats['wall_s']:.2f}s, {stats['tok_per_s']:.1f} tok/s, "
           f"mean latency {stats['latency_mean_s'] * 1e3:.0f}ms)")
    for r in reqs[:3]:
        print_(f"  req {r.rid}: {len(r.out_tokens)} tokens {r.out_tokens[:8]}...")
    return {**stats, "tokens": [r.out_tokens for r in reqs]}


if __name__ == "__main__":
    main()
