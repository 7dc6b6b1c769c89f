"""Batched serving entry point (twin of ``repro.launch.serve``), dense KV.

  * requests enter an admission queue; a free batch slot is assigned;
  * prefill ingests the prompt and copies the slot's cache rows in;
  * every engine tick decodes ONE token for ALL slots at their own
    per-slot positions (``serve_step.make_engine_tick``);
  * per-slot active/EOS/length masking happens on the device; the host
    reads back only (B,) vectors per tick, never the logits;
  * finished slots are recycled for queued requests.

A staggered batch produces token for token the same outputs as serving
each request alone.  Paged KV, replicas, the gateway, meshes, metrics
and the tile cache wait for their slices (their flags are absent).

    python -m repro_torch.launch.serve --arch gemma3-1b \\
        --backend gemm=cuda --backend attention=cuda_fused
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import execution_policy_for, layer_kinds
from repro_torch.core import ops
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import api
from repro_torch.runtime import serve_step
from repro_torch.runtime.device import resolve_device

__all__ = ["ServeEngine", "Request", "QueueFull", "RecoveryMismatch", "main"]


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
    """

    def __init__(self, cfg, *, batch_size: int, max_ctx: int,
                 policy: PrecisionPolicy | None = None, eos_id: int = 1,
                 max_queue: int | None = None, device: str | torch.device = "cuda"):
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
        self.cache = api.init_cache(self.cfg, self.batch, self.max_ctx,
                                    getattr(torch, self.cfg.activation_dtype),
                                    self.device)

    # ------------------------------------------------------------ slots

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _validate(self, req: Request) -> None:
        # a recovered request re-prefills prompt + out_tokens[:-1]
        plen = len(req.prompt) + max(0, len(req.out_tokens) - 1)
        if plen >= self.max_ctx:
            raise ValueError(f"request {req.rid}: prompt length {plen} does not "
                             f"fit the engine context (max_ctx={self.max_ctx})")

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
        resume = len(req.out_tokens) > 0
        toks = (np.concatenate([np.asarray(req.prompt, np.int32),
                                np.asarray(req.out_tokens[:-1], np.int32)])
                if resume else np.asarray(req.prompt, np.int32))
        prompt = torch.as_tensor(toks, device=self.device)[None].long()
        logits, cache1 = self._prefill(self.params, {"tokens": prompt})
        first = int(torch.argmax(logits[0, -1]))
        if resume:
            if first != req.out_tokens[-1]:
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
            return True
        # the slot will decode: copy its prefill KV into the batch cache
        for full, one in zip(self.cache, cache1):
            if full is not None:
                full.k[slot] = one.k[0].to(full.k.dtype)
                full.v[slot] = one.v[0].to(full.v.dtype)
        self.slot_req[slot] = req
        self.last_tok[slot] = req.out_tokens[-1]
        self.pos[slot] = len(toks)
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
        self.slot_req[slot] = None
        self.active[slot] = False
        self.remaining[slot] = 0

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
    ap.add_argument("--arch", choices=ARCHS, default="gemma3-1b")
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
                         "gemm torch|cuda, attention torch|cuda_fused)")
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
    policy = execution_policy_for(
        cfg, default=args.policy, backends=ops.parse_backend_flags(args.backend),
        require={"attention": ("decode",)})
    print(f"arch={cfg.name} layers={len(layer_kinds(cfg))} device={device} "
          f"backends={dict(policy.backends)} policy={args.policy}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(cfg, gen, device)
    eng = ServeEngine(cfg, batch_size=args.batch, max_ctx=args.max_ctx,
                      policy=policy, max_queue=args.max_queue, device=device)
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
