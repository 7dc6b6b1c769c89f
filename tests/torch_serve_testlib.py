"""The port's twin of ``tests/serve_testlib.py``: the same model-free
engine on ``repro_torch.launch.serve``'s ``Request`` and ``QueueFull``
(submit / step / idle / queue / slot_req / batch / max_queue /
tokens_generated / ticks), so the port's pool, gateway, faults and
autoscaler run the same scripted mechanics as ``repro``'s in
milliseconds.  Token values are a pure function of (rid, index).  Real-
model token parity through the port's pool lives in
tests/test_torch_serve_stack_model.py.  Not collected itself (no
``test_`` prefix)."""

import collections
import time

from repro_torch.launch.serve import QueueFull, Request


def fake_token(rid: int, index: int) -> int:
    return rid * 1000 + index


class FakeEngine:
    """Deterministic stand-in: admission fills free slots in queue
    order, every tick appends one token per occupied slot, a request
    completes after ``max_new_tokens`` tokens."""

    def __init__(self, cfg=None, *, batch_size=2, max_queue=None,
                 metrics=None, replica="0", **_):
        self.cfg = cfg
        self.batch = batch_size
        self.max_queue = max_queue
        self.metrics = metrics
        self.replica = replica
        self.queue: collections.deque[Request] = collections.deque()
        self.slot_req: list[Request | None] = [None] * batch_size
        self.ticks = 0
        self.tokens_generated = 0

    def submit(self, req: Request) -> None:
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(req.rid, len(self.queue), self.max_queue)
        if req.t_submit is None:
            req.t_submit = time.monotonic()
            req.wall_time = time.time()
        self.queue.append(req)

    def _admit_all(self) -> None:
        for i, r in enumerate(self.slot_req):
            if r is None and self.queue:
                req = self.queue.popleft()
                if req.out_tokens:
                    # recovery re-admission (the pool rehomed it after
                    # a replica death): tokens are a pure function of
                    # (rid, index), so resuming at len(out_tokens) is
                    # bit-identical by construction — mirroring the
                    # real engine's re-prefill resume
                    if len(req.out_tokens) < req.max_new_tokens:
                        self.slot_req[i] = req
                    else:
                        req.done = True
                        req.t_done = time.monotonic()
                    continue
                req.t_admit = time.monotonic()
                req.out_tokens.append(fake_token(req.rid, 0))
                req.t_first = time.monotonic()
                self.tokens_generated += 1
                if req.max_new_tokens <= 1:
                    req.done = True
                    req.t_done = time.monotonic()
                else:
                    self.slot_req[i] = req

    def _expire_due(self) -> None:
        for r in [r for r in self.queue
                  if r.deadline_ticks is not None
                  and r.ticks_used >= r.deadline_ticks]:
            self.queue.remove(r)
            r.done = r.expired = True
            r.t_done = time.monotonic()
        for i, r in enumerate(self.slot_req):
            if (r is not None and r.deadline_ticks is not None
                    and r.ticks_used >= r.deadline_ticks):
                r.done = r.expired = True
                r.t_done = time.monotonic()
                self.slot_req[i] = None

    def step(self) -> int:
        self._expire_due()
        self._admit_all()
        n = 0
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.out_tokens.append(
                fake_token(req.rid, len(req.out_tokens)))
            self.tokens_generated += 1
            n += 1
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.t_done = time.monotonic()
                self.slot_req[i] = None
        self.ticks += 1
        for r in self.queue:
            r.ticks_used += 1
        for r in self.slot_req:
            if r is not None:
                r.ticks_used += 1
        return n

    def cancel(self, rid: int) -> bool:
        for i, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                r.done = r.cancelled = True
                r.t_done = time.monotonic()
                self.slot_req[i] = None
                return True
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                r.done = r.cancelled = True
                r.t_done = time.monotonic()
                return True
        return False

    def evacuate(self) -> list:
        orphans = []
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self.slot_req[i] = None
                if not r.done:
                    orphans.append(r)
        while self.queue:
            r = self.queue.popleft()
            if not r.done:
                orphans.append(r)
        return orphans

    def pages_outstanding(self) -> int:
        return 0

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)


def fake_factory(batch_size=2, max_queue=None):
    """engine_factory for ReplicaPool(..., engine_factory=...)."""
    def make(idx, policy):
        return FakeEngine(batch_size=batch_size, max_queue=max_queue,
                          replica=str(idx))
    return make


def make_fake_pool(replicas=2, *, batch_size=2, max_queue=None,
                   metrics=None, routing="least_loaded",
                   max_replicas=None):
    from repro_torch.serve.pool import ReplicaPool
    return ReplicaPool(
        None, None, replicas=replicas, batch_size=batch_size,
        max_queue=max_queue, routing=routing, metrics=metrics,
        max_replicas=max_replicas,
        engine_factory=fake_factory(batch_size, max_queue))
