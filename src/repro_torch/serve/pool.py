"""Replica pool: N in-process ``ServeEngine`` workers behind one
router (twin of ``repro.serve.pool``).

The engine is one continuous-batching process; the pool is the layer
that keeps MANY of them fed under bursty traffic:

  * **least-loaded routing** — a request lands on the active replica
    with the fewest in-flight requests (queued + occupied slots), so a
    replica stalled on long generations stops accumulating queue;
  * **session affinity** — requests carrying a ``session`` key pin to
    the replica that served the session before, so multi-turn traffic
    re-uses that replica's KV slots instead of re-prefilling elsewhere;
  * **bounded admission** — every engine carries the ``max_queue``
    watermark; when the routed replica (affinity) or every candidate
    replica (load routing) is at watermark, ``submit`` raises
    ``QueueFull`` for the gateway to map to backpressure;
  * **elastic active set** — ``scale_to`` grows/shrinks the set of
    replicas taking NEW work (the autoscaler drives it); deactivated
    replicas keep ticking until their in-flight work drains, mirroring
    ``runtime/mesh.resharder_for``'s drain-and-reshape posture.

Replica engines are built lazily on first activation and share one
params tree (read-only, never copied), each on the device the params
live on, so a ``max_replicas=8`` pool costs nothing until load actually
arrives.  On one card the replicas' ticks run in turn, on one host
thread and one stream.

Token outputs are replica-count independent: every engine runs the
same greedy decode on the same params, and engine outputs are
batch-composition independent — so 1-replica and 3-replica serving of
the same request stream are token-identical
(tests/test_torch_serve_stack_model.py).

Fault tolerance (serve.health + serve.faults): every pool step feeds a
per-replica tick heartbeat into a ``HealthMonitor``; a replica that
raises ``ReplicaDead`` or stalls past the hang threshold is declared
dead, its unfinished requests are EVACUATED (freeing its slots and KV
pages through the allocator) and rehomed onto healthy replicas, where
recovery re-prefill makes the resumed streams bit-identical to an
undisturbed run (see ``ServeEngine.admit``).  Quarantined (SUSPECT)
replicas keep draining but take no new work; transient submit errors
fail over to the next candidate and count toward the circuit breaker.
``replace_replica`` (the autoscaler's ``replace`` action) rebuilds a
dead replica's engine and re-enters it half-open (RECOVERING).  A scale
event records the per-replica mesh it was handed (the autoscaler's
``mesh_for``); every engine runs the pool's policy, on the one device
the pool's replicas share.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.core.tree import leaves
from repro_torch.launch.serve import QueueFull, Request, ServeEngine
from repro_torch.serve.health import (HealthMonitor, HealthPolicy, ReplicaDead,
                                      ReplicaState, TransientAdmissionError)
from repro_torch.serve.metrics import TICK_BUCKETS

__all__ = ["ReplicaPool", "Replica", "ScaleEvent", "RecoveryEvent"]


@dataclasses.dataclass
class Replica:
    idx: int
    engine: ServeEngine
    active: bool = True          # takes NEW work; inactive drains only

    @property
    def load(self) -> int:
        """In-flight request count: queued + occupied decode slots."""
        eng = self.engine
        return len(eng.queue) + sum(r is not None for r in eng.slot_req)

    @property
    def queue_space(self) -> bool:
        eng = self.engine
        return eng.max_queue is None or len(eng.queue) < eng.max_queue


@dataclasses.dataclass
class ScaleEvent:
    """One autoscaler/operator scale action, as applied by the pool.

    ``action`` distinguishes elastic resizes from availability repair:
    ``"resize"`` changes the active count on purpose; ``"replace"``
    rebuilds a DEAD replica's engine in place (count recovers, capacity
    was already lost)."""
    tick: int
    old_n: int
    new_n: int
    reason: str = ""
    mesh: object | None = None   # per-replica MeshSpec after the event
    action: str = "resize"

    def describe(self) -> str:
        mesh = f", mesh {self.mesh.describe()}" if self.mesh is not None \
            else ""
        if self.action == "replace":
            return (f"replace replica @tick {self.tick} "
                    f"({self.old_n}->{self.new_n} active{mesh})"
                    + (f" ({self.reason})" if self.reason else ""))
        arrow = "grow" if self.new_n > self.old_n else "shrink"
        return (f"scale {arrow} {self.old_n}->{self.new_n} replicas "
                f"@tick {self.tick}{mesh}"
                + (f" ({self.reason})" if self.reason else ""))


@dataclasses.dataclass
class RecoveryEvent:
    """One request's rehoming after a replica death: ``death_tick`` is
    the pool tick the replica died on; ``recovered_tick`` is the first
    pool tick the request made progress again (a NEW token on the new
    replica, or completion)."""
    rid: int
    replica: int                 # the replica that died
    death_tick: int
    recovered_tick: int

    @property
    def latency_ticks(self) -> int:
        return self.recovered_tick - self.death_tick


class ReplicaPool:
    """Routes requests across N lazily-built engine replicas.

    ``policy`` is shared by every replica.  The default factory builds
    each engine on the device of ``params`` (its first leaf's); pass
    ``engine_factory(idx, policy)`` for anything else.
    """

    def __init__(self, cfg, params, *, replicas: int = 2,
                 batch_size: int = 4, max_ctx: int = 64, policy=None,
                 eos_id: int = 1, max_queue: int | None = None,
                 routing: str = "least_loaded", max_replicas: int | None = None,
                 metrics=None, engine_factory=None,
                 health: HealthPolicy | None = None):
        if replicas < 1:
            raise ValueError(f"need at least 1 replica, got {replicas}")
        if routing not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown routing policy {routing!r}")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_ctx = max_ctx
        self.policy = policy
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.routing = routing
        self.max_replicas = max(max_replicas or replicas, replicas)
        self.metrics = metrics
        self._engine_factory = engine_factory or self._default_factory
        self.replicas: list[Replica] = []
        self._affinity: dict[str, int] = {}
        self._rr = 0                      # round-robin cursor
        self.ticks = 0
        self.scale_events: list[ScaleEvent] = []
        # fault tolerance: heartbeat monitor + rehoming bookkeeping
        self.monitor = HealthMonitor(health, metrics=metrics)
        self.recovery_events: list[RecoveryEvent] = []
        self._orphans: collections.deque[Request] = collections.deque()
        # rid -> (req, dead replica, death tick, tokens at death)
        self._recovering: dict[int, tuple[Request, int, int, int]] = {}
        self._tokens_retired = 0          # counters of replaced engines
        for _ in range(replicas):
            self._activate_one()

    # ------------------------------------------------------- lifecycle

    def _default_factory(self, idx: int, policy) -> ServeEngine:
        eng = ServeEngine(self.cfg, batch_size=self.batch,
                          max_ctx=self.max_ctx, policy=policy,
                          eos_id=self.eos_id, max_queue=self.max_queue,
                          metrics=self.metrics, replica=str(idx),
                          device=leaves(self.params)[0].device)
        eng.load(self.params)
        return eng

    def _activate_one(self) -> Replica:
        for rep in self.replicas:
            if not rep.active \
                    and self.monitor.state(rep.idx) is not ReplicaState.DEAD:
                rep.active = True
                return rep
        idx = len(self.replicas)
        rep = Replica(idx, self._engine_factory(idx, self.policy))
        self.replicas.append(rep)
        self.monitor.register(idx)
        return rep

    @property
    def active_replicas(self) -> list[Replica]:
        return [r for r in self.replicas if r.active]

    @property
    def n_active(self) -> int:
        return sum(r.active for r in self.replicas)

    def scale_to(self, n: int, *, mesh=None, reason: str = "",
                 ) -> ScaleEvent | None:
        """Resize the ACTIVE set to ``n`` (clamped to
        [1, max_replicas]).  Growth builds/reactivates replicas; shrink
        deactivates the highest-index active replicas, which keep
        draining (step() still ticks them) but receive no new work.
        Session pins onto a deactivated replica are dropped so
        follow-up turns re-route.  ``mesh`` is recorded on the event."""
        n = max(1, min(n, self.max_replicas))
        old_n = self.n_active
        if n == old_n:
            return None
        while self.n_active < n:
            self._activate_one()
        if n < old_n:
            for rep in reversed(self.active_replicas):
                if self.n_active <= n:
                    break
                rep.active = False
                self._affinity = {s: i for s, i in self._affinity.items()
                                  if i != rep.idx}
        ev = ScaleEvent(tick=self.ticks, old_n=old_n, new_n=n,
                        reason=reason, mesh=mesh)
        self.scale_events.append(ev)
        if self.metrics is not None:
            self.metrics.counter(
                "serve_scale_events",
                "autoscaler/operator resize actions").inc()
            self.metrics.gauge(
                "serve_active_replicas",
                "replicas accepting new work").set(n)
        return ev

    # --------------------------------------------------------- routing

    def _pick(self, req: Request, *,
              exclude: frozenset = frozenset()) -> Replica:
        # quarantine: SUSPECT/DEAD replicas take no NEW work (the
        # circuit-breaker gate); ``exclude`` drops replicas that
        # already failed this submit's retry loop
        active = [r for r in self.active_replicas
                  if r.idx not in exclude
                  and self.monitor.admittable(r.idx)]
        if req.session is not None:
            idx = self._affinity.get(req.session)
            if idx is not None and self.replicas[idx].active \
                    and idx not in exclude:
                rep = self.replicas[idx]
                if not self.monitor.admittable(idx) \
                        or not rep.queue_space:
                    # Affinity is strict: rehoming the session would
                    # forfeit the KV locality it exists for, so an
                    # overloaded (or quarantined) pinned replica means
                    # backpressure, not a silent re-route.
                    raise QueueFull(req.rid, len(rep.engine.queue),
                                    rep.engine.max_queue)
                return rep
        if not active:
            raise QueueFull(req.rid, 0, self.max_queue)
        if self.routing == "round_robin":
            order = [active[(self._rr + k) % len(active)]
                     for k in range(len(active))]
            for rep in order:
                if rep.queue_space:
                    self._rr = (self._rr + order.index(rep) + 1) \
                        % len(active)
                    return rep
        else:
            for rep in sorted(active, key=lambda r: (r.load, r.idx)):
                if rep.queue_space:
                    return rep
        depth = min(len(r.engine.queue) for r in active)
        raise QueueFull(req.rid, depth, self.max_queue)

    def submit(self, req: Request) -> int:
        """Route + enqueue; returns the replica index serving ``req``.
        Raises QueueFull when the routed replica (session affinity) or
        all candidates (load routing) are at watermark.

        A ``TransientAdmissionError`` from a replica fails over to the
        next candidate (safe to retry: the request was never admitted
        anywhere) and counts toward that replica's circuit breaker."""
        tried: set[int] = set()
        while True:
            rep = self._pick(req, exclude=frozenset(tried))
            try:
                rep.engine.submit(req)      # may itself raise QueueFull
            except TransientAdmissionError:
                self.monitor.note_error(rep.idx)
                tried.add(rep.idx)
                continue
            if req.session is not None:
                self._affinity[req.session] = rep.idx
            return rep.idx

    def replica_for_session(self, session: str) -> int | None:
        return self._affinity.get(session)

    # ------------------------------------------------------------ step

    def step(self) -> int:
        """One pool step: retry stranded orphans, then every replica
        with work admits + ticks (inactive replicas too — they are
        draining, not dead), feeding the heartbeat monitor.  A replica
        that raises ``ReplicaDead`` or stalls past the hang threshold
        is evacuated and its requests rehomed.  Returns tokens decoded
        across the pool."""
        self._retry_orphans()
        total = 0
        for rep in self.replicas:
            if self.monitor.state(rep.idx) is ReplicaState.DEAD:
                continue
            eng = rep.engine
            if eng.idle:
                self.monitor.observe(rep.idx, progressed=False,
                                     has_work=False)
                continue
            before = eng.ticks
            try:
                total += eng.step()
            except ReplicaDead:
                self._on_death(rep)
                continue
            state = self.monitor.observe(
                rep.idx, progressed=eng.ticks > before, has_work=True)
            if state is ReplicaState.DEAD:
                # hang-declared death: the engine never raised, it just
                # stopped making progress while holding work
                self._on_death(rep)
        self.ticks += 1
        self._note_recoveries()
        return total

    # ------------------------------------------------- fault tolerance

    def _on_death(self, rep: Replica) -> None:
        """Declare ``rep`` dead: quarantine it, drop its session pins,
        evacuate its unfinished requests (freeing slots + KV pages) and
        queue them for rehoming onto healthy replicas."""
        self.monitor.note_crash(rep.idx)
        rep.active = False
        self._affinity = {s: i for s, i in self._affinity.items()
                          if i != rep.idx}
        orphans = rep.engine.evacuate()
        for req in orphans:
            req.recoveries += 1
            self._recovering[req.rid] = (
                req, rep.idx, self.ticks, len(req.out_tokens))
            self._orphans.append(req)
        if self.metrics is not None:
            self.metrics.gauge(
                "serve_active_replicas",
                "replicas accepting new work").set(self.n_active)

    def _retry_orphans(self) -> None:
        """Rehome evacuated requests; the recovery re-prefill on the
        receiving engine keeps their streams token-exact.  Requests
        that cannot land anywhere stay queued here and retry next step
        (their tick deadlines keep aging meanwhile).  A transient
        admission error counts toward that replica's breaker and the
        request retries next step (``repro``'s pool lets it escape
        ``step``)."""
        if not self._orphans:
            return
        pending = list(self._orphans)
        self._orphans.clear()
        for req in pending:
            if req.done:
                continue
            if req.deadline_ticks is not None \
                    and req.ticks_used >= req.deadline_ticks:
                req.done = True
                req.expired = True
                req.t_done = time.monotonic()
                if self.metrics is not None:
                    self.metrics.counter(
                        "serve_requests_expired",
                        "requests terminated at their tick "
                        "deadline").inc(replica="pool")
                continue
            try:
                rep = self._pick(req)
                rep.engine.submit(req)
                if req.session is not None:
                    self._affinity[req.session] = rep.idx
                continue
            except QueueFull:
                pass
            except TransientAdmissionError:
                self.monitor.note_error(rep.idx)
            req.ticks_used += 1
            self._orphans.append(req)

    def _note_recoveries(self) -> None:
        """Close the loop on rehomed requests: one is RECOVERED the
        first pool tick it makes progress again (a new token on the new
        replica, or completion)."""
        recovered = []
        for rid, (req, replica, t0, k0) in self._recovering.items():
            if req.expired or req.cancelled:
                recovered.append((rid, None))
            elif req.done or len(req.out_tokens) > k0:
                ev = RecoveryEvent(rid=rid, replica=replica,
                                   death_tick=t0,
                                   recovered_tick=self.ticks)
                recovered.append((rid, ev))
        for rid, ev in recovered:
            del self._recovering[rid]
            if ev is None:
                continue
            self.recovery_events.append(ev)
            if self.metrics is not None:
                self.metrics.counter(
                    "serve_requests_recovered",
                    "requests rehomed after a replica death that "
                    "resumed token-exactly").inc()
                self.metrics.histogram(
                    "serve_recovery_ticks",
                    "replica death to first recovered token, in pool "
                    "ticks", buckets=TICK_BUCKETS).observe(
                        ev.latency_ticks)

    def replace_replica(self, idx: int, *, mesh=None,
                        reason: str = "") -> ScaleEvent:
        """Availability repair (the autoscaler's ``replace`` action,
        distinct from scale-down): rebuild a DEAD replica's engine from
        the factory and re-enter it half-open (RECOVERING: it takes new
        work and is promoted HEALTHY on its first successful tick).
        ``mesh`` is recorded on the event."""
        rep = self.replicas[idx]
        old_n = self.n_active
        # the old engine's lifetime counter dies with it — bank it so
        # pool-level token accounting stays monotonic
        self._tokens_retired += rep.engine.tokens_generated
        for req in rep.engine.evacuate():   # no-op after _on_death
            req.recoveries += 1
            self._orphans.append(req)
        rep.engine = self._engine_factory(idx, self.policy)
        rep.active = True
        self.monitor.mark_recovering(idx)
        ev = ScaleEvent(tick=self.ticks, old_n=old_n,
                        new_n=self.n_active, reason=reason, mesh=mesh,
                        action="replace")
        self.scale_events.append(ev)
        if self.metrics is not None:
            self.metrics.counter(
                "serve_scale_events",
                "autoscaler/operator resize actions").inc()
            self.metrics.gauge(
                "serve_active_replicas",
                "replicas accepting new work").set(self.n_active)
        return ev

    def cancel(self, rid: int) -> bool:
        """Abort a request anywhere in the pool (client disconnect):
        in an engine's queue or slot, or stranded awaiting rehoming."""
        for req in list(self._orphans):
            if req.rid == rid:
                self._orphans.remove(req)
                req.done = True
                req.cancelled = True
                req.t_done = time.monotonic()
                return True
        return any(rep.engine.cancel(rid) for rep in self.replicas)

    def pages_outstanding(self) -> int:
        """KV pages held across every replica (the leak audit: must be
        0 once the pool is idle — evacuation returns a dead replica's
        pages through the same allocator free path as slot recycle)."""
        return sum(r.engine.pages_outstanding() for r in self.replicas)

    def total_queued(self) -> int:
        return sum(len(r.engine.queue) for r in self.replicas)

    def total_inflight(self) -> int:
        return sum(r.load for r in self.replicas) + len(self._orphans)

    @property
    def idle(self) -> bool:
        return not self._orphans \
            and all(r.engine.idle for r in self.replicas)

    @property
    def tokens_generated(self) -> int:
        return self._tokens_retired \
            + sum(r.engine.tokens_generated for r in self.replicas)

    def run(self, requests: list[Request]) -> dict:
        """Serve all requests to completion (batch-driver twin of
        ``ServeEngine.run``); rejections propagate as QueueFull."""
        t0 = time.monotonic()
        tokens0 = self.tokens_generated
        for req in requests:
            self.submit(req)
        guard = 0
        while not self.idle:
            self.step()
            guard += 1
            if guard > 10_000:
                raise RuntimeError("pool serve loop did not converge")
        wall = time.monotonic() - t0
        tokens = self.tokens_generated - tokens0
        lat = [r.latency_s for r in requests if r.latency_s is not None]
        return {
            "requests": len(requests),
            "replicas": self.n_active,
            "tokens": tokens,
            "wall_s": wall,
            "tok_per_s": tokens / max(wall, 1e-9),
            "latency_mean_s": sum(lat) / len(lat) if lat else 0.0,
            "latency_max_s": max(lat) if lat else 0.0,
        }
