"""Load-driven autoscaler over the replica pool (twin of
``repro.serve.autoscale``).

Two signals, both cheap host-side reads the pool already maintains:

  * **queue pressure** — queued requests per active replica.  Above
    ``queue_high`` the batch layer cannot hide the backlog and a
    replica is added; below ``queue_low`` (with low slot occupancy)
    a replica is drained away.
  * **decode throughput** — a rolling window of tokens/step per active
    replica.  Scaling down additionally requires the pool to be
    producing little (otherwise a momentarily empty queue between
    bursts would flap the replica set).

``repro`` re-splits the device budget across the new active count at
every scale event and re-resolves a per-replica mesh for the replicas
built after it.  The port has no mesh yet (ROADMAP A item 7, which
brings the re-resolution): ``mesh_for`` returns None, one device, which
is what ``repro`` resolves on a single-device host, so an event is
purely a replica-count change.

Deterministic by construction (tick-driven, no wall clock), so the
loadgen's autoscale sweeps are reproducible run to run.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.serve.health import ReplicaState
from repro_torch.serve.pool import ReplicaPool, ScaleEvent

__all__ = ["AutoscalePolicy", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    min_replicas: int = 1
    max_replicas: int = 4
    # queued requests per active replica
    queue_high: float = 2.0
    queue_low: float = 0.25
    # tokens/step per active replica below which the pool counts as
    # under-utilized (scale-down gate, alongside queue_low)
    tokens_low: float = 0.5
    # ticks between scale ACTIONS (decisions are evaluated every
    # observe(); actions are rate-limited so a drain in progress is not
    # immediately reversed)
    cooldown: int = 8
    # rolling window (ticks) for the throughput signal
    window: int = 16

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.queue_low >= self.queue_high:
            raise ValueError("queue_low must be < queue_high")


class Autoscaler:
    """Drives ``pool.scale_to`` from queue-depth + tokens/s signals.

    Call ``observe(tokens)`` once per pool step with that step's token
    count; it returns the ScaleEvent when a resize fired, else None.
    """

    def __init__(self, pool: ReplicaPool, policy: AutoscalePolicy
                 | None = None, *, metrics=None):
        self.pool = pool
        self.policy = policy or AutoscalePolicy()
        self.pool.max_replicas = max(self.pool.max_replicas,
                                     self.policy.max_replicas)
        self.metrics = metrics
        self._tokens = collections.deque(maxlen=self.policy.window)
        self._last_action = -self.policy.cooldown

    # ------------------------------------------------------- signals

    def signals(self) -> dict:
        n = max(self.pool.n_active, 1)
        occupied = sum(
            sum(s is not None for s in r.engine.slot_req)
            for r in self.pool.active_replicas)
        toks = (sum(self._tokens) / max(len(self._tokens), 1)) / n
        return {
            "queue_per_replica": self.pool.total_queued() / n,
            "occupancy": occupied / (n * self.pool.batch),
            "tokens_per_step_per_replica": toks,
            "active_replicas": n,
        }

    def mesh_for(self, n_active: int):
        """Per-replica mesh after a resize to ``n_active`` replicas:
        None (one device) until the port has meshes."""
        return None

    # -------------------------------------------------------- repair

    def repair(self) -> ScaleEvent | None:
        """Availability repair, distinct from elastic resize: rebuild
        the lowest-index DEAD replica via ``pool.replace_replica``.
        NOT cooldown-gated — lost capacity is repaired immediately, a
        drain in progress has nothing to do with it.  One replacement
        per step."""
        for idx, state in sorted(self.pool.monitor.states().items()):
            if state is ReplicaState.DEAD:
                target = min(self.pool.n_active + 1,
                             self.policy.max_replicas)
                return self.pool.replace_replica(
                    idx, mesh=self.mesh_for(max(target, 1)),
                    reason=f"replica {idx} dead")
        return None

    # -------------------------------------------------------- decide

    def decide(self) -> tuple[int, str]:
        """(target active count, reason) from the current signals —
        pure, no side effects (tests drive it directly)."""
        pol = self.policy
        sig = self.signals()
        n = sig["active_replicas"]
        if sig["queue_per_replica"] > pol.queue_high and \
                n < pol.max_replicas:
            return n + 1, (
                f"queue/replica {sig['queue_per_replica']:.2f} "
                f"> {pol.queue_high}")
        if (sig["queue_per_replica"] < pol.queue_low
                and sig["tokens_per_step_per_replica"] < pol.tokens_low
                and sig["occupancy"] < 0.5
                and n > pol.min_replicas):
            return n - 1, (
                f"queue/replica {sig['queue_per_replica']:.2f} "
                f"< {pol.queue_low}, tok/step/replica "
                f"{sig['tokens_per_step_per_replica']:.2f} "
                f"< {pol.tokens_low}")
        return n, ""

    def observe(self, tokens_this_step: int) -> ScaleEvent | None:
        """Fold one pool step's token count in; maybe repair a dead
        replica (immediately) or resize (cooldown-gated)."""
        self._tokens.append(tokens_this_step)
        if self.metrics is not None:
            sig = self.signals()
            self.metrics.gauge(
                "serve_queue_per_replica",
                "queued requests per active replica").set(
                    sig["queue_per_replica"])
        ev = self.repair()
        if ev is not None:
            self._last_action = self.pool.ticks
            return ev
        if self.pool.ticks - self._last_action < self.policy.cooldown:
            return None
        target, reason = self.decide()
        if target == self.pool.n_active:
            return None
        ev = self.pool.scale_to(
            target, mesh=self.mesh_for(target), reason=reason)
        if ev is not None:
            self._last_action = self.pool.ticks
        return ev
