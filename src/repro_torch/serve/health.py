"""Replica health: heartbeat monitor, failure state machine, circuit
breaker (twin of ``repro.serve.health``).

The pool's failure model is *fail-stop or fail-slow in virtual tick
time*: a replica either raises ``ReplicaDead`` out of ``step()`` (a
crash — its device state is gone) or silently stops making tick
progress while holding work (a hang, a page-pool deadlock, a stuck
collective).  Both are detected here, from the same two host-side
signals the pool already reads every step:

  * **tick heartbeat** — did ``engine.ticks`` advance this pool step
    while the engine had work?  ``suspect_after`` consecutive stalled
    steps quarantine the replica (no NEW work routed to it);
    ``dead_after`` declares it dead and triggers evacuation.
  * **consecutive errors** — transient admission/step failures
    (``TransientAdmissionError``) trip a circuit breaker:
    ``max_errors`` consecutive failures open the breaker (SUSPECT),
    twice that declares the replica dead.  Any success closes it.

State machine (per replica)::

    HEALTHY --stall/errors--> SUSPECT --more stall--> DEAD
       ^                         |                      |
       |                         +--progress------------+   (quarantine
       |                                                |    lifted)
       +------progress------ RECOVERING <--replace------+

Crashes short-circuit straight to DEAD: there is no ambiguity to wait
out.  DEAD is terminal for the *engine*; the replica slot itself comes
back through ``pool.replace_replica`` (the autoscaler's ``replace``
action), which re-enters at RECOVERING — a half-open breaker that
takes new work and is promoted to HEALTHY on its first successful
tick.

Everything is tick-driven (no wall clock), so chaos runs under
``serve.faults`` are bit-reproducible like the loadgen sweeps.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "HealthMonitor",
    "HealthPolicy",
    "ReplicaDead",
    "ReplicaState",
    "TransientAdmissionError",
]


class ReplicaDead(RuntimeError):
    """A replica crashed mid-step: its engine state is unrecoverable.
    The pool catches this, declares the replica DEAD, evacuates its
    in-flight requests and reclaims its KV pages."""

    def __init__(self, replica: str, tick: int, detail: str = ""):
        super().__init__(
            f"replica {replica} died at tick {tick}"
            + (f": {detail}" if detail else ""))
        self.replica = replica
        self.tick = tick


class TransientAdmissionError(RuntimeError):
    """A replica refused a submit for a transient, non-queue reason
    (injected admission fault, flaky transport).  The pool fails the
    request over to another replica and counts the error toward the
    circuit breaker — unlike ``QueueFull``, which is healthy
    backpressure and never counts as a failure."""


class ReplicaState(enum.IntEnum):
    # IntEnum so the serve_replica_state gauge exports the value
    # directly (0 healthy, 1 suspect, 2 dead, 3 recovering).
    HEALTHY = 0
    SUSPECT = 1
    DEAD = 2
    RECOVERING = 3


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Thresholds in pool steps (virtual ticks), not wall time."""
    # consecutive no-progress steps (with work pending) before
    # quarantine / death
    suspect_after: int = 4
    dead_after: int = 12
    # consecutive transient errors before the breaker opens (SUSPECT);
    # 2x this declares the replica dead
    max_errors: int = 3

    def __post_init__(self):
        if not 1 <= self.suspect_after <= self.dead_after:
            raise ValueError(
                f"need 1 <= suspect_after <= dead_after, got "
                f"[{self.suspect_after}, {self.dead_after}]")
        if self.max_errors < 1:
            raise ValueError(f"max_errors must be >= 1, got "
                             f"{self.max_errors}")


class HealthMonitor:
    """Per-replica heartbeat + state machine over ``HealthPolicy``.

    The pool calls ``observe`` once per replica per step with whether
    the engine made tick progress and whether it had work; crashes and
    transient errors are reported via ``note_crash`` / ``note_error``.
    ``admittable`` is the circuit-breaker gate the router consults —
    SUSPECT and DEAD replicas are quarantined, RECOVERING is half-open.
    """

    def __init__(self, policy: HealthPolicy | None = None, *,
                 metrics=None):
        self.policy = policy or HealthPolicy()
        self.metrics = metrics
        self._state: dict[int, ReplicaState] = {}
        self._stall: dict[int, int] = {}
        self._errors: dict[int, int] = {}
        self.deaths = 0                      # lifetime DEAD transitions

    # ----------------------------------------------------------- state

    def register(self, idx: int) -> None:
        if idx not in self._state:
            self._set(idx, ReplicaState.HEALTHY)
            self._stall[idx] = 0
            self._errors[idx] = 0

    def state(self, idx: int) -> ReplicaState:
        return self._state.get(idx, ReplicaState.HEALTHY)

    def states(self) -> dict[int, ReplicaState]:
        return dict(self._state)

    def admittable(self, idx: int) -> bool:
        """Circuit-breaker admission gate: route new work here?"""
        return self.state(idx) in (ReplicaState.HEALTHY,
                                   ReplicaState.RECOVERING)

    def _set(self, idx: int, state: ReplicaState) -> None:
        prev = self._state.get(idx)
        self._state[idx] = state
        if state is ReplicaState.DEAD and prev is not ReplicaState.DEAD:
            self.deaths += 1
            if self.metrics is not None:
                self.metrics.counter(
                    "serve_replica_failures",
                    "replicas declared dead (crash, hang, breaker)",
                ).inc(replica=str(idx))
        if self.metrics is not None:
            self.metrics.gauge(
                "serve_replica_state",
                "replica health (0 healthy, 1 suspect, 2 dead, "
                "3 recovering)").set(int(state), replica=str(idx))

    # ------------------------------------------------------ transitions

    def observe(self, idx: int, *, progressed: bool,
                has_work: bool) -> ReplicaState:
        """Fold one pool step's heartbeat in; returns the new state.

        Progress closes the breaker and lifts quarantine (SUSPECT or
        RECOVERING -> HEALTHY).  A stall only counts against the
        replica while it HAS work — an idle engine is silent, not
        sick."""
        self.register(idx)
        state = self._state[idx]
        if state is ReplicaState.DEAD:
            return state
        if progressed:
            self._stall[idx] = 0
            self._errors[idx] = 0
            if state is not ReplicaState.HEALTHY:
                self._set(idx, ReplicaState.HEALTHY)
        elif has_work:
            self._stall[idx] += 1
            if self._stall[idx] >= self.policy.dead_after:
                self._set(idx, ReplicaState.DEAD)
            elif self._stall[idx] >= self.policy.suspect_after \
                    and state is ReplicaState.HEALTHY:
                self._set(idx, ReplicaState.SUSPECT)
        return self._state[idx]

    def note_error(self, idx: int) -> ReplicaState:
        """One transient admission/step failure toward the breaker."""
        self.register(idx)
        if self._state[idx] is ReplicaState.DEAD:
            return ReplicaState.DEAD
        self._errors[idx] += 1
        if self._errors[idx] >= 2 * self.policy.max_errors:
            self._set(idx, ReplicaState.DEAD)
        elif self._errors[idx] >= self.policy.max_errors \
                and self._state[idx] is not ReplicaState.SUSPECT:
            self._set(idx, ReplicaState.SUSPECT)
        return self._state[idx]

    def note_crash(self, idx: int) -> ReplicaState:
        """Fail-stop: straight to DEAD, no thresholds to wait out."""
        self.register(idx)
        self._set(idx, ReplicaState.DEAD)
        return ReplicaState.DEAD

    def mark_recovering(self, idx: int) -> None:
        """A replaced replica enters half-open: it takes new work and
        is promoted to HEALTHY on its first successful tick."""
        self.register(idx)
        self._stall[idx] = 0
        self._errors[idx] = 0
        self._set(idx, ReplicaState.RECOVERING)
