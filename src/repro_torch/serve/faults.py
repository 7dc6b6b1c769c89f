"""Deterministic fault injection for the serve stack (twin of
``repro.serve.faults``).

Chaos testing is only trustworthy when a failing run can be replayed
bit-for-bit, so faults here are scheduled in VIRTUAL tick time — the
same clock the loadgen sweeps run on — and replica assignment is
seeded.  A ``FaultPlan`` is a pure function of its string form; a
chaos sweep is a pure function of (workload seed, fault plan), so its
recovery columns are free of timing flake.

Fault kinds (all windows in replica step ticks):

  ``crash@T``      fail-stop: ``step()`` raises ``ReplicaDead`` at the
                   replica's T-th step; the engine never ticks again.
  ``hang@TxD``     fail-slow: D consecutive steps make no progress
                   (``step()`` returns 0 without touching the engine)
                   — the health monitor sees a stalled heartbeat.
  ``slow@TxD``     latency multiplier: during the window the engine
                   only ticks every ``factor``-th step (default 2).
  ``adm@TxD``      admission fault: ``submit`` raises
                   ``TransientAdmissionError`` during the window — the
                   pool fails the request over and counts the error
                   toward the circuit breaker.
  ``pages@TxD``    page-pool exhaustion: every free KV page is stolen
                   from the engine's ``_PageAllocator`` free lists at
                   window start and returned at window end — paged
                   admission backpressures exactly as a real pool-
                   pressure episode would.  No-op on dense engines.

Plan grammar (the loadgen ``--chaos`` flag)::

    SEED:FAULT[,FAULT...]        FAULT = kind@TICK[xDUR][@rIDX]

    "7:crash@6,hang@14x4"        seed 7; one crash at tick 6 and one
                                 4-tick hang at tick 14, each landing
                                 on a seeded-random replica
    "0:crash@8@r1"               deterministic placement on replica 1

``FaultyEngine`` wraps any object with the ``ServeEngine`` surface
(the real engine, the tests' FakeEngine) via attribute delegation, so
the pool drives a faulty replica through the identical code path as a
healthy one — chaos is a property of the harness, never of the engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.health import ReplicaDead, TransientAdmissionError

__all__ = ["FaultSpec", "FaultPlan", "FaultyEngine"]

KINDS = ("crash", "hang", "slow", "adm", "pages")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` at replica step ``tick`` for
    ``duration`` ticks (0 for the instantaneous crash), on ``replica``
    (None = assigned by the plan's seeded RNG)."""
    kind: str
    tick: int
    duration: int = 0
    replica: int | None = None
    factor: int = 2          # slow-tick multiplier (slow kind only)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.tick < 0 or self.duration < 0:
            raise ValueError(f"fault tick/duration must be >= 0: {self}")
        if self.kind != "crash" and self.duration < 1:
            raise ValueError(
                f"{self.kind} fault needs a window: {self.kind}@"
                f"{self.tick}xD with D >= 1")

    @property
    def end(self) -> int:
        return self.tick + self.duration

    def active(self, t: int) -> bool:
        return self.tick <= t < self.end

    def describe(self) -> str:
        s = f"{self.kind}@{self.tick}"
        if self.duration:
            s += f"x{self.duration}"
        if self.replica is not None:
            s += f"@r{self.replica}"
        return s

    @classmethod
    def parse(cls, text: str) -> FaultSpec:
        parts = text.strip().split("@")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad fault {text!r}; expected kind@TICK[xDUR][@rIDX]")
        kind = parts[0].strip().lower()
        when = parts[1].strip()
        tick, _, dur = when.partition("x")
        replica = None
        if len(parts) == 3:
            r = parts[2].strip().lower()
            if not r.startswith("r") or not r[1:].isdigit():
                raise ValueError(
                    f"bad replica {parts[2]!r} in fault {text!r}; "
                    f"expected rIDX")
            replica = int(r[1:])
        return cls(kind=kind, tick=int(tick),
                   duration=int(dur) if dur else 0, replica=replica)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded set of faults; ``resolved(n)`` pins every unassigned
    fault to a replica with the plan's own RNG, so a plan string is a
    complete, reproducible description of a chaos run."""
    seed: int
    faults: tuple[FaultSpec, ...]

    @classmethod
    def parse(cls, text: str) -> FaultPlan:
        """``SEED:FAULT[,FAULT...]`` (the ``--chaos`` grammar)."""
        head, sep, rest = text.partition(":")
        if not sep or not head.strip().lstrip("-").isdigit():
            raise ValueError(
                f"bad fault plan {text!r}; expected 'SEED:kind@TICK"
                f"[xDUR][@rIDX],...'")
        faults = tuple(FaultSpec.parse(tok)
                       for tok in rest.split(",") if tok.strip())
        if not faults:
            raise ValueError(f"fault plan {text!r} schedules no faults")
        return cls(seed=int(head), faults=faults)

    def describe(self) -> str:
        return f"{self.seed}:" + ",".join(f.describe() for f in self.faults)

    def resolved(self, n_replicas: int) -> dict[int, list[FaultSpec]]:
        """Per-replica fault lists with seeded placement of unassigned
        faults — a pure function of (plan, n_replicas)."""
        rng = np.random.default_rng(self.seed)
        out: dict[int, list[FaultSpec]] = {}
        for spec in self.faults:
            idx = spec.replica
            if idx is None:
                idx = int(rng.integers(0, n_replicas))
                spec = dataclasses.replace(spec, replica=idx)
            if not 0 <= idx < n_replicas:
                raise ValueError(
                    f"fault {spec.describe()} targets replica {idx} "
                    f"but the pool has {n_replicas}")
            out.setdefault(idx, []).append(spec)
        return out

    def wrap(self, idx: int, engine, *, n_replicas: int):
        """Wrap ``engine`` as replica ``idx``: a ``FaultyEngine`` when
        the plan schedules faults there, the engine untouched when
        not."""
        faults = self.resolved(n_replicas).get(idx)
        return FaultyEngine(engine, faults) if faults else engine

    def wrap_factory(self, factory, *, n_replicas: int):
        """Lift an ``engine_factory`` into its chaos twin.

        Each replica slot experiences its faults ONCE — on the first
        engine built for it.  A replacement engine (the autoscaler's
        ``replace`` action after the fault killed the original) comes
        back healthy; re-wrapping it would crash every repair forever."""
        wrapped: set[int] = set()

        def make(idx, policy):
            eng = factory(idx, policy)
            if idx in wrapped:
                return eng
            wrapped.add(idx)
            return self.wrap(idx, eng, n_replicas=n_replicas)
        return make


class FaultyEngine:
    """Transparent fault-injecting proxy over a ``ServeEngine``-shaped
    engine.

    Every attribute not intercepted here delegates to the wrapped
    engine, so the pool, gateway and monitor drive a faulty replica
    through exactly the code they drive a healthy one.  Faults are
    keyed on the engine's own step-call counter (``fault_ticks``),
    which advances even while the engine hangs — the wrapped engine's
    ``ticks`` is what stalls, which is precisely the heartbeat the
    health monitor watches.
    """

    def __init__(self, engine, faults):
        self._eng = engine
        self.faults = list(faults or [])
        self.fault_ticks = 0
        self.dead = False
        self.fired: list[str] = []          # fault log for tests/benches
        self._stolen: dict[int, list[int]] = {}   # pages fault loot
        self._stolen_by: dict[int, int] = {}      # end tick per steal

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_eng"), name)

    @property
    def engine(self):
        """The wrapped engine (for audits and assertions)."""
        return self._eng

    # ---------------------------------------------------------- faults

    def _specs(self, kind: str):
        return [f for f in self.faults if f.kind == kind]

    def _steal_pages(self, spec: FaultSpec) -> None:
        allocs = getattr(self._eng, "_allocators", None)
        if not allocs or id(spec) in self._stolen_by:
            return
        for cap, alloc in allocs.items():
            pages = alloc.alloc(alloc.available) or []
            self._stolen.setdefault(cap, []).extend(pages)
        self._stolen_by[id(spec)] = spec.end
        self.fired.append(spec.describe())

    def _restore_pages(self, *, all_windows: bool = False) -> None:
        if not self._stolen_by:
            return
        due = [k for k, end in self._stolen_by.items()
               if all_windows or self.fault_ticks >= end]
        if not due:
            return
        # windows overlap rarely; restore everything once the last due
        # window closes — page identity does not matter, only counts
        if all_windows or len(due) == len(self._stolen_by):
            allocs = getattr(self._eng, "_allocators", {})
            for cap, pages in self._stolen.items():
                allocs[cap].free(pages)
            self._stolen.clear()
            self._stolen_by.clear()
        else:
            for k in due:
                del self._stolen_by[k]

    def quiesce(self) -> None:
        """Return all injected state to the engine (stolen pages) —
        called before leak audits and at evacuation, so a fault can
        never masquerade as a leak."""
        self._restore_pages(all_windows=True)

    # --------------------------------------------------- engine surface

    def submit(self, req) -> None:
        if self.dead:
            raise ReplicaDead(str(getattr(self._eng, "replica", "?")),
                              self.fault_ticks, "submit to dead replica")
        for spec in self._specs("adm"):
            if spec.active(self.fault_ticks):
                if spec.describe() not in self.fired:
                    self.fired.append(spec.describe())
                raise TransientAdmissionError(
                    f"replica {getattr(self._eng, 'replica', '?')}: "
                    f"injected admission fault "
                    f"({spec.describe()} @tick {self.fault_ticks})")
        self._eng.submit(req)

    def step(self) -> int:
        t = self.fault_ticks
        if self.dead:
            raise ReplicaDead(str(getattr(self._eng, "replica", "?")),
                              t, "step on dead replica")
        for spec in self._specs("crash"):
            if t >= spec.tick:
                self.dead = True
                self.fired.append(spec.describe())
                raise ReplicaDead(
                    str(getattr(self._eng, "replica", "?")), t,
                    f"injected {spec.describe()}")
        for spec in self._specs("pages"):
            if spec.active(t):
                self._steal_pages(spec)
        self.fault_ticks += 1
        self._restore_pages()
        for spec in self._specs("hang"):
            if spec.active(t):
                if spec.describe() not in self.fired:
                    self.fired.append(spec.describe())
                return 0
        for spec in self._specs("slow"):
            if spec.active(t) and (t - spec.tick) % spec.factor:
                if spec.describe() not in self.fired:
                    self.fired.append(spec.describe())
                return 0
        return self._eng.step()

    def evacuate(self):
        """Quiesce injected state, then delegate — dead-replica page
        reclamation must see the true allocator picture."""
        self.quiesce()
        return self._eng.evacuate()

    def pages_outstanding(self) -> int:
        self.quiesce()
        return self._eng.pages_outstanding()
