"""The port's pool, health monitor, fault injection and autoscaler run
the same scripted scenarios as ``repro``'s, each package over its own
model-free ``FakeEngine`` (``tests/serve_testlib.py`` and
``tests/torch_serve_testlib.py``).

Each scenario returns a log of everything the layers decide: where each
request was routed, every ``QueueFull``, every scale / replace event,
every death, recovery and health state, page-pool counts under a
``pages@`` window, each request's tokens, and the metrics exposition.
The two logs must be equal.  ``repro`` resolves a per-replica mesh at
each scale event where the port records None (one device), so events
are logged by their other fields."""

import types

import numpy as np
import pytest

import serve_testlib
import torch_serve_testlib
from repro.launch.serve import QueueFull as JQueueFull
from repro.launch.serve import Request as JRequest
from repro.launch.serve import _PageAllocator as JPageAllocator
from repro.serve import autoscale as jautoscale
from repro.serve import faults as jfaults
from repro.serve import health as jhealth
from repro.serve import metrics as jmetrics
from repro.serve import pool as jpool
from repro_torch.launch.serve import QueueFull, Request, _PageAllocator
from repro_torch.serve import autoscale, faults, health, metrics, pool

LIBS = {
    "repro": types.SimpleNamespace(
        Request=JRequest, QueueFull=JQueueFull, PageAllocator=JPageAllocator,
        autoscale=jautoscale, faults=jfaults, health=jhealth, metrics=jmetrics,
        pool=jpool, testlib=serve_testlib,
        # repro re-resolves a mesh per event: one device here
        autoscaler=lambda p, pol, reg: jautoscale.Autoscaler(p, pol, n_devices=1,
                                                              metrics=reg)),
    "port": types.SimpleNamespace(
        Request=Request, QueueFull=QueueFull, PageAllocator=_PageAllocator,
        autoscale=autoscale, faults=faults, health=health, metrics=metrics,
        pool=pool, testlib=torch_serve_testlib,
        autoscaler=lambda p, pol, reg: autoscale.Autoscaler(p, pol, metrics=reg)),
}


def _req(lib, rid, n, session=None, deadline=None):
    return lib.Request(rid=rid, prompt=np.arange(3, dtype=np.int32), max_new_tokens=n,
                       session=session, deadline_ticks=deadline)


def _event(ev):
    return None if ev is None else ("event", ev.tick, ev.old_n, ev.new_n, ev.reason, ev.action)


def _states(p):
    return {i: s.name for i, s in sorted(p.monitor.states().items())}


def _submit(lib, p, req, log):
    try:
        log.append(("routed", req.rid, p.submit(req)))
    except lib.QueueFull as e:
        log.append(("full", req.rid, e.depth, e.max_queue))


def _finish(p, reqs, reg, log):
    log.append(("tokens", [(r.rid, r.out_tokens, r.done, r.expired, r.cancelled,
                            r.recoveries) for r in reqs]))
    log.append(("events", [_event(ev) for ev in p.scale_events]))
    log.append(("recoveries", [(ev.rid, ev.replica, ev.death_tick, ev.recovered_tick)
                               for ev in p.recovery_events]))
    log.append(("health", _states(p), p.monitor.deaths, p.n_active, p.ticks,
                p.tokens_generated, p.pages_outstanding()))
    log.append(("exposition", reg.expose()))
    return log


def routing_affinity_watermark(lib):
    """Least-loaded routing, strict session affinity and the per-replica
    watermark (QueueFull) on 3 replicas, then round robin on 2."""
    reg = lib.metrics.MetricsRegistry()
    p = lib.testlib.make_fake_pool(replicas=3, batch_size=2, max_queue=2, metrics=reg)
    log = []
    reqs = [_req(lib, i, 3 + i % 4, session=f"s{i % 3}" if i < 6 else None)
            for i in range(14)]
    for r in reqs[:10]:
        _submit(lib, p, r, log)
    for _ in range(2):
        log.append(("step", p.step(), [rep.load for rep in p.replicas]))
    for r in reqs[10:]:
        _submit(lib, p, r, log)
    log.append(("sessions", [p.replica_for_session(f"s{i}") for i in range(4)]))
    while not p.idle:
        log.append(("step", p.step(), [rep.load for rep in p.replicas]))
    rr = lib.testlib.make_fake_pool(replicas=2, batch_size=1, max_queue=1,
                                    routing="round_robin")
    rr_reqs = [_req(lib, 100 + i, 2) for i in range(5)]
    for r in rr_reqs:
        _submit(lib, rr, r, log)
    rr.run([])
    log.append(("round_robin", [r.out_tokens for r in rr_reqs]))
    return _finish(p, reqs, reg, log)


def scale_with_drains(lib):
    """A burst scales 1 -> 3 replicas, idle ticks drain them back to 1,
    a second burst reactivates a drained replica."""
    reg = lib.metrics.MetricsRegistry()
    p = lib.testlib.make_fake_pool(replicas=1, batch_size=2, max_replicas=3, metrics=reg)
    scaler = lib.autoscaler(p, lib.autoscale.AutoscalePolicy(
        min_replicas=1, max_replicas=3, cooldown=2, window=4), reg)
    reqs = [_req(lib, i, 6) for i in range(12)]
    log = []
    for r in reqs:
        _submit(lib, p, r, log)
    for t in range(60):
        if t == 40:
            for r in reqs[8:]:
                fresh = _req(lib, 100 + r.rid, 4)
                reqs.append(fresh)
                _submit(lib, p, fresh, log)
        tokens = p.step()
        ev = scaler.observe(tokens)
        log.append(("tick", t, tokens, p.n_active,
                    [(rep.active, rep.load) for rep in p.replicas], _event(ev),
                    scaler.decide()))
    return _finish(p, reqs, reg, log)


FAST_HEALTH = dict(suspect_after=2, dead_after=4, max_errors=1)


def crash_hang_breaker(lib):
    """A seeded crash, a hang past the death threshold and an admission
    fault window that trips the breaker, on 3 replicas under a stream of
    arrivals; the autoscaler's repair replaces every dead replica."""
    reg = lib.metrics.MetricsRegistry()
    plan = lib.faults.FaultPlan.parse("1:crash@4@r0,hang@3x6,adm@0x8@r2")
    p = lib.pool.ReplicaPool(
        None, None, replicas=3, batch_size=2, max_queue=3, metrics=reg,
        health=lib.health.HealthPolicy(**FAST_HEALTH),
        engine_factory=plan.wrap_factory(lib.testlib.fake_factory(2, 3), n_replicas=3))
    scaler = lib.autoscaler(p, lib.autoscale.AutoscalePolicy(min_replicas=3, max_replicas=3), reg)
    log = [("plan", plan.describe(), sorted(
        (i, [f.describe() for f in fs]) for i, fs in plan.resolved(3).items()))]
    reqs = []
    t = 0
    while t < 18 or not p.idle:
        if t < 18:
            for k in range(2):
                r = _req(lib, 2 * t + k, 4 + (t + k) % 5, deadline=40 if k else None)
                reqs.append(r)
                _submit(lib, p, r, log)
        tokens = p.step()
        ev = scaler.observe(tokens)
        log.append(("tick", t, tokens, _states(p), p.monitor.deaths, _event(ev),
                    [getattr(rep.engine, "fired", None) for rep in p.replicas]))
        t += 1
        assert t < 400
    return _finish(p, reqs, reg, log)


def pages_slow_replace(lib):
    """A ``pages@`` window steals and returns every free page of each
    capacity class, a ``slow@`` window halves a replica's ticks, and an
    operator ``replace_replica`` on a live replica rehomes its work."""
    reg = lib.metrics.MetricsRegistry()
    plan = lib.faults.FaultPlan.parse("5:pages@2x3@r0,slow@1x4@r1")
    fake = lib.testlib.fake_factory(2, None)

    def paged_fake(idx, policy):
        eng = fake(idx, policy)
        eng._allocators = {16: lib.PageAllocator(9), 64: lib.PageAllocator(5)}
        return eng

    p = lib.pool.ReplicaPool(
        None, None, replicas=2, batch_size=2, metrics=reg,
        engine_factory=plan.wrap_factory(paged_fake, n_replicas=2))
    held = p.replicas[0].engine.engine._allocators[16].alloc(2)   # a request's pages
    reqs = [_req(lib, i, 5 + i % 3) for i in range(8)]
    log = []
    for r in reqs:
        _submit(lib, p, r, log)
    for t in range(8):
        tokens = p.step()
        inner = p.replicas[0].engine
        inner = getattr(inner, "engine", inner)
        log.append(("tick", t, tokens, {c: a.available for c, a in inner._allocators.items()},
                    [rep.engine.ticks for rep in p.replicas],
                    [getattr(rep.engine, "fired", None) for rep in p.replicas]))
        if t == 4:
            log.append(_event(p.replace_replica(1, reason="operator")))
    while not p.idle:
        log.append(("step", p.step()))
    p.replicas[0].engine.engine._allocators[16].free(held)
    return _finish(p, reqs, reg, log)


SCENARIOS = [routing_affinity_watermark, scale_with_drains, crash_hang_breaker,
             pages_slow_replace]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_logs_equal_repro(scenario):
    jlog, log = scenario(LIBS["repro"]), scenario(LIBS["port"])
    assert len(log) == len(jlog)
    for j, t in zip(jlog, log):
        assert t == j


def test_scenarios_exercise_every_mechanism():
    """The logs compared above hold what they are meant to show."""
    routed = routing_affinity_watermark(LIBS["port"])
    assert any(e[0] == "full" for e in routed)
    assert [e for e in routed if e[0] == "sessions"][0][1][:3] != [None, None, None]
    scaled = scale_with_drains(LIBS["port"])
    events = [e[5] for e in scaled if e[0] == "tick" and e[5] is not None]
    assert {ev[3] > ev[2] for ev in events} == {True, False}      # grew and shrank
    assert max(e[3] for e in scaled if e[0] == "tick") == 3
    chaos = crash_hang_breaker(LIBS["port"])
    health_line = [e for e in chaos if e[0] == "health"][0]
    assert health_line[2] >= 2                                    # deaths
    assert [e for e in chaos if e[0] == "recoveries"][0][1]
    assert any(ev[5] == "replace" for ev in [e for e in chaos if e[0] == "events"][0][1])
    paged = pages_slow_replace(LIBS["port"])
    avail = [e[3] for e in paged if e[0] == "tick"]
    assert {16: 0, 64: 0} in avail and avail[-1] == {16: 6, 64: 4}


@pytest.mark.parametrize("text", ["7:crash@6,hang@14x4", "0:crash@8@r1", "11:slow@2x6,adm@0x3",
                                  "4:pages@5x2,crash@1,hang@0x9@r0"])
def test_fault_plans_parse_and_place_as_in_repro(text):
    jplan, plan = jfaults.FaultPlan.parse(text), faults.FaultPlan.parse(text)
    assert plan.describe() == jplan.describe() == text
    for n in (1, 2, 3, 5):
        if any(f.replica is not None and f.replica >= n for f in plan.faults):
            with pytest.raises(ValueError):
                plan.resolved(n)
            continue
        got = {i: [f.describe() for f in fs] for i, fs in plan.resolved(n).items()}
        assert got == {i: [f.describe() for f in fs] for i, fs in jplan.resolved(n).items()}


@pytest.mark.parametrize("name", ["repro", "port"])
def test_orphan_rehomed_into_an_admission_fault_window(name):
    """A crash's orphans land on the only other replica while its
    ``adm@`` window is open.  ``repro``'s pool lets the
    ``TransientAdmissionError`` escape ``step`` (ROADMAP C, reference
    state); the port's counts it toward the breaker, keeps the orphans
    and rehomes them on the replacement replica, token-exact."""
    lib = LIBS[name]
    plan = lib.faults.FaultPlan.parse("0:crash@2@r0,adm@0x50@r1")
    p = lib.pool.ReplicaPool(
        None, None, replicas=2, batch_size=2, engine_factory=plan.wrap_factory(
            lib.testlib.fake_factory(2, None), n_replicas=2))
    scaler = lib.autoscaler(p, lib.autoscale.AutoscalePolicy(min_replicas=2, max_replicas=2),
                            None)
    reqs = [_req(lib, i, 6) for i in range(2)]
    for r in reqs:
        p.submit(r)
    if name == "repro":
        with pytest.raises(jhealth.TransientAdmissionError):
            for _ in range(10):
                scaler.observe(p.step())
        return
    for _ in range(40):
        scaler.observe(p.step())
        if p.idle:
            break
    assert p.idle and p.monitor.deaths >= 1 and all(r.recoveries for r in reqs)
    assert [r.out_tokens for r in reqs] == [
        [torch_serve_testlib.fake_token(r.rid, j) for j in range(6)] for r in reqs]
