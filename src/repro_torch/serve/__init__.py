"""Production serve stack above the continuous-batching engine (twin
of ``repro.serve``).

Layering (each module imports only downward):

    gateway.py    asyncio HTTP/JSON front: token streaming, bounded
                  admission, 429 + Retry-After backpressure, request
                  timeouts/disconnect-cancellation, /metrics
    autoscale.py  queue-depth + tokens/s driven replica-set resizing
                  plus the ``replace`` repair action, each re-resolving
                  a per-replica mesh (``runtime.mesh.replica_mesh_spec``)
    pool.py       N in-process ServeEngine replicas: least-loaded
                  routing, session affinity, bounded queues, drains,
                  death evacuation + token-exact request rehoming
    faults.py     deterministic seeded fault injection (crash, hang,
                  slow, admission, page exhaustion) in virtual ticks
    health.py     per-replica tick heartbeat, HEALTHY/SUSPECT/DEAD/
                  RECOVERING state machine, circuit-breaker admission
    metrics.py    Prometheus-style counters/gauges/histograms + text
                  exposition (no serve/launch imports — shared by the
                  engine and runtime/monitor.py via duck typing)
    loadgen.py    open-loop Poisson load sweeps in virtual tick time,
                  emitting the BENCH_serve_torch.json SLO matrix (and
                  BENCH_serve_chaos_torch.json under ``--chaos``)

Attribute access is lazy: ``repro_torch.launch.serve`` (the engine) is
imported by ``pool``/``gateway``, and itself imports this package inside
``main()`` — keeping this package's import side-effect free avoids the
cycle in both directions.
"""

from __future__ import annotations

_LAZY = {
    "Counter": ("repro_torch.serve.metrics", "Counter"),
    "Gauge": ("repro_torch.serve.metrics", "Gauge"),
    "Histogram": ("repro_torch.serve.metrics", "Histogram"),
    "MetricsRegistry": ("repro_torch.serve.metrics", "MetricsRegistry"),
    "Replica": ("repro_torch.serve.pool", "Replica"),
    "ReplicaPool": ("repro_torch.serve.pool", "ReplicaPool"),
    "ScaleEvent": ("repro_torch.serve.pool", "ScaleEvent"),
    "RecoveryEvent": ("repro_torch.serve.pool", "RecoveryEvent"),
    "AutoscalePolicy": ("repro_torch.serve.autoscale", "AutoscalePolicy"),
    "Autoscaler": ("repro_torch.serve.autoscale", "Autoscaler"),
    "Gateway": ("repro_torch.serve.gateway", "Gateway"),
    "FaultPlan": ("repro_torch.serve.faults", "FaultPlan"),
    "FaultSpec": ("repro_torch.serve.faults", "FaultSpec"),
    "FaultyEngine": ("repro_torch.serve.faults", "FaultyEngine"),
    "HealthMonitor": ("repro_torch.serve.health", "HealthMonitor"),
    "HealthPolicy": ("repro_torch.serve.health", "HealthPolicy"),
    "ReplicaDead": ("repro_torch.serve.health", "ReplicaDead"),
    "ReplicaState": ("repro_torch.serve.health", "ReplicaState"),
    "TransientAdmissionError": ("repro_torch.serve.health",
                                "TransientAdmissionError"),
    "LoadSpec": ("repro_torch.serve.loadgen", "LoadSpec"),
    "run_sweep": ("repro_torch.serve.loadgen", "run_sweep"),
    "QueueFull": ("repro_torch.launch.serve", "QueueFull"),
    "RecoveryMismatch": ("repro_torch.launch.serve", "RecoveryMismatch"),
    "Request": ("repro_torch.launch.serve", "Request"),
    "ServeEngine": ("repro_torch.launch.serve", "ServeEngine"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__
