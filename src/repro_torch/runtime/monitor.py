"""Step-time telemetry and straggler detection (twin of
``repro.runtime.monitor``).

The monitor keeps a rolling window of per-step wall times, computes
robust z-scores (median / MAD) and flags outliers, and accounts model
FLOPs into achieved FLOP/s.  ``run_header`` names the mesh (or a single
device) and each family's routed impl, letter for letter as ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.core.ops import registry

__all__ = ["StepMonitor", "StepStats", "run_header"]


def run_header(arch: str, *, policy=None, mesh=None) -> str:
    """One attributable run-header line: arch, mesh topology and the
    per-family routed impl."""
    parts = [f"run: {arch}"]
    if mesh is not None and not mesh.is_identity:
        parts.append(f"mesh {mesh.describe()} ({mesh.size} devices)")
    else:
        parts.append("mesh none (single-device)")
    if policy is not None:
        parts.append(" ".join(f"{fam}={policy.impl_for(fam)}"
                              for fam in registry.families()))
    return " | ".join(parts)


def _median(sorted_xs) -> float:
    """Two-point median of an already-sorted sequence."""
    n = len(sorted_xs)
    mid = n // 2
    if n % 2:
        return sorted_xs[mid]
    return 0.5 * (sorted_xs[mid - 1] + sorted_xs[mid])


@dataclasses.dataclass
class StepStats:
    mean_s: float
    median_s: float
    mad_s: float
    last_s: float
    straggler: bool
    achieved_tflops: float


class StepMonitor:
    """Rolling robust step-time stats + optional metrics publishing.

    ``metrics`` is duck-typed (``histogram`` / ``gauge`` / ``counter``
    get-or-create methods, e.g. ``repro_torch.serve.metrics.MetricsRegistry``):
    every observed step then also observes ``<name>_time_seconds``, sets
    ``<name>_achieved_tflops`` (with ``model_flops_per_step``) and counts
    ``<name>_straggler_flags``, as ``repro``'s monitor does.
    """

    def __init__(self, window: int = 50, z_threshold: float = 4.0,
                 model_flops_per_step: float = 0.0, metrics=None, name: str = "step"):
        self.times: collections.deque = collections.deque(maxlen=window)
        self.z = z_threshold
        self.flops = model_flops_per_step
        self._t0: float | None = None
        self._metrics = metrics
        self._name = name

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> StepStats:
        if self._t0 is None:
            raise RuntimeError("StepMonitor.stop() before start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> StepStats:
        """Fold one step duration (seconds) into the window."""
        self.times.append(dt)
        ts = sorted(self.times)
        n = len(ts)
        med = _median(ts)
        mad = _median(sorted(abs(t - med) for t in ts))
        straggler = n >= 10 and mad > 0 and (dt - med) / (1.4826 * mad) > self.z
        stats = StepStats(mean_s=sum(ts) / n, median_s=med, mad_s=mad, last_s=dt,
                          straggler=straggler,
                          achieved_tflops=self.flops / dt / 1e12 if self.flops else 0.0)
        if self._metrics is not None:
            self._metrics.histogram(f"{self._name}_time_seconds", "per-step wall time").observe(dt)
            if self.flops:
                self._metrics.gauge(f"{self._name}_achieved_tflops",
                                    "model FLOPs / step wall time").set(stats.achieved_tflops)
            if straggler:
                self._metrics.counter(f"{self._name}_straggler_flags",
                                      "robust-z outlier steps").inc()
        return stats
