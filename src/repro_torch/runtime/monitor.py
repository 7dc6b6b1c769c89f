"""Step-time telemetry and straggler detection (twin of
``repro.runtime.monitor``).

The monitor keeps a rolling window of per-step wall times, computes
robust z-scores (median / MAD) and flags outliers.  There is no mesh
yet, so ``run_header`` always reports a single device; the achieved
FLOP/s readout and the metrics-registry hook wait for the serve stack.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.core.ops import registry

__all__ = ["StepMonitor", "StepStats", "run_header"]


def run_header(arch: str, *, policy=None) -> str:
    """One attributable run-header line: arch, device layout and the
    per-family routed impl."""
    parts = [f"run: {arch}", "mesh none (single-device)"]
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
    median_s: float
    last_s: float
    straggler: bool


class StepMonitor:
    """Rolling robust step-time stats."""

    def __init__(self, window: int = 50, z_threshold: float = 4.0):
        self.times: collections.deque = collections.deque(maxlen=window)
        self.z = z_threshold
        self._t0: float | None = None

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
        return StepStats(median_s=med, last_s=dt, straggler=straggler)
