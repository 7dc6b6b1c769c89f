"""Prometheus-style metrics: counters, gauges, histograms + text
exposition (a copy of ``repro.serve.metrics``: the same series render
the same text).

The serve stack's observability spine, grown out of
``runtime/monitor.py``'s robust step statistics: where the monitor
answers "is THIS host a straggler" from a rolling window, the registry
answers "what is the fleet doing" — queue depth, TTFT, inter-token
latency, tokens/s per slot, slot occupancy — as named, labeled series
a scraper (or the gateway's ``GET /metrics``) reads in the standard
text exposition format.

Dependency posture: this module imports nothing from the serve or
launch layers, so ``ServeEngine`` / ``StepMonitor`` can accept a
registry duck-typed (``counter`` / ``gauge`` / ``histogram``
get-or-create methods) without a circular import.

The three metric kinds follow the Prometheus data model:

  Counter    monotone ``inc()``; exposition ends in ``_total``.
  Gauge      ``set()`` / ``inc()`` / ``dec()`` — a current value.
  Histogram  ``observe()`` into cumulative ``le`` buckets, plus
             ``_sum`` / ``_count``; ``quantile()`` interpolates within
             buckets (upper-bound biased, good enough for autoscaler
             signals — loadgen computes its gated percentiles from the
             exact per-request samples instead).
"""

from __future__ import annotations

import bisect
import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "TICK_BUCKETS",
]

# Seconds-scale latency buckets: spans smoke ticks (~ms) through
# cold-build prefills (~10s) without a per-deployment knob.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

# Virtual-tick buckets for durations measured in engine/pool steps
# (recovery latency, drain time) — deterministic units, so these
# histograms are bit-reproducible across runs like the loadgen sweeps.
TICK_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Metric:
    """Shared labeled-series plumbing: one metric name owns a mapping
    from a (sorted) label tuple to a per-series value."""

    kind = "untyped"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def labels(self, **labels):
        """The per-series cell for this label set (created on first
        touch), so hot paths can hold it instead of re-resolving."""
        key = self._key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._new_cell()
            return self._series[key]

    def _new_cell(self):
        raise NotImplementedError

    def expose(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            series = list(self._series.items())
        for key, cell in sorted(series):
            lines += self._expose_cell(dict(key), cell)
        return lines

    def _expose_cell(self, labels: dict, cell) -> list[str]:
        raise NotImplementedError


class _CounterCell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Counter(_Metric):
    kind = "counter"

    def _new_cell(self):
        return _CounterCell()

    def inc(self, v: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(v)

    def value(self, **labels) -> float:
        return self.labels(**labels).value

    def _expose_cell(self, labels, cell):
        name = self.name if self.name.endswith("_total") \
            else self.name + "_total"
        return [f"{name}{_fmt_labels(labels)} {_fmt_value(cell.value)}"]


class _GaugeCell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class Gauge(_Metric):
    kind = "gauge"

    def _new_cell(self):
        return _GaugeCell()

    def set(self, v: float, **labels) -> None:
        self.labels(**labels).set(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(v)

    def dec(self, v: float = 1.0, **labels) -> None:
        self.labels(**labels).dec(v)

    def value(self, **labels) -> float:
        return self.labels(**labels).value

    def _expose_cell(self, labels, cell):
        return [f"{self.name}{_fmt_labels(labels)} {_fmt_value(cell.value)}"]


class _HistogramCell:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = bounds                  # finite upper bounds, sorted
        self.counts = [0] * (len(bounds) + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (0 <= q <= 1); returns 0.0 on an
        empty histogram.  The +Inf bucket clamps to the last finite
        bound — an estimate for scaling decisions, not a gated number."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _new_cell(self):
        return _HistogramCell(self.buckets)

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)

    def quantile(self, q: float, **labels) -> float:
        return self.labels(**labels).quantile(q)

    def count(self, **labels) -> int:
        return self.labels(**labels).count

    def _expose_cell(self, labels, cell):
        lines = []
        cum = 0
        for bound, c in zip(cell.bounds + (math.inf,), cell.counts):
            cum += c
            lab = dict(labels)
            lab["le"] = _fmt_value(bound)
            lines.append(
                f"{self.name}_bucket{_fmt_labels(lab)} {cum}")
        lines.append(
            f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(cell.sum)}")
        lines.append(
            f"{self.name}_count{_fmt_labels(labels)} {cell.count}")
        return lines


class MetricsRegistry:
    """Get-or-create registry over named metrics + text exposition.

    ``counter`` / ``gauge`` / ``histogram`` return the existing metric
    when the name is already registered (kind mismatches raise), so
    engine, pool, gateway and autoscaler can all resolve the same
    series without threading metric objects around.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name: str, help_: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get_or_make(Histogram, name, help_, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """The full registry in Prometheus text exposition format."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        for _, m in metrics:
            lines += m.expose()
        return "\n".join(lines) + ("\n" if lines else "")
