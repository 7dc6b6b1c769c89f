"""The port's metrics registry and ``StepMonitor`` against ``repro``'s.

The same scripted calls go through ``repro.serve.metrics`` and
``repro_torch.serve.metrics``; the text expositions must be byte-equal.
``StepMonitor`` folds the same step times into each package's monitor,
each publishing into its own registry: the stats and the expositions
must be equal."""

import math

import pytest

from repro.runtime.monitor import StepMonitor as JStepMonitor
from repro.serve import metrics as jmetrics
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.serve import metrics


def _script(m):
    """Counters, gauges and histograms with and without labels, the tick
    buckets, values that render as ints, floats and +Inf, and the
    registry's get-or-create on a second touch."""
    reg = m.MetricsRegistry()
    c = reg.counter("serve_tokens", "decoded tokens")
    c.inc(3, replica="0")
    c.inc(replica="1")
    reg.counter("serve_tokens").inc(2.5, replica="0")
    reg.counter("gateway_rejected_total", "already suffixed").inc()
    g = reg.gauge("serve_slot_occupancy", "fraction of decode slots holding a request")
    g.set(0.75, replica="0")
    g.inc(0.25, replica="0")
    g.dec(2, replica="1")
    reg.gauge("serve_active_replicas").set(3)
    h = reg.histogram("serve_tick_seconds", "one engine decode tick")
    for v in (0.0004, 0.003, 0.003, 0.2, 7.0, 45.0):
        h.observe(v, replica="0")
    t = reg.histogram("serve_recovery_ticks", "ticks", buckets=m.TICK_BUCKETS)
    for v in (1, 2, 3, 70):
        t.observe(v)
    reg.histogram("empty_seconds", "never observed")
    quantiles = [h.quantile(q, replica="0") for q in (0.0, 0.5, 0.99, 1.0)]
    return reg, quantiles


def test_scripted_registry_exposes_the_same_text():
    jreg, jq = _script(jmetrics)
    reg, q = _script(metrics)
    assert reg.expose() == jreg.expose()
    assert q == jq
    assert "serve_recovery_ticks_bucket{le=\"+Inf\"} 4" in reg.expose()
    assert metrics.MetricsRegistry().expose() == ""


def test_kind_mismatch_and_bad_increment_raise_as_in_repro():
    for m in (jmetrics, metrics):
        reg = m.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("y").inc(-1)
        with pytest.raises(ValueError):
            m.Histogram("h", buckets=())


STEP_TIMES = [0.10, 0.11, 0.099, 0.102, 0.098, 0.101, 0.1, 0.103, 0.097, 0.1,
              0.5, 0.1, 0.099, 0.25, 0.101, 0.1, 0.102]


@pytest.mark.parametrize("flops", [0.0, 3.2e12])
def test_step_monitor_publishes_repro_series(flops):
    """Same window, threshold and FLOPs: each step's stats equal and the
    published step histogram, achieved TFLOP/s gauge and straggler count
    render the same text."""
    jreg, reg = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    jmon = JStepMonitor(window=12, model_flops_per_step=flops, metrics=jreg, name="serve_step")
    mon = StepMonitor(window=12, model_flops_per_step=flops, metrics=reg, name="serve_step")
    flags = 0
    for dt in STEP_TIMES:
        js, s = jmon.observe(dt), mon.observe(dt)
        assert (s.mean_s, s.median_s, s.mad_s, s.last_s, s.straggler) == \
            (js.mean_s, js.median_s, js.mad_s, js.last_s, js.straggler)
        assert math.isclose(s.achieved_tflops, js.achieved_tflops, rel_tol=0, abs_tol=0)
        flags += s.straggler
    assert flags >= 1                    # the 0.5 s step is flagged
    assert reg.expose() == jreg.expose()
    if flops:
        assert reg.gauge("serve_step_achieved_tflops").value() == pytest.approx(3.2e12 / 0.102 / 1e12)
    else:
        assert reg.get("serve_step_achieved_tflops") is None


def test_step_monitor_without_a_registry_keeps_its_stats():
    mon = StepMonitor()
    mon.start()
    stats = mon.stop()
    assert stats.last_s >= 0 and stats.achieved_tflops == 0.0
    with pytest.raises(RuntimeError):
        mon.stop()
