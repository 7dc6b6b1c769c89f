"""The port's serve stack on the model against ``repro``'s, on the CPU.

Smoke gemma3-1b at f32 with f32 activations; the port's params are
``repro``'s (``convert.from_jax_numpy``) and its engines run the kernel
routes (``cuda`` / ``cuda_fused``: the kernels' plain versions on CPU
tensors), ``repro``'s its f32 XLA route, which
``tests/test_torch_serve.py`` holds token-exact against them.  Every
check is exact: the pool's tokens at 1 and 2 replicas, ``run_sweep``'s
virtual-tick matrices (plain and chaos, wall fields left out) and the
engines' metrics series (histograms by count: their values are wall
seconds).

``repro`` builds a jitted tick and prefill per engine; the fixture
``shared_repro_steps`` caches its step builders so that the engines of
one config and policy share their compiles (the functions are pure)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.serve import QueueFull as JQueueFull
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import api as japi
from repro.runtime import serve_step as jserve_step
from repro.serve import loadgen as jloadgen
from repro.serve import metrics as jmetrics
from repro.serve.faults import FaultPlan as JFaultPlan
from repro.serve.pool import ReplicaPool as JReplicaPool
from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.convert import from_jax_numpy
from repro_torch.launch.serve import QueueFull, Request, ServeEngine
from repro_torch.serve import loadgen, metrics
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.pool import ReplicaPool

MAX_CTX = 48
KERNELS = {"gemm": "cuda", "attention": "cuda_fused"}
SPEC = dict(n_requests=8, prompt_median=6.0, prompt_sigma=0.4, max_prompt=12,
            out_median=5.0, out_sigma=0.5, max_out=8, seed=0)
WALL = ("wall_s", "tok_per_s_wall")
CHAOS = "7:crash@6,hang@14x4"


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_get_smoke("gemma3-1b"), activation_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("gemma3-1b"), activation_dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture
def shared_repro_steps(monkeypatch):
    monkeypatch.setattr(jserve_step, "make_engine_tick",
                        functools.cache(jserve_step.make_engine_tick))
    monkeypatch.setattr(jserve_step, "make_prefill", functools.cache(jserve_step.make_prefill))


@pytest.fixture
def repro_kv_tile(monkeypatch):
    """repro's fused attention kernels walk the KV sequence in the port's
    32-row tiles (as in tests/test_torch_serve.py)."""
    import repro.kernels.attention_fused as jaf
    monkeypatch.setattr(jaf, "flash_attention",
                        functools.partial(jaf.flash_attention, block_kv=32))
    monkeypatch.setattr(jaf, "flash_decode", functools.partial(jaf.flash_decode, block_kv=32))


def _policy(tcfg, paged=False):
    return execution_policy_for(tcfg, default="f32", backends=KERNELS, require={
        "attention": ("decode", "paged_decode") if paged else ("decode",)})


def _stream(cls, vocab):
    rng = np.random.default_rng(41)
    return [cls(rid=i, prompt=rng.integers(2, vocab, 5 + (3 * i) % 8).astype(np.int32),
                max_new_tokens=3 + i % 5) for i in range(7)]


def test_pool_tokens_at_one_and_two_replicas_equal_repro(models, shared_repro_steps,
                                                         repro_kv_tile):
    jcfg, jparams, tcfg, tparams = models
    jreqs = _stream(JRequest, jcfg.vocab_size)
    JReplicaPool(jcfg, jparams, replicas=2, batch_size=2, max_ctx=MAX_CTX,
                 policy=JPolicy.uniform("f32")).run(jreqs)
    for replicas in (1, 2):
        reqs = _stream(Request, tcfg.vocab_size)
        pool = ReplicaPool(tcfg, tparams, replicas=replicas, batch_size=2, max_ctx=MAX_CTX,
                           policy=_policy(tcfg))
        stats = pool.run(reqs)
        assert stats["replicas"] == replicas
        assert all(r.engine.tokens_generated > 0 for r in pool.replicas)
        assert all(r.engine.device.type == "cpu" for r in pool.replicas)
        # the replicas share the one params tree: nothing was copied
        assert all(r.engine.params is tparams for r in pool.replicas)
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
        assert pool.pages_outstanding() == 0


def _strip(payload):
    return {**payload, "points": [{k: v for k, v in p.items() if k not in WALL}
                                  for p in payload["points"]]}


@pytest.mark.parametrize("chaos", [None, CHAOS], ids=["plain", "chaos"])
def test_run_sweep_tick_matrices_equal_repro(models, shared_repro_steps, repro_kv_tile, chaos):
    """Two rates on 2 dense replicas, or one rate under the fault plan on
    8-row pages (the recovery columns and the reference engine's
    token-exactness included)."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(replicas=2, batch_size=2, max_ctx=MAX_CTX, max_queue=4)
    if chaos is None:
        rates, jpol, tpol = [0.3, 1.0], JPolicy.uniform("f32"), _policy(tcfg)
    else:
        rates, jpol, tpol = [0.4], JPolicy.uniform("f32"), _policy(tcfg, paged=True)
        kw.update(kv_layout="paged", kv_page_size=8)
    jout = jloadgen.run_sweep(jcfg, jparams, rates=rates, spec=jloadgen.LoadSpec(**SPEC),
                              policy=jpol, chaos=chaos and JFaultPlan.parse(chaos), **kw)
    out = loadgen.run_sweep(tcfg, tparams, rates=rates, spec=loadgen.LoadSpec(**SPEC),
                            policy=tpol, chaos=chaos and FaultPlan.parse(chaos), **kw)
    assert _strip(out) == _strip(jout)
    for p in out["points"]:
        assert p["completed"] + p["rejected"] == SPEC["n_requests"]
        if chaos:
            assert p["replica_deaths"] >= 1 and p["requests_recovered"] >= 1
            assert p["recovered_token_exact"] and p["leaked_pages"] == 0
    if chaos is None:
        assert out["points"][-1]["rejected"] or \
            out["points"][-1]["p99_ttft_ticks"] > out["points"][0]["p99_ttft_ticks"]


def _series(reg, module):
    """name -> (kind, help, {labels: value}); a histogram's value is its
    count and a wall-derived gauge's is left out."""
    out = {}
    for name, m in sorted(reg._metrics.items()):
        cells = {}
        for key, cell in m._series.items():
            if isinstance(m, module.Histogram):
                cells[key] = cell.count
            elif name != "serve_tokens_per_s":
                cells[key] = cell.value
            else:
                cells[key] = None
        out[name] = (m.kind, m.help, cells)
    return out


def _drive(request_cls, queue_full, eng, vocab):
    """Submissions past the watermark, a cancel in a slot, a deadline
    that expires in the queue, then the rest to completion."""
    reqs = _stream(request_cls, vocab)
    reqs[2].deadline_ticks = 1
    rejected = []
    for r in reqs[:5]:
        try:
            eng.submit(r)
        except queue_full:
            rejected.append(r.rid)
    eng.step()
    eng.cancel(reqs[0].rid)
    eng.step()
    for r in reqs[5:]:
        eng.submit(r)
    while not eng.idle:
        eng.step()
    return reqs, rejected


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_metrics_series_equal_repro(models, shared_repro_steps, repro_kv_tile, layout):
    jcfg, jparams, tcfg, tparams = models
    kv = dict(kv_layout=layout)
    jreg, reg = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=MAX_CTX, policy=JPolicy.uniform("f32"),
                        max_queue=3, metrics=jreg, replica="r1", **kv)
    jeng.load(jparams)
    eng = ServeEngine(tcfg, batch_size=2, max_ctx=MAX_CTX, policy=_policy(tcfg, layout == "paged"),
                      max_queue=3, metrics=reg, replica="r1", device="cpu", **kv)
    eng.load(tparams)
    jreqs, jrej = _drive(JRequest, JQueueFull, jeng, jcfg.vocab_size)
    reqs, rej = _drive(Request, QueueFull, eng, tcfg.vocab_size)
    assert rej == jrej and rej
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    got, want = _series(reg, metrics), _series(jreg, jmetrics)
    assert got == want
    for name in ("serve_requests_rejected", "serve_requests_cancelled", "serve_requests_expired",
                 "serve_tick_seconds", "serve_ttft_seconds", "serve_tokens_per_s"):
        assert name in got
    tokens = got["serve_tokens"][2][(("replica", "r1"),)]
    assert tokens == sum(len(r.out_tokens) for r in reqs) == eng.tokens_generated
    assert eng.pages_outstanding() == 0
