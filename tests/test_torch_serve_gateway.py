"""The port's HTTP gateway over loopback, in front of the port's pool of
real engines (smoke gemma3-1b on the kernel routes, their plain versions
on the CPU): streamed tokens equal ``pool.run``'s, 429 + Retry-After past
the in-flight watermark, a client disconnect frees its slot, and
``/metrics`` / ``/healthz`` report what was served."""

import asyncio
import json
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.launch.serve import Request
from repro_torch.models import api
from repro_torch.serve.gateway import Gateway
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.pool import ReplicaPool

POLICY = dict(default="bf16", logits="refine_ab",
              backends={"gemm": "cuda", "attention": "cuda_fused"},
              require={"attention": ("decode",)})


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke("gemma3-1b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    return cfg, params


def _pool(model, metrics=None, replicas=2):
    cfg, params = model
    return ReplicaPool(cfg, params, replicas=replicas, batch_size=2, max_ctx=64,
                       policy=execution_policy_for(cfg, **POLICY), max_queue=4,
                       metrics=metrics)


def _prompts(cfg, n=4):
    rng = np.random.default_rng(3)
    return [rng.integers(2, cfg.vocab_size, 6 + 3 * i).astype(np.int32) for i in range(n)]


async def _open(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Length: {len(data)}\r\n\r\n"
                 .encode() + data)
    await writer.drain()
    return reader, writer


async def _http(port, method, path, body=None):
    reader, writer = await _open(port, method, path, body)
    raw = await asyncio.wait_for(reader.read(-1), timeout=60)
    writer.close()
    return raw.decode()


async def _next_line(reader):
    """The next ndjson object of a chunked stream."""
    while True:
        line = await asyncio.wait_for(reader.readline(), timeout=60)
        if line.startswith(b"{"):
            return json.loads(line)
        if not line:
            raise EOFError


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


def test_streamed_tokens_equal_pool_run_and_metrics_count_them(model):
    cfg, _ = model
    prompts = _prompts(cfg)
    ref = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    _pool(model).run(ref)

    reg = MetricsRegistry()
    pool = _pool(model, reg)

    async def scenario():
        gw = Gateway(pool, host="127.0.0.1", port=0, metrics=reg)
        await gw.start()
        try:
            resps = await asyncio.gather(*[
                _http(gw.port, "POST", "/v1/generate",
                      {"prompt": p.tolist(), "max_new_tokens": 6, "stream": True})
                for p in prompts])
            unary = await _http(gw.port, "POST", "/v1/generate",
                                {"prompt": prompts[0].tolist(), "max_new_tokens": 6,
                                 "stream": False})
            return resps, unary, await _http(gw.port, "GET", "/metrics"), \
                await _http(gw.port, "GET", "/healthz")
        finally:
            await gw.stop()

    resps, unary, text, health = _run(scenario())
    streamed = []
    for resp, r in zip(resps, ref):
        assert resp.startswith("HTTP/1.1 200") and "application/x-ndjson" in resp
        lines = [json.loads(ln) for ln in resp.splitlines() if ln.startswith("{")]
        body, tail = lines[:-1], lines[-1]
        assert [ln["index"] for ln in body] == list(range(6))
        assert [ln["token"] for ln in body] == r.out_tokens
        assert tail["done"] and tail["n_tokens"] == 6
        streamed += [ln["token"] for ln in body]
    assert json.loads(unary.split("\r\n\r\n", 1)[1])["tokens"] == ref[0].out_tokens
    served = sum(int(float(v)) for v in re.findall(r'^serve_tokens_total\{replica="\d+"\} (\S+)$',
                                                     text, re.M))
    assert served == len(streamed) + 6 == pool.tokens_generated
    assert "# TYPE serve_ttft_seconds histogram" in text
    state = json.loads(health.split("\r\n\r\n", 1)[1])
    assert state["ok"] is True and state["replicas"] == 2
    assert set(state["states"].values()) == {"healthy"}


def test_over_watermark_submit_gets_429_with_retry_after(model):
    cfg, _ = model
    prompt = _prompts(cfg, 1)[0].tolist()
    reg = MetricsRegistry()
    pool = _pool(model, reg, replicas=1)

    async def scenario():
        gw = Gateway(pool, host="127.0.0.1", port=0, metrics=reg, max_inflight=1,
                     retry_after_s=2.0)
        await gw.start()
        try:
            reader, writer = await _open(gw.port, "POST", "/v1/generate",
                                         {"prompt": prompt, "max_new_tokens": 40})
            first = await _next_line(reader)          # the first request is in flight
            second = await _http(gw.port, "POST", "/v1/generate",
                                 {"prompt": prompt, "max_new_tokens": 4})
            rest = (await asyncio.wait_for(reader.read(-1), timeout=60)).decode()
            writer.close()
            return first, second, rest
        finally:
            await gw.stop()

    first, second, rest = _run(scenario())
    assert first["index"] == 0
    assert second.startswith("HTTP/1.1 429") and "Retry-After: 2\r\n" in second
    assert json.loads(second.split("\r\n\r\n", 1)[1])["retry_after_s"] == 2.0
    assert '"done": true' in rest
    assert reg.counter("gateway_rejected").value() == 1


def test_client_disconnect_frees_its_slot(model):
    cfg, _ = model
    prompt = _prompts(cfg, 1)[0].tolist()
    reg = MetricsRegistry()
    pool = _pool(model, reg, replicas=1)

    async def scenario():
        gw = Gateway(pool, host="127.0.0.1", port=0, metrics=reg)
        await gw.start()
        try:
            reader, writer = await _open(gw.port, "POST", "/v1/generate",
                                         {"prompt": prompt, "max_new_tokens": 50})
            await _next_line(reader)
            await _next_line(reader)
            writer.close()
            for _ in range(600):                       # the pump applies the cancel
                if pool.idle and not gw._inflight:
                    break
                await asyncio.sleep(0.05)
            return await _http(gw.port, "GET", "/healthz")
        finally:
            await gw.stop()

    health = _run(scenario())
    eng = pool.replicas[0].engine
    assert pool.idle and all(r is None for r in eng.slot_req)
    assert not bool(eng.active.any())
    assert reg.counter("gateway_disconnects").value() == 1
    assert reg.counter("serve_requests_cancelled").value(replica="0") == 1
    assert eng.tokens_generated < 50
    assert json.loads(health.split("\r\n\r\n", 1)[1])["ok"] is True
