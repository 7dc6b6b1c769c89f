"""Asyncio HTTP/JSON gateway: token streaming + explicit backpressure
(twin of ``repro.serve.gateway``).

Zero-dependency HTTP/1.1 front for the replica pool (stdlib asyncio
only — the container policy forbids new packages, and the protocol
surface is three routes):

  POST /v1/generate   body: {"prompt": [int, ...], "max_new_tokens": N,
                             "session": "...", "stream": true|false}
                      stream=true  -> chunked ``application/x-ndjson``:
                        one {"rid", "index", "token"} line per token in
                        generation order, then a terminal {"rid",
                        "done": true, "n_tokens", "ttft_s",
                        "latency_s"} line;
                      stream=false -> one JSON body after completion.
  GET  /metrics       Prometheus text exposition of the shared
                      registry (engine tick/TTFT/queue series
                      included).
  GET  /healthz       {"ok": true, "replicas": N, "queued": Q,
                       "states": {idx: "healthy"|"suspect"|"dead"|
                       "recovering"}, ...}

Backpressure is explicit and two-layered: the gateway rejects with
``429 Retry-After`` when pool-wide in-flight work exceeds its own
``max_inflight`` watermark, and maps the pool/engine's typed
``QueueFull`` (per-replica admission watermark, session-affinity
overload) to the same response — overload turns into a client signal,
never into unbounded queue growth.  ``submit_retries`` optionally
retries QueueFull with exponential backoff BEFORE rejecting — safe
because a refused submit was never admitted anywhere (idempotent); an
admitted request is never resubmitted by the gateway.

Failure semantics end to end: a client that disconnects mid-stream
CANCELS its request (the pool frees the slot and KV pages — a dropped
connection no longer burns decode until length-stop), and a request
that outlives ``request_timeout_s`` (or its in-engine tick deadline)
terminates with ``504 Gateway Timeout`` (unary) or a terminal
``"expired"`` line (stream).  Cancellation is applied by the pump
thread between pool steps, so engine state is never mutated
concurrently with a tick.

The engine pump is one background task: it steps the pool in a
single-thread executor (the tick blocks on device compute; handler
coroutines keep serving), then drains each in-flight request's newly
decoded tokens into its per-connection queue. Connections are
close-delimited (``Connection: close``), which keeps clients trivial.

On the card the pump thread issues every kernel launch.  Nothing in the
launch path depends on the thread: each launcher sets the device from
its tensors' (``cudaSetDevice``), the thread's current stream is the
default stream as on the main thread, so the per-device-and-stream split
workspaces are the same ones, and only this one thread steps the pool.
The kernels' build lock is a process-wide ``threading.Lock``; build them
(``kernels._build.build_all``) before ``start`` so no request waits on
``nvcc``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json

import numpy as np

from repro_torch.launch.serve import QueueFull, Request
from repro_torch.serve.pool import ReplicaPool

__all__ = ["Gateway"]

_MAX_BODY = 1 << 20


class _Inflight:
    __slots__ = ("req", "queue", "sent")

    def __init__(self, req: Request):
        self.req = req
        self.queue: asyncio.Queue = asyncio.Queue()
        self.sent = 0           # tokens already pushed to the client


class Gateway:
    def __init__(self, pool: ReplicaPool, *, host: str = "127.0.0.1",
                 port: int = 8080, max_inflight: int | None = None,
                 retry_after_s: float = 1.0, metrics=None,
                 request_timeout_s: float | None = None,
                 submit_retries: int = 0,
                 retry_backoff_s: float = 0.05):
        self.pool = pool
        self.host = host
        self.port = port
        # Default watermark: every replica's queue watermark plus its
        # slots — i.e. "the pool can actually hold this much work".
        if max_inflight is None:
            per = (pool.max_queue if pool.max_queue is not None else 64)
            max_inflight = pool.max_replicas * (per + pool.batch)
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s
        self.request_timeout_s = request_timeout_s
        self.submit_retries = submit_retries
        self.retry_backoff_s = retry_backoff_s
        self.metrics = metrics if metrics is not None else pool.metrics
        self._inflight: dict[int, _Inflight] = {}
        self._cancels: set[int] = set()   # applied between pool steps
        self._rid = 0
        self._server: asyncio.AbstractServer | None = None
        self._pump_task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._closing = False
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-pump")

    # ------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.create_task(self._pump())

    async def stop(self) -> None:
        self._closing = True
        self._wake.set()
        if self._pump_task is not None:
            await self._pump_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._exec.shutdown(wait=False)

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # ----------------------------------------------------- engine pump

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closing:
            if self.pool.idle and not self._inflight \
                    and not self._cancels:
                self._wake.clear()
                await self._wake.wait()
                continue
            await loop.run_in_executor(self._exec, self._step_pool)
            self._drain()
            # yield so handler coroutines flush their token queues
            await asyncio.sleep(0)

    def _step_pool(self) -> int:
        """Runs on the pump thread: apply pending cancellations, then
        step.  Cancels mutate engine slot state, so they must never
        interleave with a tick — routing them through here serializes
        them with the step they precede."""
        while self._cancels:
            self.pool.cancel(self._cancels.pop())
        return self.pool.step()

    def _cancel(self, req: Request) -> None:
        """Client disconnected: drop the stream and schedule the
        request's cancellation (slot + KV pages freed, in-flight
        accounting decremented)."""
        self._inflight.pop(req.rid, None)
        if not req.done:
            self._cancels.add(req.rid)
            self._wake.set()
        if self.metrics is not None:
            self.metrics.counter(
                "gateway_disconnects",
                "streams dropped by the client before completion").inc()

    def _drain(self) -> None:
        """Push newly decoded tokens of every in-flight request into
        its connection queue, preserving generation order."""
        for rid, st in list(self._inflight.items()):
            toks = st.req.out_tokens
            while st.sent < len(toks):
                st.queue.put_nowait(("token", st.sent, toks[st.sent]))
                st.sent += 1
            if st.req.done:
                st.queue.put_nowait(("done", st.sent, None))
                del self._inflight[rid]

    # ------------------------------------------------------- protocol

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            method, path, headers, body = await self._read_request(reader)
        except (asyncio.IncompleteReadError, ValueError):
            writer.close()
            return
        try:
            if method == "GET" and path == "/metrics":
                await self._respond_metrics(writer)
            elif method == "GET" and path == "/healthz":
                states = {str(i): s.name.lower() for i, s
                          in sorted(self.pool.monitor.states().items())}
                await self._respond_json(writer, 200, {
                    "ok": self.pool.n_active > 0,
                    "replicas": self.pool.n_active,
                    "queued": self.pool.total_queued(),
                    "states": states,
                    "deaths": self.pool.monitor.deaths,
                    "recovered": len(self.pool.recovery_events)})
            elif method == "POST" and path == "/v1/generate":
                await self._handle_generate(writer, reader, body)
            else:
                await self._respond_json(writer, 404, {
                    "error": f"no route {method} {path}"})
        finally:
            try:
                await writer.drain()
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, BrokenPipeError):
                pass

    async def _read_request(self, reader) -> tuple[str, str, dict, bytes]:
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        method, path, _ = lines[0].split(" ", 2)
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0"))
        if n > _MAX_BODY:
            raise ValueError(f"body too large ({n} bytes)")
        body = await reader.readexactly(n) if n else b""
        return method.upper(), path, headers, body

    # -------------------------------------------------------- routes

    async def _handle_generate(self, writer, reader,
                               body: bytes) -> None:
        try:
            payload = json.loads(body or b"{}")
            prompt = np.asarray(payload["prompt"], np.int32)
            if prompt.ndim != 1 or prompt.size == 0:
                raise ValueError("prompt must be a non-empty int list")
        except (KeyError, ValueError, TypeError) as e:
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        if self.metrics is not None:
            self.metrics.counter(
                "gateway_requests", "generate requests received").inc()
        if self.pool.total_inflight() >= self.max_inflight:
            await self._reject(writer, "gateway at max in-flight "
                               f"({self.max_inflight})")
            return
        self._rid += 1
        req = Request(
            rid=self._rid, prompt=prompt,
            max_new_tokens=int(payload.get("max_new_tokens", 16)),
            session=payload.get("session"),
            deadline_ticks=payload.get("deadline_ticks"))
        st = _Inflight(req)
        # Submit retries are safe ONLY here: a QueueFull submit never
        # entered any queue, so resubmitting cannot duplicate work.
        # Once admitted, the request is never resubmitted.
        replica = None
        for attempt in range(self.submit_retries + 1):
            try:
                replica = self.pool.submit(req)
                break
            except QueueFull as e:
                if attempt == self.submit_retries:
                    await self._reject(writer, str(e))
                    return
                await asyncio.sleep(
                    self.retry_backoff_s * (2 ** attempt))
            except ValueError as e:    # oversized prompt
                await self._respond_json(writer, 400, {"error": str(e)})
                return
        self._inflight[req.rid] = st
        self._wake.set()
        if payload.get("stream", True):
            await self._stream_response(writer, reader, req, st, replica)
        else:
            await self._unary_response(writer, reader, req, st, replica)

    async def _next_event(self, st: _Inflight, eof: asyncio.Task,
                          deadline: float | None):
        """One of ("token", i, tok) / ("done", n, None) /
        ("disconnect",) / ("timeout",): the stream's token queue raced
        against client EOF and the request deadline."""
        loop = asyncio.get_running_loop()
        timeout = None if deadline is None \
            else max(deadline - loop.time(), 0.0)
        get = asyncio.ensure_future(st.queue.get())
        done, _ = await asyncio.wait(
            {get, eof}, timeout=timeout,
            return_when=asyncio.FIRST_COMPLETED)
        if get in done:
            return get.result()
        get.cancel()
        if eof in done:
            return ("disconnect",)
        return ("timeout",)

    def _timeout(self, req: Request) -> None:
        self._inflight.pop(req.rid, None)
        if not req.done:
            self._cancels.add(req.rid)
            self._wake.set()
        if self.metrics is not None:
            self.metrics.counter(
                "gateway_timeouts",
                "requests terminated at request_timeout_s").inc()

    async def _stream_response(self, writer, reader, req: Request,
                               st: _Inflight, replica: int) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: close\r\n"
            + f"X-Replica: {replica}\r\n\r\n".encode())
        await writer.drain()
        # the request body is fully consumed, so any further read
        # resolving means the client closed its end — EOF doubles as
        # the disconnect watch
        eof = asyncio.ensure_future(reader.read(1))
        loop = asyncio.get_running_loop()
        deadline = None if self.request_timeout_s is None \
            else loop.time() + self.request_timeout_s
        try:
            while True:
                ev = await self._next_event(st, eof, deadline)
                if ev[0] == "disconnect":
                    self._cancel(req)
                    return
                if ev[0] == "timeout":
                    self._timeout(req)
                    self._write_chunk(writer, {
                        "rid": req.rid, "done": True, "expired": True,
                        "error": "request timed out"})
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
                kind, index, tok = ev
                if kind == "done":
                    tail = {"rid": req.rid, "done": True,
                            "n_tokens": index, "ttft_s": req.ttft_s,
                            "latency_s": req.latency_s}
                    if req.expired:
                        tail["expired"] = True
                    if req.recoveries:
                        tail["recoveries"] = req.recoveries
                    self._write_chunk(writer, tail)
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
                try:
                    self._write_chunk(writer, {
                        "rid": req.rid, "index": index,
                        "token": int(tok)})
                    await writer.drain()
                except (ConnectionError, BrokenPipeError):
                    self._cancel(req)
                    return
        finally:
            eof.cancel()

    async def _unary_response(self, writer, reader, req: Request,
                              st: _Inflight, replica: int) -> None:
        eof = asyncio.ensure_future(reader.read(1))
        loop = asyncio.get_running_loop()
        deadline = None if self.request_timeout_s is None \
            else loop.time() + self.request_timeout_s
        try:
            while True:
                ev = await self._next_event(st, eof, deadline)
                if ev[0] == "disconnect":
                    self._cancel(req)
                    return
                if ev[0] == "timeout":
                    self._timeout(req)
                    await self._respond_json(writer, 504, {
                        "rid": req.rid, "error": "request timed out"})
                    return
                if ev[0] == "done":
                    break
        finally:
            eof.cancel()
        if req.expired:
            await self._respond_json(writer, 504, {
                "rid": req.rid, "error": "request deadline expired",
                "tokens": list(req.out_tokens)})
            return
        await self._respond_json(writer, 200, {
            "rid": req.rid, "tokens": list(req.out_tokens),
            "ttft_s": req.ttft_s, "latency_s": req.latency_s,
            "replica": replica, "recoveries": req.recoveries})

    def _write_chunk(self, writer, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    async def _reject(self, writer, detail: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "gateway_rejected",
                "requests refused with 429 backpressure").inc()
        await self._respond_json(
            writer, 429,
            {"error": "queue full", "detail": detail,
             "retry_after_s": self.retry_after_s},
            extra_headers={"Retry-After":
                           f"{max(int(self.retry_after_s), 1)}"})

    async def _respond_metrics(self, writer) -> None:
        text = self.metrics.expose() if self.metrics is not None else ""
        data = text.encode()
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/plain; version=0.0.4\r\n"
            + f"Content-Length: {len(data)}\r\n".encode()
            + b"Connection: close\r\n\r\n" + data)
        await writer.drain()

    _STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
               429: "Too Many Requests", 504: "Gateway Timeout"}

    async def _respond_json(self, writer, status: int, obj: dict,
                            extra_headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        head = (f"HTTP/1.1 {status} {self._STATUS.get(status, '')}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n")
        for k, v in (extra_headers or {}).items():
            head += f"{k}: {v}\r\n"
        head += "Connection: close\r\n\r\n"
        writer.write(head.encode() + data)
        await writer.drain()
