"""Synthetic open-loop load generator -> ``BENCH_serve_torch.json``
(twin of ``repro.serve.loadgen``).

The paper's throughput tables are steady-state numbers; serving only
inherits them if the layer above the kernels keeps the batch full
under bursty, heavy-tailed traffic.  Each arrival-rate point drives a
fresh replica pool with

  * **Poisson arrivals** (open loop: arrivals do not wait for
    completions — overload shows up as queueing and rejection, not as
    a politely self-throttling client), and
  * **heavy-tailed lognormal prompt and output lengths**,

and reports p50/p99 TTFT, p50/p99 end-to-end latency, goodput and
rejection rate per point.

Time is VIRTUAL: one engine tick is the unit.  Latencies in ticks,
goodput in tokens/tick.  With greedy decode on fixed params, a fixed
seed and ``eos_id=-1`` (termination purely by token budget), every
point is deterministic, and equal to ``repro``'s wherever the tokens
are.  Wall-clock throughput and peak device memory are recorded
alongside as info fields.

CLI (writes ``BENCH_serve_torch.json``, or ``BENCH_serve_chaos_torch.json``
under ``--chaos``, in the working directory; ``--device cuda`` by
default, which fails without a card):

    PYTHONPATH=src python -m repro_torch.serve.loadgen --arch gemma3-1b \\
        --smoke --device cpu --replicas 2 --rates 0.1,0.3,0.6 --requests 30
    PYTHONPATH=src python -m repro_torch.serve.loadgen --arch gemma3-1b \\
        --backend gemm=cuda --backend attention=cuda_fused --max-ctx 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np

import torch

from repro_torch.core.tree import leaves
from repro_torch.launch.serve import QueueFull, Request, ServeEngine
from repro_torch.serve.autoscale import Autoscaler, AutoscalePolicy
from repro_torch.serve.pool import ReplicaPool

__all__ = ["LoadSpec", "sample_workload", "run_point", "run_sweep", "main"]

# Tick budget per point: open-loop queues drain in bounded time because
# rejection bounds backlog, but a mis-sized sweep should fail loudly.
_MAX_TICKS = 50_000


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Workload shape for one sweep (lengths in tokens, rates per
    tick).  Lognormal medians/sigmas give the heavy right tail real
    prompt traffic has."""
    n_requests: int = 30
    prompt_median: float = 8.0
    prompt_sigma: float = 0.6
    max_prompt: int = 24
    out_median: float = 6.0
    out_sigma: float = 0.5
    max_out: int = 16
    seed: int = 0

    def lengths(self, rng: np.random.Generator,
                ) -> tuple[np.ndarray, np.ndarray]:
        def logn(median, sigma, hi):
            x = rng.lognormal(math.log(median), sigma, self.n_requests)
            return np.clip(np.round(x), 1, hi).astype(np.int64)
        return (logn(self.prompt_median, self.prompt_sigma,
                     self.max_prompt),
                logn(self.out_median, self.out_sigma, self.max_out))


def sample_workload(spec: LoadSpec, rate: float, vocab: int,
                    ) -> list[tuple[int, Request]]:
    """(arrival_tick, Request) list for one open-loop Poisson run at
    ``rate`` requests/tick.  One seeded generator drives arrivals,
    lengths and prompt tokens, so a point is a pure function of
    (spec, rate, vocab)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([spec.seed, int(rate * 1e6)]))
    inter = rng.exponential(1.0 / rate, spec.n_requests)
    arrivals = np.floor(np.cumsum(inter)).astype(np.int64)
    prompts, outs = spec.lengths(rng)
    reqs = []
    for i in range(spec.n_requests):
        prompt = rng.integers(2, vocab, prompts[i]).astype(np.int32)
        reqs.append((int(arrivals[i]),
                     Request(rid=i, prompt=prompt,
                             max_new_tokens=int(outs[i]))))
    return reqs


def run_point(pool, spec: LoadSpec, rate: float, *, vocab: int,
              autoscaler=None, chaos=None, reference=None, work=None) -> dict:
    """Drive one arrival-rate point through ``pool`` in virtual time.

    Arrivals scheduled at tick t are submitted before step t runs; a
    token first observed after step t counts latency ``t + 1 -
    arrival``.  Rejected submissions (QueueFull anywhere in the
    admission path) are dropped and counted — open loop, no retry.

    With ``chaos`` (a ``serve.faults.FaultPlan`` already baked into the
    pool's engine factory) the point additionally reports the recovery
    columns: replica deaths, recovered requests, p99 recovery latency,
    recovered-request goodput, the allocator leak audit
    (``leaked_pages`` must be 0), and — when ``reference`` (a
    ``(prompt, max_new) -> tokens`` oracle serving one request on an
    undisturbed engine) is given — ``recovered_token_exact``, the bit-
    identity of every recovered stream against its undisturbed twin.

    ``work`` is the point's ``sample_workload(spec, rate, vocab)``; a
    caller that passes it keeps the requests, to audit every stream.
    """
    if work is None:
        work = sample_workload(spec, rate, vocab)
    pending = list(work)
    arrival = {req.rid: t for t, req in work}
    ttft: dict[int, int] = {}
    e2e: dict[int, int] = {}
    inflight: list[Request] = []
    rejected = 0
    tick0 = pool.ticks
    t_wall = time.monotonic()
    tok0 = pool.tokens_generated
    while pending or not pool.idle:
        now = pool.ticks - tick0
        while pending and pending[0][0] <= now:
            _, req = pending.pop(0)
            try:
                pool.submit(req)
                inflight.append(req)
            except QueueFull:
                rejected += 1
        tokens = pool.step()
        if autoscaler is not None:
            autoscaler.observe(tokens)
        now = pool.ticks - tick0
        for req in inflight:
            if req.out_tokens and req.rid not in ttft:
                ttft[req.rid] = now - arrival[req.rid]
            if req.done and req.rid not in e2e:
                e2e[req.rid] = now - arrival[req.rid]
        inflight = [r for r in inflight if not r.done]
        if now > _MAX_TICKS:
            raise RuntimeError(
                f"loadgen point rate={rate} exceeded {_MAX_TICKS} ticks")
    wall_s = time.monotonic() - t_wall
    total_ticks = pool.ticks - tick0
    done = sorted(e2e)
    lat = np.array([e2e[r] for r in done], np.float64)
    fst = np.array([ttft[r] for r in done], np.float64)
    tokens = pool.tokens_generated - tok0
    good_tokens = sum(
        len(req.out_tokens) for _, req in work if req.done)

    def pct(xs, q):
        return float(np.percentile(xs, q)) if len(xs) else 0.0

    point = {
        "arrival_rate": rate,
        "requests": spec.n_requests,
        "completed": len(done),
        "rejected": rejected,
        "rejection_rate": round(rejected / spec.n_requests, 6),
        "p50_ttft_ticks": round(pct(fst, 50), 4),
        "p99_ttft_ticks": round(pct(fst, 99), 4),
        "p50_e2e_ticks": round(pct(lat, 50), 4),
        "p99_e2e_ticks": round(pct(lat, 99), 4),
        "goodput_tok_per_tick": round(
            good_tokens / max(total_ticks, 1), 6),
        "total_ticks": total_ticks,
        "tokens": tokens,
        # wall-clock throughput: machine-dependent, info only (each tick
        # reads its tokens back, so the clock stops after the device)
        "wall_s": round(wall_s, 4),
        "tok_per_s_wall": round(tokens / max(wall_s, 1e-9), 2),
    }
    if chaos is None:
        return point
    # ---- recovery columns (chaos runs only)
    recs = pool.recovery_events
    rec_lat = np.array([ev.latency_ticks for ev in recs], np.float64)
    recovered_rids = {ev.rid for ev in recs}
    recovered_reqs = [req for _, req in work
                      if req.rid in recovered_rids and req.done
                      and not (req.expired or req.cancelled)]
    exact = True
    for req in recovered_reqs:
        if reference is not None:
            ref = reference(req.prompt, req.max_new_tokens)
            if list(req.out_tokens) != list(ref):
                exact = False
    point.update({
        "chaos": chaos.describe(),
        "replica_deaths": pool.monitor.deaths,
        "requests_recovered": len(recs),
        "p99_recovery_ticks": round(pct(rec_lat, 99), 4),
        "recovered_goodput_tok_per_tick": round(
            sum(len(r.out_tokens) for r in recovered_reqs)
            / max(total_ticks, 1), 6),
        "recovered_token_exact": bool(exact),
        # allocator free-count audit: every page a dead replica held
        # must have come back through the allocator free path
        "leaked_pages": pool.pages_outstanding(),
        "expired": sum(req.expired for _, req in work),
    })
    return point


def run_sweep(cfg, params, *, rates, spec: LoadSpec, replicas: int = 2,
              batch_size: int = 4, max_ctx: int = 64, policy=None,
              max_queue: int | None = 8, autoscale=None,
              metrics=None, chaos=None, health=None,
              kv_layout: str = "dense", kv_page_size: int = 8,
              kv_quant: str | None = None,
              kv_pages: int | None = None) -> dict:
    """One pool per rate point (points stay independent; engines share
    the params tree and live on its device), swept lowest rate first.

    ``chaos`` (a ``serve.faults.FaultPlan``) wraps each point's engine
    factory so the SAME seeded fault schedule hits every rate point;
    recovery needs repair, so a chaos sweep always runs an autoscaler
    (default policy when ``autoscale`` is None).  The kv_* knobs route
    the engines through the paged / quantized cache layouts, exercising
    dead-replica page reclamation for real."""
    device = leaves(params)[0].device
    kv_kwargs = dict(kv_layout=kv_layout, kv_page_size=kv_page_size,
                     kv_quant=kv_quant, kv_pages=kv_pages, device=device)

    def engine_factory(idx, pol):
        eng = ServeEngine(
            cfg, batch_size=batch_size, max_ctx=max_ctx, policy=pol,
            eos_id=-1, max_queue=max_queue, metrics=metrics,
            replica=str(idx), **kv_kwargs)
        eng.load(params)
        return eng

    reference = None
    if chaos is not None:
        # undisturbed oracle for the token-exactness column: one fresh
        # single-slot engine serving one request at a time (batch-
        # composition independence makes that the canonical stream)
        ref_eng = ServeEngine(cfg, batch_size=1, max_ctx=max_ctx,
                              policy=policy, eos_id=-1, **kv_kwargs)
        ref_eng.load(params)

        def reference(prompt, max_new):
            req = Request(rid=0, prompt=prompt, max_new_tokens=max_new)
            ref_eng.run([req])
            return list(req.out_tokens)

        if autoscale is None:
            autoscale = AutoscalePolicy(
                min_replicas=max(1, replicas),
                max_replicas=max(replicas, 2))
    points = []
    for rate in sorted(rates):
        factory = engine_factory
        if chaos is not None:
            factory = chaos.wrap_factory(factory, n_replicas=replicas)
        pool = ReplicaPool(
            cfg, params, replicas=replicas, batch_size=batch_size,
            max_ctx=max_ctx, policy=policy, max_queue=max_queue,
            eos_id=-1,  # budget-only termination => deterministic ticks
            metrics=metrics, health=health, engine_factory=factory)
        scaler = None
        if autoscale is not None:
            scaler = Autoscaler(pool, autoscale, metrics=metrics)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        point = run_point(pool, spec, rate, vocab=cfg.vocab_size,
                          autoscaler=scaler, chaos=chaos,
                          reference=reference)
        if device.type == "cuda":   # info only, as the wall fields
            point["peak_mem_gb"] = round(
                torch.cuda.max_memory_allocated(device) / 1e9, 3)
        if scaler is not None:
            point["replicas_final"] = pool.n_active
            point["scale_events"] = len(pool.scale_events)
        points.append(point)
    out = {
        "bench": "serve",
        "replicas": replicas,
        "batch_size": batch_size,
        "max_ctx": max_ctx,
        "max_queue": max_queue,
        "seed": spec.seed,
        "n_requests": spec.n_requests,
        "units": "virtual engine ticks (deterministic; wall fields "
                 "are info-only)",
        "points": points,
    }
    if chaos is not None:
        out["bench"] = "serve_chaos"
        out["chaos"] = chaos.describe()
        out["kv_layout"] = kv_layout
        if kv_quant:
            out["kv_quant"] = kv_quant
    return out


def main(argv=None) -> None:
    from repro_torch.configs import ARCHS, get_config, get_smoke
    from repro_torch.configs.base import execution_policy_for
    from repro_torch.core import ops
    from repro_torch.models import api
    from repro_torch.runtime.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-ctx", type=int, default=64)
    ap.add_argument("--max-queue", type=int, default=8)
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--rates", default="0.1,0.3,0.6",
                    help="comma-separated arrival rates (requests/tick)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="bf16")
    ap.add_argument("--backend", action="append", default=None,
                    metavar="FAMILY=IMPL",
                    help="op-registry routing, repeatable (as in "
                         "repro_torch.launch.serve), e.g. gemm=cuda, "
                         "attention=cuda_fused")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run; 'cuda' fails without a "
                         "card")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="enable the autoscaler over [MIN, MAX] "
                         "replicas instead of a fixed pool")
    ap.add_argument("--chaos", default=None, metavar="SEED:PLAN",
                    help="run the sweep under a seeded fault plan "
                         "(serve.faults grammar, e.g. "
                         "'7:crash@6,hang@14x4') and report the "
                         "recovery columns; recovery requires the "
                         "autoscaler's replace action, enabled "
                         "automatically. Use a deterministic policy "
                         "(--policy f32) so the recovery re-prefill "
                         "is bit-exact")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense")
    ap.add_argument("--kv-page-size", type=int, default=8)
    ap.add_argument("--kv-quant", choices=("none", "int8"),
                    default="none")
    ap.add_argument("--kv-pages", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="output path for the serve SLO matrix (default "
                         "BENCH_serve_torch.json, BENCH_serve_chaos_torch"
                         ".json for --chaos runs)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    rates = [float(r) for r in args.rates.split(",") if r]
    spec = LoadSpec(n_requests=args.requests, seed=args.seed,
                    max_prompt=max(4, args.max_ctx - 24))
    autoscale = None
    if args.autoscale:
        lo, hi = (int(x) for x in args.autoscale.split(":"))
        autoscale = AutoscalePolicy(min_replicas=lo, max_replicas=hi)
    chaos = None
    if args.chaos:
        from repro_torch.serve.faults import FaultPlan
        chaos = FaultPlan.parse(args.chaos)
    kv_quant = None if args.kv_quant == "none" else args.kv_quant
    # the engine tick decodes against the cache, so the attention route
    # must carry decode (and paged_decode on pages), as launch/serve's
    attn_caps = (("decode", "paged_decode") if args.kv_layout == "paged"
                 else ("decode",))
    policy = execution_policy_for(
        cfg, default=args.policy,
        backends=ops.parse_backend_flags(args.backend),
        require={"attention": attn_caps})
    out = args.out or ("BENCH_serve_chaos_torch.json" if chaos is not None
                       else "BENCH_serve_torch.json")
    payload = run_sweep(
        cfg, params, rates=rates, spec=spec, replicas=args.replicas,
        batch_size=args.batch, max_ctx=args.max_ctx, policy=policy,
        max_queue=args.max_queue, autoscale=autoscale, chaos=chaos,
        kv_layout=args.kv_layout, kv_page_size=args.kv_page_size,
        kv_quant=kv_quant, kv_pages=args.kv_pages)
    payload["arch"] = args.arch
    payload["smoke"] = bool(args.smoke)
    payload["policy"] = args.policy
    payload["backends"] = dict(policy.backends)
    payload["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    with open(out, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"loadgen: {len(rates)} rate point(s) -> {os.path.abspath(out)}")
    for p in payload["points"]:
        line = (f"  rate={p['arrival_rate']:.2f}: "
                f"ttft p50/p99 {p['p50_ttft_ticks']:.1f}/"
                f"{p['p99_ttft_ticks']:.1f} ticks, "
                f"e2e p99 {p['p99_e2e_ticks']:.1f}, "
                f"goodput {p['goodput_tok_per_tick']:.2f} tok/tick, "
                f"rejected {p['rejected']}/{p['requests']}")
        if chaos is not None:
            line += (f", deaths {p['replica_deaths']}, recovered "
                     f"{p['requests_recovered']} (p99 "
                     f"{p['p99_recovery_ticks']:.1f} ticks, exact="
                     f"{p['recovered_token_exact']}), leaked pages "
                     f"{p['leaked_pages']}")
        print(line)


if __name__ == "__main__":
    main()
