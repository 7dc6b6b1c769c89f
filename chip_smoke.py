#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them.
2. build   — compiles every CUDA kernel of the serve path from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
3. check   — each kernel against its plain PyTorch version on seeded
   inputs at the serve path's shapes, with its stated bound, its time,
   the plain version's time and a yardstick PyTorch call's time (CUDA
   events, in turns plain, kernel, kernel, plain), and the least time
   the card could take (the larger of FLOPs / 989 TFLOP/s and bytes /
   3.35 TB/s).  The windowed flash check also shows that its bound sees
   a window one key short.
4. serve   — gemma3-1b at full width and depth (random weights from a
   seeded generator) behind the continuous-batching engine on the
   kernel routes: 8 requests of 16-700 prompt tokens, 32 new tokens
   each, 4 slots, 1024-token context.  Every request must finish and
   every kernel must have launched during this phase; one prompt's
   prefill logits are held against the same engine on the ``torch``
   reference routes (bound and greedy token), and two faulty reference
   runs, fp8 MLPs and a window one key short, must land outside it.
5. profile — a 700-token prefill and one 4-slot decode tick: host
   wall time against the CUDA kernels' time (torch.profiler), the
   device's idle share, and the kernels that take the most of it.
6. kernels — one line listing each kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; without a GPU, or without ``src/repro_torch`` beside
this file, nothing is measured and the script exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth

# kernel-vs-plain bounds (max |kernel - plain|): same bf16 terms, exact
# products, f32 sums in another order; for attention also expf ulps and
# a probability that may round to the neighbouring bf16 value.
GEMM_BOUND = 1e-3
ATTN_BOUND = 2e-3
# serve prefill logits (|logits| <= 4.64), kernel routes vs torch
# reference routes: 0.0887 on the H100 in every run (the flash kernels
# round probabilities against a 32-row running max, the reference
# against its chunk's, so bf16 activations round apart now and then).
# Two faulty controls on the reference routes read 0.148 (a window one
# key short) and 0.581 (fp8 MLPs); every run checks that both land above.
LOGITS_BOUND = 0.12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")

    from repro_torch.configs import get_config
    from repro_torch.core import ops
    from repro_torch.core.precision import num_passes
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_fused as af
    from repro_torch.kernels import gemm_refined as gr
    from repro_torch.kernels import gemm_tiled as gt
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import api
    from repro_torch.runtime import serve_step
    from repro_torch.runtime.device import resolve_device

    # ------------------------------------------------------------ 1 device
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(dev.index)],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(dev)
    emit(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ------------------------------------------------------------- 2 build
    t0 = time.monotonic()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    log = _build.BUILD_DIR / "nvcc.log"
    log.write_text("\n".join(f"=== {k}\n{v['log']}" for k, v in built.items()))
    emit(phase="build", seconds=round(build_s, 3),
         sources={k: {"cached": v["cached"]} for k, v in built.items()},
         log=str(log.relative_to(ROOT)))

    # ------------------------------------------------------------- 3 check
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    def timed(fn) -> float:
        """ms per call: warm up, then CUDA events around enough calls."""
        fn()
        torch.cuda.synchronize(dev)
        t = time.monotonic()
        fn()
        torch.cuda.synchronize(dev)
        iters = int(min(50, max(3, 0.1 / max(time.monotonic() - t, 1e-6))))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters

    def in_turns(plain, kernel) -> tuple[float, float]:
        p1, k1, k2, p2 = timed(plain), timed(kernel), timed(kernel), timed(plain)
        return (k1 + k2) / 2, (p1 + p2) / 2

    checks: dict[str, list[dict]] = {"gemm_tiled": [], "gemm_refined": [],
                                     "flash_attention": [], "flash_decode": []}

    def check(name, what, kernel, plain, library, err_bound, flops, nbytes, control=None):
        """``control``: a plain version with a deliberate fault, which
        must land outside ``err_bound`` of the kernel."""
        out, ref = kernel(), plain()
        torch.cuda.synchronize(dev)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"{name} {what}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite")
        err = (out - ref).abs().max().item()
        control_err = (out - control()).abs().max().item() if control else None
        ms, plain_ms = in_turns(plain, kernel)
        lib_ms = timed(library) if library is not None else None
        b_ms, b_by = bound(flops, nbytes)
        row = dict(what=what, max_abs_err=err, err_bound=err_bound, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if control:
            row["control_err"] = control_err
        emit(phase="check", kernel=name, **row)
        if not err <= err_bound:
            fail(f"{name} {what}: max |kernel - plain| {err} > {err_bound}")
        if control and not control_err > err_bound:
            fail(f"{name} {what}: the faulty control is within the bound ({control_err})")
        checks[name].append(row)

    cfg = get_config("gemma3-1b")
    d, ff, vocab, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.head_dim
    heads, kvh, grp = cfg.num_heads, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads

    # gemm_tiled at the prefill MLP: (700 x 1152) bf16 activations x (1152 x 6912) f32
    m = 700
    x = randn((m, d), dtype=torch.bfloat16)
    w = randn((d, ff), d ** -0.5)
    w16 = w.to(torch.bfloat16)
    check("gemm_tiled", f"prefill mlp {m}x{d}x{ff}", lambda: gt.gemm_tiled(x, w),
          lambda: gt.gemm_tiled_plain(x, w), lambda: torch.matmul(x, w16), GEMM_BOUND,
          2 * m * d * ff, x.numel() * 2 + w.numel() * 4 + m * ff * 4)
    del w, w16

    # gemm_tiled at the decode linears (M = 4 slots): the MLP's up and down
    # projections, bf16 activations x f32 weights
    x4 = randn((4, d), dtype=torch.bfloat16)
    h4 = randn((4, ff), dtype=torch.bfloat16)
    for a4, kk, nn in ((x4, d, ff), (h4, ff, d)):
        w = randn((kk, nn), kk ** -0.5)
        w16 = w.to(torch.bfloat16)
        check("gemm_tiled", f"decode mlp 4x{kk}x{nn}",
              lambda a4=a4, w=w: gt.gemm_tiled(a4, w),
              lambda a4=a4, w=w: gt.gemm_tiled_plain(a4, w),
              lambda a4=a4, w16=w16: torch.matmul(a4, w16), GEMM_BOUND,
              2 * 4 * kk * nn, a4.numel() * 2 + w.numel() * 4 + 4 * nn * 4)
    del w, w16

    # the decode unembed: (4 x 1152) bf16 against the (262144 x 1152) f32 table, NT
    xb = randn((4, d), dtype=torch.bfloat16)
    table = randn((vocab, d), d ** -0.5)
    table16 = table.to(torch.bfloat16)
    unembed_bytes = xb.numel() * 2 + table.numel() * 4 + 4 * vocab * 4
    check("gemm_tiled", f"decode unembed 4x{d}x{vocab} NT", lambda: gt.gemm_tiled(xb, table.t()),
          lambda: gt.gemm_tiled_plain(xb, table.t()), lambda: torch.matmul(xb, table16.t()),
          GEMM_BOUND, 2 * 4 * d * vocab, unembed_bytes)
    # library: one f32 SGEMM (TF32 is off), the function refine_ab approximates
    check("gemm_refined", f"decode unembed refine_ab 4x{d}x{vocab} NT",
          lambda: gr.gemm_refined(xb, table.t(), policy="refine_ab"),
          lambda: gr.gemm_refined_plain(xb, table.t(), "refine_ab"),
          lambda: torch.matmul(xb.float(), table.t()), GEMM_BOUND,
          num_passes("refine_ab") * 2 * 4 * d * vocab, unembed_bytes)
    del table, table16

    # flash forward: prefill of 700 tokens, 4 heads on 1 kv head, hd 256, bf16
    s = 700
    q = randn((1, s, kvh, grp, hd), hd ** -0.5, torch.bfloat16)
    k, v = randn((1, s, kvh, hd), dtype=torch.bfloat16), randn((1, s, kvh, hd), dtype=torch.bfloat16)
    qh = q.reshape(1, s, heads, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2).expand(1, heads, s, hd), v.transpose(1, 2).expand(1, heads, s, hd)
    for window in (None, cfg.window):
        rows = torch.arange(s, device=dev)
        keep = rows[None, :] <= rows[:, None]
        if window is not None:
            keep &= rows[None, :] > rows[:, None] - window
        pairs = int(keep.sum())
        sdpa = lambda keep=keep: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=keep, scale=1.0)
        check("flash_attention", f"prefill S={s} H={heads} Kv={kvh} hd={hd} "
              + ("causal" if window is None else f"window {window}"),
              lambda w=window: af.flash_attention(q, k, v, causal=True, window=w),
              lambda w=window: af.flash_attention_plain(q, k, v, causal=True, window=w),
              sdpa, ATTN_BOUND, 4 * pairs * hd * heads,
              (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4,
              control=None if window is None else (
                  lambda w=window: af.flash_attention_plain(q, k, v, causal=True,
                                                            window=w - 1)))

    # flash decode: 4 rows, a 512-slot ring (local layers) and a 1024-row
    # linear cache (global layers), positions below and above the window
    pos = torch.tensor([40, 300, 611, 1000], dtype=torch.int32, device=dev)
    qd = randn((4, 1, kvh, grp, hd), hd ** -0.5, torch.bfloat16)
    for s_cache, window in ((cfg.window, cfg.window), (1024, None)):
        kc = randn((4, s_cache, kvh, hd), dtype=torch.bfloat16)
        vc = randn((4, s_cache, kvh, hd), dtype=torch.bfloat16)
        col = torch.arange(s_cache, device=dev)[None, :]
        p64 = pos.long()[:, None]
        live = (p64 - torch.remainder(p64 - col, s_cache) >= 0) if window else (col <= p64)
        n_live = int(live.sum())
        dmask = live[:, None, None, :].expand(4, heads, 1, s_cache)
        sdpa_d = lambda kc=kc, vc=vc, dmask=dmask: (  # noqa: E731
            torch.nn.functional.scaled_dot_product_attention(
                qd.reshape(4, 1, heads, hd).transpose(1, 2),
                kc.transpose(1, 2).expand(4, heads, s_cache, hd),
                vc.transpose(1, 2).expand(4, heads, s_cache, hd),
                attn_mask=dmask, scale=1.0))
        check("flash_decode", f"decode B=4 {'ring' if window else 'linear'} {s_cache}",
              lambda kc=kc, vc=vc, w=window: af.flash_decode(qd, kc, vc, pos, window=w),
              lambda kc=kc, vc=vc, w=window: af.flash_decode_plain(qd, kc, vc, pos, window=w),
              sdpa_d, ATTN_BOUND, 4 * n_live * grp * hd * kvh,
              qd.numel() * 2 + 2 * n_live * kvh * hd * 2 + qd.numel() * 4)
    del q, k, v, qh, kh, vh, kc, vc
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 4 serve
    policy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={"attention": ("decode",)})
    t0 = time.monotonic()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.monotonic() - t0
    eng = ServeEngine(cfg, batch_size=4, max_ctx=1024, policy=policy, device=dev)
    eng.load(params)
    eng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 701, size=8)
    lens[:2] = rng.integers(513, 701, size=2)     # two prompts past the 512 window
    reqs = [Request(rid=i, prompt=rng.integers(2, vocab, int(n)).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(lens)]
    gt.LAUNCHES = 0
    gr.LAUNCHES = 0
    for key in af.LAUNCHES:
        af.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    stats = eng.run(reqs)
    launches = {"gemm_tiled": gt.LAUNCHES, "gemm_refined": gr.LAUNCHES,
                "flash_attention": af.LAUNCHES["flash_attention"],
                "flash_decode": af.LAUNCHES["flash_decode"]}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(r.done and len(r.out_tokens) == 32 for r in reqs):
        fail(f"not every request finished with 32 tokens: "
             f"{[(r.rid, r.done, len(r.out_tokens)) for r in reqs]}")
    if any(not 0 <= t < vocab for r in reqs for t in r.out_tokens):
        fail("a token outside the vocabulary")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the serve path never launched: {launches}")

    # one prompt's prefill logits: kernel routes vs torch reference routes
    prompt = {"tokens": torch.as_tensor(reqs[0].prompt, device=dev)[None].long()}
    ref_policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab")
    with torch.no_grad():
        lk, _ = serve_step.make_prefill(cfg, policy, s_ctx=1024)(params, prompt)
        lr, _ = serve_step.make_prefill(cfg, ref_policy, s_ctx=1024)(params, prompt)
    torch.cuda.synchronize(dev)
    if lk.shape != (1, 1, vocab) or not torch.isfinite(lk).all():
        fail(f"prefill logits shape {tuple(lk.shape)} or non-finite")
    logit_err = (lk - lr).abs().max().item()
    # faulty controls on the torch routes, which the bound must see: a
    # rung fault (fp8 MLPs) and a mask fault (a window one key short)
    with torch.no_grad():
        l_fp8, _ = serve_step.make_prefill(
            cfg, ops.ExecutionPolicy(default="bf16", mlp="fp8", logits="refine_ab"),
            s_ctx=1024)(params, prompt)
        l_win, _ = serve_step.make_prefill(
            dataclasses.replace(cfg, window=cfg.window - 1), ref_policy,
            s_ctx=1024)(params, prompt)
    fp8_err = (l_fp8 - lr).abs().max().item()
    window_err = (l_win - lr).abs().max().item()
    top2 = lr.flatten().topk(2).values
    emit(phase="serve", arch=cfg.name, params=n_params, weights_gb=n_params * 4 / 1e9,
         init_s=init_s, requests=stats["requests"], prompt_lens=[int(n) for n in lens],
         tokens=stats["tokens"], ticks=stats["ticks"], wall_s=stats["wall_s"],
         tok_per_s=stats["tok_per_s"], ttft_mean_s=stats["ttft_mean_s"],
         latency_mean_s=stats["latency_mean_s"], peak_mem_gb=peak_gb,
         launches=launches, prefill_logits_max_abs_err=logit_err,
         prefill_logits_bound=LOGITS_BOUND,
         prefill_argmax_agrees=bool(lk.argmax() == lr.argmax()),
         reference_top2_gap=(top2[0] - top2[1]).item(),
         control_fp8_mlp_err=fp8_err, control_window_short_err=window_err,
         logits_absmax=lr.abs().max().item())
    if not logit_err <= LOGITS_BOUND:
        fail(f"prefill logits: kernel routes vs torch routes {logit_err} > {LOGITS_BOUND}")
    if lk.argmax() != lr.argmax():
        fail("prefill logits: the kernel routes pick another greedy token than the torch routes")
    for control, err in (("fp8-MLP", fp8_err), ("short-window", window_err)):
        if not err > LOGITS_BOUND:
            fail(f"prefill logits: the {control} control ({err}) is within {LOGITS_BOUND}")

    # ----------------------------------------------------------- 5 profile
    # Where a 700-token prefill and a 4-slot decode tick spend their time:
    # the host clock of the window against the CUDA kernels' own time
    # (torch.profiler, summed by name; one stream, so they do not overlap).
    from torch.profiler import ProfilerActivity, profile

    def profile_window(fn) -> dict:
        torch.cuda.synchronize(dev)
        t = time.monotonic()
        fn()
        torch.cuda.synchronize(dev)
        plain_wall = time.monotonic() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        per_kernel: dict[str, float] = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
        device_ms = sum(per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        return {"wall_ms": plain_wall * 1e3, "device_ms": device_ms,
                "idle_share": 1.0 - device_ms / (plain_wall * 1e3),
                "top_kernels_ms": [[name[:90], ms] for name, ms in top]}

    long_prompt = {"tokens": torch.as_tensor(reqs[1].prompt, device=dev)[None].long()}
    with torch.no_grad():
        prefill_prof = profile_window(lambda: eng._prefill(params, long_prompt))
    for i in range(4):
        eng.submit(Request(rid=100 + i, prompt=reqs[i].prompt, max_new_tokens=16))
    eng.step()                                   # admit (prefill) all four
    tick_prof = profile_window(eng.tick)
    eng.run([])
    emit(phase="profile", prefill_tokens=int(long_prompt["tokens"].shape[1]),
         prefill=prefill_prof, decode_tick=tick_prof)

    # ----------------------------------------------------------- 6 kernels
    meta = {
        "gemm_tiled": ("gemm_tiled.cu", "src/repro/kernels/gemm_tiled.py:31"),
        "gemm_refined": ("gemm_refined.cu", "src/repro/kernels/gemm_refined.py:50"),
        "flash_attention": ("attention_fused.cu", "src/repro/kernels/attention_fused.py:167"),
        "flash_decode": ("attention_fused.cu", "src/repro/kernels/attention_fused.py:485"),
    }
    rows = []
    for name, (src, replaces) in meta.items():
        first = checks[name][-1] if name == "flash_attention" else checks[name][0]
        rows.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(c["max_abs_err"] for c in checks[name]),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"], "shape": first["what"],
                     "checks": checks[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
