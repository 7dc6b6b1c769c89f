#!/usr/bin/env python3
"""Time the packed batched GEMM (``batched_gemm``) and WKV6 (``wkv6``) on one
NVIDIA GPU, for an A/B of two checkouts of the port on one card:

    python3 tools/time_batched_wkv.py [--src PATH/src] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so one copy of this script times a parent's tree
too.  Rows beside ``chip_smoke.py``'s check rows:
  - packed at ``chip_smoke.py``'s shapes (n = 16 at G = 256 and 16384;
    n = 8, 32, 64 at G = 4096) on bf16 operands, and n = 64 and 16 on f32
    operands (rounded to bf16 in the kernel); each beside the naive kernel
    (unchanged, a control of the card's state), the plain version,
    ``torch.bmm`` with an f32 output (the same function) and with a bf16
    output, and its bytes bound at 3.35 TB/s;
  - wkv6 on ``tests/test_kernels.py``'s input recipe at rwkv6-7b's
    layer-0 shape (B = 1, 704 steps, H = 64, K = 64, chunk 64), at the
    recipe shape (B = 4, S = 1024) and at chunk 128, beside the plain
    version, with its errors against the plain version and the sequential
    recurrence, and its bytes bound (r, k, v, logw, u, out, state) beside
    the time the design's chunk states take at that rate (written and read
    once).
Each row is timed three times as ``chip_smoke.py`` times its check rows
(CUDA events around back-to-back calls queued behind a device spin);
``--profile`` adds each wkv6 row's device time by kernel name over 10
calls (``torch.profiler``), so a multi-launch design shows its phases.
Builds only the two sources.  Prints the card's name and power limit,
then one JSON line a row.  Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--profile", action="store_true",
                    help="also give each wkv6 row's device time by kernel (torch.profiler)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_batched_wkv: no GPU", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import wkv6 as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.monotonic()
    _build.build_all(("batched_gemm", "wkv6"))
    print(json.dumps({"tag": args.tag, "build_s": time.monotonic() - t0}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize(dev)
        t = time.monotonic()
        fn()
        host_s = time.monotonic() - t
        torch.cuda.synchronize(dev)
        iters = int(min(50, max(3, 0.1 / max(time.monotonic() - t, 1e-6))))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(0.05, 1.5 * iters * host_s + 1e-3) * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters

    def emit(**row):
        print(json.dumps({"tag": args.tag, **row}), flush=True)

    def by_kernel(fn, n=10) -> dict:
        """Device ms a call by kernel name (10 calls under torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize(dev)
        out: dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                out[e.key[:60]] = out.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / n
        return out

    for n, g, dtype in ((16, 256, torch.bfloat16), (16, 16384, torch.bfloat16),
                        (8, 4096, torch.bfloat16), (32, 4096, torch.bfloat16),
                        (64, 4096, torch.bfloat16), (64, 4096, torch.float32),
                        (16, 16384, torch.float32)):
        a, b = randn((g, n, n), dtype=dtype), randn((g, n, n), dtype=dtype)
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        out = bg.batched_gemm(a, b)
        plain = bg.batched_gemm_plain(a, b)
        torch.cuda.synchronize(dev)
        try:
            lib_f32 = [timed(lambda: torch.bmm(a16, b16, out_dtype=torch.float32))]
        except (RuntimeError, TypeError) as e:
            lib_f32 = f"none: {e}"[:200]
        esize = 2 if dtype == torch.bfloat16 else 4
        emit(kernel="batched_gemm", what=f"G={g} n={n} {str(dtype)[6:]}",
             ms=[timed(lambda: bg.batched_gemm(a, b)) for _ in range(3)],
             naive_ms=[timed(lambda: bg.batched_gemm_naive(a, b)) for _ in range(3)],
             plain_ms=timed(lambda: bg.batched_gemm_plain(a, b)),
             bmm_f32_out_ms=lib_f32,
             bmm_bf16_out_ms=timed(lambda: torch.bmm(a16, b16)),
             bound_ms=g * n * n * (2 * esize + 4) / PEAK_BYTES * 1e3,
             max_abs_err=(out - plain).abs().max().item())
        del a, b, a16, b16, out, plain

    def recipe(b, s, h, kd):
        r, k, v = (randn((b, s, h, kd), 0.5) for _ in range(3))
        return r, k, v, -torch.exp(randn((b, s, h, kd), 0.5) - 0.7), randn((h, kd), 0.1)

    for b, s, h, kd, chunk, what in ((1, 704, 64, 64, 64, "rwkv6-7b layer-0 shape"),
                                     (4, 1024, 64, 64, 64, "recipe"),
                                     (4, 1024, 64, 64, 128, "recipe, chunk 128")):
        xs = recipe(b, s, h, kd)
        out, st = wk.wkv6(*xs, chunk=chunk)
        po, ps = wk.wkv6_plain(*xs, chunk=chunk)
        ro, rs = kref.wkv6_ref(*xs)
        torch.cuda.synchronize(dev)
        nbytes = 4 * (5 * b * s * h * kd + h * kd + b * h * kd * kd)
        emit(kernel="wkv6", what=f"{what}: B={b} S={s} H={h} K={kd} chunk {chunk}",
             ms=[timed(lambda: wk.wkv6(*xs, chunk=chunk)) for _ in range(3)],
             plain_ms=timed(lambda: wk.wkv6_plain(*xs, chunk=chunk)),
             bound_ms=nbytes / PEAK_BYTES * 1e3,
             chunk_state_ms=2 * 4 * b * h * (s // chunk) * kd * kd / PEAK_BYTES * 1e3,
             max_abs_err=max((out - po).abs().max().item(), (st - ps).abs().max().item()),
             sequential_ref_err=max((out - ro).abs().max().item(),
                                    (st - rs).abs().max().item()),
             **({"device_ms_by_kernel": by_kernel(lambda: wk.wkv6(*xs, chunk=chunk))}
                if args.profile else {}))
        del xs, out, st, po, ps, ro, rs


if __name__ == "__main__":
    main()
