#!/usr/bin/env python3
"""Measure where a tensor-core GEMM's f32 accumulation loses precision on
one NVIDIA GPU, and what the port's wgmma mainloops cost:

    python3 tools/probe_accumulation.py [--m 1024] [--k 1024,4096,8192,32768]
                                        [--src DIR] [--time]

Error rows (one JSON line a K).  Operands are exact in bf16 (U[-1, 1]
rounded once), so every product is exact in f32 and the only error left is
the accumulation's.  Each row is the max-norm error of C (M x M,
contraction K) against the f64 product of the same values: ``gemm_tiled``
(the port's bf16 wgmma mainloop), ``gemm_refined`` at refine_ab on f32
operands that are exactly bf16 hi + lo (four exact terms), cuBLAS's bf16
GEMM with an f32 output (tensor cores), cuBLAS's f32 SGEMM on the same
values with TF32 off (FMA on the CUDA cores), and ``gemm_tiled`` over K
chunks of 256, 1024 and 4096 summed in f32 on the CUDA cores.

``--time``: ms per call (CUDA events, queued behind a spin on the device)
of the Fig. 8 rows at 8192^3 on f32 operands (the bf16 rung, refine_ab,
bf16x6 on the ``cuda`` route), ``gemm_tiled`` at 4096^3 on bf16 operands
(TMA-fed), and the refined train unembed dX of gemma3-1b (2048 x 262144
against the 262144 x 1152 table).  ``--src`` imports the port from another
checkout's ``src`` (to compare two versions in one call).  Prints the
card's name and power limit first.  Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def timed(dev, fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize(dev)
    t = time.monotonic()
    fn()
    host_s = time.monotonic() - t
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.05, 1.5 * iters * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--k", default="1024,4096,8192,32768")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("probe_accumulation: no GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.ops import gemm
    from repro_torch.kernels import gemm_refined as gr
    from repro_torch.kernels import gemm_tiled as gt
    from repro_torch.runtime.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(dev.index)], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def uniform(shape):
        return 2 * torch.rand(shape, generator=gen, device=dev) - 1

    def hi_lo(shape):
        """f32 values that are exactly bf16 hi + bf16 lo (lo under half an
        ulp of hi), so split2 gives back hi and lo."""
        hi = uniform(shape).to(torch.bfloat16).float()
        return hi + (hi * 0.99 * uniform(shape) * 2.0 ** -9).to(torch.bfloat16).float()

    m = args.m
    for k in (int(x) for x in args.k.split(",")):
        a, b = uniform((m, k)).to(torch.bfloat16), uniform((k, m)).to(torch.bfloat16)
        exact = a.double() @ b.double()

        def err(c, ref):
            return (c.double() - ref).abs().max().item()

        row = {"src": args.src, "m": m, "k": k, "gemm_tiled": err(gt.gemm_tiled(a, b), exact),
               "cublas_bf16": err(torch.mm(a, b, out_dtype=torch.float32), exact),
               "sgemm": err(a.float() @ b.float(), exact)}
        for chunk in (256, 1024, 4096):
            if chunk < k:
                c = sum(gt.gemm_tiled(a[:, k0:k0 + chunk], b[k0:k0 + chunk])
                        for k0 in range(0, k, chunk))
                row[f"gemm_tiled_chunks_{chunk}"] = err(c, exact)
        row["abs_c_max"] = exact.abs().max().item()
        del a, b, exact
        af, bf = hi_lo((m, k)), hi_lo((k, m))
        exact = af.double() @ bf.double()
        row["gemm_refined_refine_ab"] = err(gr.gemm_refined(af, bf, policy="refine_ab"), exact)
        row["sgemm_hi_lo"] = err(af @ bf, exact)
        print(json.dumps(row), flush=True)
        del af, bf, exact
        torch.cuda.empty_cache()

    if not args.time:
        return
    a, b = uniform((8192, 8192)), uniform((8192, 8192))
    for rung in ("bf16", "refine_ab", "bf16x6"):
        ms = timed(dev, lambda: gemm(a, b, policy=rung, backend="cuda"))
        print(json.dumps({"src": args.src, "time": f"fig8_{rung}", "shape": [8192] * 3,
                          "ms": ms}), flush=True)
    a16, b16 = a[:4096, :4096].to(torch.bfloat16), b[:4096, :4096].to(torch.bfloat16)
    print(json.dumps({"src": args.src, "time": "gemm_tiled_bf16", "shape": [4096] * 3,
                      "ms": timed(dev, lambda: gt.gemm_tiled(a16, b16), 50)}), flush=True)
    del a, b, a16, b16
    g_log = uniform((2048, 262144)) * 262144 ** -0.5
    table = uniform((262144, 1152)) * 1152 ** -0.5
    print(json.dumps({"src": args.src, "time": "train_dx_refine_ab",
                      "shape": [2048, 1152, 262144],
                      "ms": timed(dev, lambda: gr.gemm_refined(g_log, table,
                                                               policy="refine_ab"))}),
          flush=True)


if __name__ == "__main__":
    main()
