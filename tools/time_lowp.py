#!/usr/bin/env python3
"""Time the quantized GEMM (``gemm_lowp``) at gemma3-1b's MLP shapes on one
NVIDIA GPU, for an A/B of two checkouts of the port on one card:

    python3 tools/time_lowp.py [--src PATH/src] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so one copy of this script times a parent's tree
too.  Rows: decode MLP up 4x1152x6912, decode MLP down 4x6912x1152 and
prefill MLP up 700x1152x6912, at fp8x3 and int8x3, bf16 activations x f32
weights, on repro's grid (TileConfig(256, 256, 256) clamped), each timed
as ``chip_smoke.py`` times its check rows (CUDA events around back-to-back
calls queued behind a device spin) and held against the plain version.
Prints the card's name and power limit, then one JSON line a row.  Exits 1
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_lowp: no GPU", file=sys.stderr)
        sys.exit(1)
    from repro_torch.core import ops
    from repro_torch.kernels import gemm_lowp as gl

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1234)

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

    for m, k, n in ((4, 1152, 6912), (4, 6912, 1152), (700, 1152, 6912)):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        t = ops.tile_for("cuda", m, n, k).clamp(m, n, k)
        for rung in ("fp8x3", "int8x3"):
            call = lambda x=x, w=w, t=t, r=rung: gl.gemm_lowp(x, w, policy=r, bm=t.bm,  # noqa: E731
                                                                bn=t.bn, bk=t.bk)
            err = (call() - gl.gemm_lowp_plain(x, w, rung, t.bm, t.bn, t.bk)).abs().max().item()
            ms = [timed(call) for _ in range(3)]
            print(json.dumps({"tag": args.tag, "shape": f"{m}x{k}x{n}", "rung": rung,
                              "grid": [t.bm, t.bn, t.bk], "ms": ms, "max_abs_err": err}),
                  flush=True)


if __name__ == "__main__":
    main()
