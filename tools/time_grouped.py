#!/usr/bin/env python3
"""Time the grouped expert GEMM (``grouped_gemm``) at Mixtral 8x7B's widths
on one NVIDIA GPU, for an A/B of two checkouts of the port on one card:

    python3 tools/time_grouped.py [--src PATH/src] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so one copy of this script times a parent's tree
too.  Rows (8 experts, f32 stacks 4096 x 14336 and 14336 x 4096, bf16
activations): the decode (4 tokens x top-2, 144 rows at bm 16) at wi bf16,
wo bf16 and wi refine_ab on ``chip_smoke.py``'s decode counts, wi bf16
with the 8 rows on one expert and on all eight, and the prefill wi bf16
(T*k = 1400, bm 128).  A tree whose ``grouped_gemm`` takes
``group_counts`` is given the real counts, as the MoE FFN gives them.
Each row is timed three times as ``chip_smoke.py`` times its check rows
(CUDA events around back-to-back calls queued behind a device spin) and
held against the plain version.  Prints the card's name and power limit,
then one JSON line a row.  Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

E, D, FF = 8, 4096, 14336
DECODE_COUNTS = [2, 0, 3, 1, 0, 0, 2, 0]      # chip_smoke.py's decode draw (seed 14)
PREFILL_COUNTS = [320, 219, 139, 244, 69, 226, 130, 53]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_grouped: no GPU", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import gemm_grouped as gg

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1234)
    takes_counts = "group_counts" in inspect.signature(gg.grouped_gemm).parameters

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

    def layout(counts, bm, width):
        counts = np.asarray(counts)
        aligned = np.maximum(-(-counts // bm) * bm, bm)
        off = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
        n_buf = -(-int(counts.sum()) // bm) * bm + E * bm
        valid = torch.zeros(n_buf, dtype=torch.bool, device=dev)
        for g in range(E):
            valid[int(off[g]):int(off[g]) + int(counts[g])] = True
        x = torch.randn((n_buf, width), generator=gen, device=dev).to(torch.bfloat16)
        return (x * valid[:, None], torch.from_numpy(off).to(dev),
                torch.from_numpy(counts).to(dev, torch.int32))

    w_in = torch.randn((E, D, FF), generator=gen, device=dev) * D ** -0.5
    w_out = torch.randn((E, FF, D), generator=gen, device=dev) * FF ** -0.5
    rows = [("decode wi bf16", DECODE_COUNTS, 16, w_in, "bf16"),
            ("decode wo bf16", DECODE_COUNTS, 16, w_out, "bf16"),
            ("decode wi refine_ab", DECODE_COUNTS, 16, w_in, "refine_ab"),
            ("decode wi bf16 one expert", [8] + [0] * (E - 1), 16, w_in, "bf16"),
            ("decode wi bf16 eight experts", [1] * E, 16, w_in, "bf16"),
            ("prefill wi bf16 bm 128", PREFILL_COUNTS, 128, w_in, "bf16")]
    for what, counts, bm, w, rung in rows:
        x, off, cnt = layout(counts, bm, w.shape[1])
        kw = {"group_counts": cnt} if takes_counts else {}
        call = lambda x=x, w=w, off=off, bm=bm, r=rung, kw=kw: gg.grouped_gemm(  # noqa: E731
            x, w, off, bm=bm, policy=r, **kw)
        loops0 = dict(gg.LAUNCHES_BY_LOOP)
        out = call()
        loop = [k for k, n in gg.LAUNCHES_BY_LOOP.items() if n > loops0[k]]
        err = (out - gg.grouped_gemm_plain(x, w, off, bm=bm, policy=rung)).abs().max().item()
        ms = [timed(call) for _ in range(3)]
        print(json.dumps({"tag": args.tag, "row": what, "counts": counts, "bm": bm,
                          "group_counts_given": takes_counts, "mainloop": loop, "ms": ms,
                          "max_abs_err": err}), flush=True)
        del x, out


if __name__ == "__main__":
    main()
