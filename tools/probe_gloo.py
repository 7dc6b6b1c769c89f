#!/usr/bin/env python3
"""Time gloo's collectives for ranks that share one NVIDIA GPU, the
transport of ``chip_smoke.py``'s mesh phase:

    python3 tools/probe_gloo.py [--ranks 4]

Starts ``--ranks`` processes on the card (``runtime.world.spawn`` with
``share_card``) and times, at 1, 16 and 256 MB of f32 a rank (three calls
each, after a barrier): gloo's all-reduce and all-gather on CUDA tensors
(gloo stages them through host memory itself), the same on a pageable
host copy, and both through pinned host buffers kept across calls.  Prints
the card's name and power limit, then one line a (mode, size): ms a call
and GB/s a rank.  Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MODES = ("cuda_allreduce", "cuda_allgather", "host_allreduce", "host_allgather",
         "host_pinned_allreduce", "host_pinned_allgather")


def bench(rank: int, world: int) -> dict:
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for mb in (1, 16, 256):
        t = torch.full((mb * 2 ** 20 // 4,), float(rank), device=dev)
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        gathered = torch.empty((world,) + tuple(t.shape), dtype=t.dtype, pin_memory=True)
        for mode in MODES:
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                if mode == "cuda_allreduce":
                    dist.all_reduce(t.clone())
                elif mode == "cuda_allgather":
                    dist.all_gather([torch.empty_like(t) for _ in range(world)], t)
                elif mode == "host_allreduce":
                    x = t.cpu()
                    dist.all_reduce(x)
                    x.to(dev)
                elif mode == "host_allgather":
                    x = t.cpu()
                    parts = [torch.empty_like(x) for _ in range(world)]
                    dist.all_gather(parts, x)
                    torch.cat(parts).to(dev)
                elif mode == "host_pinned_allreduce":
                    pinned.copy_(t)
                    dist.all_reduce(pinned)
                    t.copy_(pinned)
                else:
                    pinned.copy_(t)
                    dist.all_gather(list(gathered.unbind(0)), pinned)
                    gathered.to(dev)
            torch.cuda.synchronize(dev)
            out[(mode, mb)] = (time.perf_counter() - t0) / 3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_gloo: no GPU", file=sys.stderr)
        sys.exit(1)
    from repro_torch.runtime import world
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    res = world.spawn(bench, args.ranks, device="cuda", share_card=True, timeout=600)[0]
    for (mode, mb), s in sorted(res.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        print(f"{mode:24s} {mb:4d} MB  {s * 1e3:9.2f} ms  {mb / 1024 / s:.2f} GB/s", flush=True)


if __name__ == "__main__":
    main()
