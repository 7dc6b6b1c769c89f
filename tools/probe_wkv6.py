#!/usr/bin/env python3
"""Where the WKV6 kernels' time goes, on one NVIDIA GPU:

    python3 tools/probe_wkv6.py [--shape B,S,H,K,CHUNK]

No profiler here reads inside a kernel, so this builds variants of
``src/repro_torch/csrc/wkv6.cu`` under ``build/probe_wkv6/`` with one part
of the work cut out (``VARIANTS``: each a list of (source text, its
replacement); the script finds them by source text, so update them when
the kernel's code moves) and times each variant's kernels by name
(``torch.profiler``, device time a call over 20 calls) on the input recipe
of ``tests/test_kernels.py``.  A variant's outputs are wrong by design;
only its time is read.  The difference to ``full`` is what the part costs
with everything else in place.  Prints the card's name and power limit,
then one JSON line a variant.  Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "wkv6.cu"
OUT = ROOT / "build" / "probe_wkv6"

# (source text, replacement): each must occur in wkv6.cu
VARIANTS = {
    "full": [],
    "no_scan": [("    scan_decay<LR, K, STATE_THREADS>(sla, cp, seg);\n", "\n"),
                ("  scan_decay<LR, K, THREADS>(sla, cp, seg);\n", "\n")],
    "no_diag": [("      for (int i = q; i < K; i += 4) {", "      for (int i = q; i < 0; i += 4) {")],
    "no_earlier": [("    for (int T2 = 0; T2 < T; ++T2) {", "    for (int T2 = 0; T2 < 0; ++T2) {")],
    "no_inter": [("    for (int ks = 0; ks < K / 8; ++ks) {\n      const float d0 = sd[8 * ks + tig], "
                  "d4 = sd[8 * ks + tig + 4];\n      const FragA a = split_a(rt[ks][0] * d0, "
                  "rt[ks][1] * d0, rt[ks][2] * d4, rt[ks][3] * d4);\n      const float* s0",
                  "    for (int ks = 0; ks < 0; ++ks) {\n      const float d0 = sd[8 * ks + tig], "
                  "d4 = sd[8 * ks + tig + 4];\n      const FragA a = split_a(rt[ks][0] * d0, "
                  "rt[ks][1] * d0, rt[ks][2] * d4, rt[ks][3] * d4);\n      const float* s0")],
    "no_increment": [("      for (int s0 = 0; s0 < cp; s0 += 8) {",
                      "      for (int s0 = 0; s0 < 0; s0 += 8) {")],
    # the output kernel up to its sub-block loop (loads, scan, k^), and its loads alone
    "out_prep_only": [("  cp_wait<0>();\n  __syncthreads();\n\n  for (int T = warp;",
                       "  cp_wait<0>();\n  __syncthreads();\n  return;\n  for (int T = warp;")],
    "out_loads_only": [("  cp_wait<1>();\n  __syncthreads();\n  scan_decay<LR, K, THREADS>",
                        "  cp_wait<0>();\n  __syncthreads();\n  return;\n  scan_decay<LR, K, THREADS>")],
}


def build(name: str, edits) -> Path:
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"probe_wkv6: variant {name}: source text not found: {old[:60]!r}")
        text = text.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "wkv6.cu").write_text(text)
    lib = d / "libwkv6.so"
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(d / "wkv6.cu")]
    subprocess.run(cmd, check=True, capture_output=True)
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="4,1024,64,64,64")
    args = ap.parse_args()
    b, s, h, kd, chunk = (int(x) for x in args.shape.split(","))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_wkv6: no GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import wkv6 as wk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn((b, s, h, kd), 0.5) for _ in range(3))
    logw, u = -torch.exp(randn((b, s, h, kd), 0.5) - 0.7), randn((h, kd), 0.1)
    out = torch.empty_like(r)
    state = torch.empty((b, h, kd, kd), device=dev)
    ws = torch.empty((b, h, s // chunk, kd, kd), device=dev)
    smem = wk.wkv6_smem_bytes(kd, chunk)
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).wkv6_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                                     ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int

        def call():
            rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                    out.data_ptr(), state.data_ptr(), ws.data_ptr(), b, s, h, kd, chunk, smem,
                    torch.cuda.current_stream().cuda_stream, 0)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        ms = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                key = next((p for p in ("state", "out") if f"wkv6_{p}_kernel" in e.key),
                           e.key[:40])
                ms[key] = ms.get(key, 0.0) + e.self_device_time_total / 1e3 / 20
        print(json.dumps({"variant": name, "shape": [b, s, h, kd, chunk], "device_ms": ms,
                          "total_ms": sum(ms.values())}), flush=True)


if __name__ == "__main__":
    main()
