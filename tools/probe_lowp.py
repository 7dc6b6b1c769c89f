#!/usr/bin/env python3
"""Where the fused decode kernel of ``gemm_lowp`` (M <= 16) spends its time,
on one NVIDIA GPU:

    python3 tools/probe_lowp.py

Writes a copy of ``src/repro_torch/csrc/gemm_lowp.cu`` with probes (thread
0 of each CTA reads ``%globaltimer`` at the decode kernel's phase
boundaries and its SM id) under ``build/probe_lowp/``, builds it with the
port's nvcc flags, runs it in place of the port's library at gemma3-1b's
decode MLP shapes (4 x 1152 x 6912 and 4 x 6912 x 1152, fp8x3 and
int8x3, bf16 activations x f32 weights, grid 256 x 256 x 256), and prints
one JSON line a shape: each phase's mean and largest time over the CTAs,
the quantiles of the CTAs' start and end times (microseconds from the
first start) and the CTAs each SM ran.  The probes cost a global store a
phase, so the spans read a little above the unprobed kernel's.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_lowp"
PHASES = ("A staged", "B landed, amax", "cluster 1", "hi pass", "cluster 2", "lo pass",
          "term, cluster wait")
# (text in the source, the probe put before it); probe 5 follows srb
MARKS = (("  float* bs = reinterpret_cast<float*>(smem);\n  float* as =", 0),
         ("  // 3. B's tile scale over the cluster", 1),
         ("  const Scale sb =\n      tile_scale<FP8>(cluster_max(", 2),
         ("  // 4. the products: warp w", 3),
         ("  Scale srb{0.f, 0.f};\n  if constexpr (X3) {\n", 4),
         ("  cluster_arrive();  // done with the other CTAs' slots", 6),
         ("  cluster_wait();\n  if (width <= 0) return;", 7))
PROBE = '''__device__ unsigned long long g_probe[8192 * 10];
namespace {
__device__ __forceinline__ void probe(int p) {
  if (threadIdx.x != 0) return;
  const long long cta = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (cta >= 8192) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_probe[cta * 10 + p] = t;
  if (p == 0) {
    unsigned s;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
    g_probe[cta * 10 + 9] = s;
  }
}
}  // namespace
'''
READ = '''
extern "C" int lowp_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}
'''


def probed_source() -> str:
    src = (ROOT / "src/repro_torch/csrc/gemm_lowp.cu").read_text()
    src = src.replace('#include "gemm_common.cuh"\n', '#include "gemm_common.cuh"\n' + PROBE, 1)
    for text, p in MARKS:
        if src.count(text) != 1:
            raise SystemExit(f"probe_lowp: no unique place for probe {p}: {text!r}")
        src = src.replace(text, f"  probe({p});\n" + text)
    # the lo pass ends where the x3 block closes: probe 5 after srb is known
    src = src.replace("    srb = tile_scale<FP8>(cluster_max(block_amax(ra, red), &slot[1], "
                      "&outv[1], g.csize));\n",
                      "    srb = tile_scale<FP8>(cluster_max(block_amax(ra, red), &slot[1], "
                      "&outv[1], g.csize));\n    probe(5);\n", 1)
    return src + READ


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_lowp: no GPU", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm_lowp as gl

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gemm_lowp_probe.cu").write_text(probed_source())
    lib_path = OUT / "libgemm_lowp_probe.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib_path), str(OUT / "gemm_lowp_probe.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        sys.exit(1)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gemm_lowp_launch
    fn.argtypes, fn.restype = gl._launcher().argtypes, ctypes.c_int
    gl._launcher = lambda: fn
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = gl.sm_count(dev.index or 0)
    for m, k, n in ((4, 1152, 6912), (4, 6912, 1152)):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        for rung in ("fp8x3", "int8x3"):
            for _ in range(3):
                gl.gemm_lowp(x, w, policy=rung, bm=m)
            torch.cuda.synchronize()
            gl.gemm_lowp(x, w, policy=rung, bm=m)
            torch.cuda.synchronize()
            buf = np.zeros(8192 * 10, np.uint64)
            if lib.lowp_probe_read(buf.ctypes.data_as(ctypes.c_void_p)):
                raise SystemExit("probe_lowp: reading the probes failed")
            plan = gl.decode_plan(1, m, n, k, 256, 256, sms)
            p = buf.reshape(8192, 10)[:plan.grid[0] * plan.grid[1]].astype(np.int64)
            t = (p[:, :8] - p[:, 0].min()) / 1e3
            phases = {name: [round(float((t[:, i + 1] - t[:, i]).mean()), 2),
                             round(float((t[:, i + 1] - t[:, i]).max()), 2)]
                      for i, name in enumerate(PHASES)}
            q = (0, 0.25, 0.5, 0.75, 1)
            print(json.dumps({
                "shape": f"{m}x{k}x{n}", "rung": rung, "ctas": int(len(p)),
                "phase_us_mean_max": phases,
                "start_us_quantiles": [round(float(np.quantile(t[:, 0], v)), 2) for v in q],
                "end_us_quantiles": [round(float(np.quantile(t[:, 7], v)), 2) for v in q],
                "ctas_per_sm_min_max": [int(c) for c in (lambda b: (b.min(), b.max()))(
                    np.bincount(p[:, 9].astype(int), minlength=sms))]}), flush=True)


if __name__ == "__main__":
    main()
