"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ``ctypes``.  The
libraries land in ``build/repro_torch/`` at the checkout's root, named by
a hash of their sources and flags, so an edit rebuilds and an unchanged
tree reuses them.  ``build_all`` starts one ``nvcc`` per source, all at
once.  Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "check", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gemm_tiled", "gemm_refined", "attention_fused", "attention_bwd", "attention_paged",
           "gemm_lowp", "gemm_grouped", "gemm_grouped_ext", "gemm_grouped_dw", "gemm_naive",
           "batched_gemm", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per source: attention_bwd's 26 kernels (the WMMA rungs and the wgmma bf16
# ones) and gemm_refined's 34 (20 wgmma, one per term set and layout, and
# 14 split-K) compile on all cores, so they do not outlast the other sources
EXTRA_FLAGS = {"attention_bwd": ("--split-compile=0",), "gemm_refined": ("--split-compile=0",)}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels build only where the CUDA toolkit is")
    return found


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, all in
    parallel.  Returns {name: {"seconds", "cached", "log"}}; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out: dict[str, dict] = {}
    t0 = time.monotonic()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    logs = {name: [] for name in procs}
    readers = [threading.Thread(target=lambda n=n, p=p: logs[n].append(p.stdout.read()))
               for n, (p, _, _) in procs.items()]
    for r in readers:
        r.start()
    pending = dict(procs)
    while pending:            # each source's own seconds, as it finishes
        for name, (proc, tmp, path) in list(pending.items()):
            if proc.poll() is None:
                continue
            del pending[name]
            seconds = time.monotonic() - t0
            readers[list(procs).index(name)].join()
            log = "".join(logs[name])
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
                continue
            os.replace(tmp, path)
            out[name] = {"seconds": seconds, "cached": False, "log": log}
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
