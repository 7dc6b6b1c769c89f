"""Chunked RWKV-6 WKV forward (``csrc/wkv6.cu``), the state carried on chip.

Replaces the TPU kernel ``repro/kernels/wkv6.py:_wkv6_kernel``
(``pallas_call`` at ``wkv6.py:109``): out_t = r_t . (S + u (.) k_t v_t^T),
S <- diag(e^{logw_t}) S + k_t v_t^T, per (batch, head), computed a chunk
of C steps at a time.  As in the JAX package the model does not call it
(``models/rwkv.py`` runs ``_wkv_chunked`` on the routed GEMMs); it is an
entry point of its own, held against the exact recurrence
(``kernels/ref.py:wkv6_ref``).

The TPU kernel walks a (B*H, S/C) grid with the chunk axis sequential and
the (K, K) state in VMEM scratch.  On Hopper one block per (b, h) walks
its chunks in a loop with the state in shared memory; the (C, C, K)
decay tensor the TPU kernel materializes is never formed: each intra-chunk
score sums r k e^{min(lae_t - la_s, 0)} with the exponential computed on
the fly.  f32 on the CUDA cores, not bf16 tensor cores: the TPU kernel's
dots take f32 operands and the oracle bound is 1e-4.  CUDA C++ where
Triton would also serve (a chunked scan of elementwise work and small
reductions): the port's rule, and the kernel needs no tensor cores.

What bounds it on the H100: operations, on the CUDA cores (67 TFLOP/s
f32), for the whole card; per (b, h) stream it is latency, the chunks
being sequential.  At B = 1 and H = 64 (rwkv6-7b's prefill) it launches
64 blocks on 132 SMs, so half the card idles; a split of the stream over
more blocks is later work.  Bytes: r, k, v, logw read once, out written
once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm_tiled import on_cpu

__all__ = ["wkv6", "wkv6_plain", "wkv6_smem_bytes", "LAUNCHES", "HEAD_DIMS"]

LAUNCHES = 0
HEAD_DIMS = (16, 32, 64)         # the K the kernel is instantiated for
SMEM_LIMIT = 232448              # bytes of shared memory a block may use on the H100

_c = ctypes


def _check(r, k, v, logw, u, chunk) -> tuple[int, int, int, int]:
    if not (r.shape == k.shape == v.shape == logw.shape) or r.dim() != 4:
        raise ValueError(f"r/k/v/logw must share one (B, S, H, K) shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, s, h, kd = r.shape
    if tuple(u.shape) != (h, kd):
        raise ValueError(f"u must be (H, K) = {(h, kd)}; got {tuple(u.shape)}")
    if s % chunk:
        raise ValueError(f"S={s} not a multiple of chunk={chunk}")
    return b, s, h, kd


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's chunked form in torch ops, every (b, h) at once:
    per chunk the cumulative log decays, the carried state's read, the
    (C, C, K) decay tensor's scores (strictly lower), the bonus and the
    state update.  Returns (out (B, S, H, K) f32, state (B, H, K, K) f32)."""
    b, s, h, kd = _check(r, k, v, logw, u, chunk)

    def bh(x):  # (B, S, H, K) -> (B, H, S, K) f32
        return x.float().permute(0, 2, 1, 3)

    rr, kk, vv, ww = bh(r), bh(k), bh(v), bh(logw)
    uu = u.float()[None, :, None, :]                           # (1, H, 1, K)
    state = torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    outs = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, lw = (x[:, :, c0:c0 + chunk] for x in (rr, kk, vv, ww))
        la = torch.cumsum(lw, dim=2)
        lae = la - lw
        inter = torch.matmul(rc * torch.exp(lae), state)
        r_ed = rc[:, :, :, None, :] * torch.exp(torch.clamp(
            lae[:, :, :, None, :] - la[:, :, None, :, :], max=0.0))  # (B, H, C, C, K)
        scores = torch.einsum("bhtsk,bhsk->bhts", r_ed, kc)
        scores = torch.where(mask, scores, torch.zeros((), device=r.device))
        intra = torch.matmul(scores, vc)
        bonus = (rc * uu * kc).sum(-1, keepdim=True)
        outs.append(inter + intra + bonus * vc)
        dec_end = torch.exp(la[:, :, -1:, :] - la)
        state = state * torch.exp(la[:, :, -1, :])[..., None] + torch.matmul(
            (kc * dec_end).transpose(-1, -2), vc)
    out = torch.cat(outs, dim=2) if outs else torch.zeros_like(rr)
    return out.permute(0, 2, 1, 3).contiguous(), state


def wkv6_smem_bytes(head_dim: int, chunk: int) -> int:
    """Shared memory of one block: a chunk's r, k, v, la and lae (rows
    padded to K + 1), one row block of scores, the state and the bonus."""
    return 4 * (5 * chunk * (head_dim + 1) + min(chunk, 64) * chunk + head_dim * head_dim
                + chunk)


@functools.cache
def _launcher():
    fn = _build.load("wkv6").wkv6_launch
    fn.argtypes = [_c.c_void_p] * 7 + [_c.c_int] * 5 + [_c.c_longlong, _c.c_void_p, _c.c_int]
    fn.restype = _c.c_int
    return fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused WKV6 forward.  r/k/v/logw: (B, S, H, K); u: (H, K).  S must be
    a multiple of ``chunk`` (pad upstream with logw = 0, k = v = 0
    identity steps).  Returns (out (B, S, H, K) f32, final state
    (B, H, K, K) f32).  CPU tensors run ``wkv6_plain``; CUDA tensors
    launch the kernel or raise."""
    global LAUNCHES
    b, s, h, kd = _check(r, k, v, logw, u, chunk)
    if on_cpu(r, k, v, logw, u):
        return wkv6_plain(r, k, v, logw, u, chunk=chunk)
    if kd not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes K in {HEAD_DIMS}; got K={kd}")
    smem = wkv6_smem_bytes(kd, chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk={chunk} at K={kd} needs {smem} bytes of shared memory "
                         f"(> {SMEM_LIMIT})")
    rr, kk, vv, ww = (x.float().contiguous() for x in (r, k, v, logw))
    uu = u.float().contiguous()
    out = torch.empty((b, s, h, kd), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    if b * h:
        dev = r.device.index if r.device.index is not None else torch.cuda.current_device()
        _build.check(_launcher()(rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
                                 uu.data_ptr(), out.data_ptr(), state.data_ptr(), b, s, h, kd,
                                 chunk, smem, torch.cuda.current_stream(r.device).cuda_stream,
                                 dev), "wkv6_launch")
        LAUNCHES += 1
    return out, state
