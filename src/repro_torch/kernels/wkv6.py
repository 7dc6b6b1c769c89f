"""Chunked RWKV-6 WKV forward (``csrc/wkv6.cu``): a chunk-parallel scan,
its products on the tensor cores at 3xTF32.

Replaces the TPU kernel ``repro/kernels/wkv6.py:_wkv6_kernel``
(``pallas_call`` at ``wkv6.py:109``): out_t = r_t . (S + u (.) k_t v_t^T),
S <- diag(e^{logw_t}) S + k_t v_t^T, per (batch, head), computed a chunk
of C steps at a time.  As in the JAX package the model does not call it
(``models/rwkv.py`` runs ``_wkv_chunked`` on the routed GEMMs); it is an
entry point of its own, held against the exact recurrence
(``kernels/ref.py:wkv6_ref``).

The TPU kernel walks a (B*H, S/C) grid with the chunk axis sequential and
the (K, K) state in VMEM scratch.  On Hopper that order leaves the card
idle (64 streams at rwkv6-7b's B = 1 on 132 SMs), so the work runs in two
launches in stream order (``wkv6_scan_plain`` is their arithmetic in torch
ops): a CTA per (b, h) walks the chunks doing only the state's work, each
chunk's decay and increment straight into the state it carries, and
writes every chunk's incoming state (phases A and B of the model, fused);
then a CTA per chunk, every chunk at once, computes the chunk's output
from its incoming state (phase C).  The exponential leaves the O(C^2 K)
score sum: 16-step sub-blocks factor each off-diagonal score into r e^{.}
and k e^{.} with every exponent <= 0 (``scan_exponents``), so those
scores are products; only the diagonal 16 x 16 blocks keep the
exp-in-the-sum form, in f32 on the CUDA cores.  Every product runs on
``mma.sync`` TF32 at three passes (x = big + small, small.big + big.small
+ big.big, smallest first): one TF32 pass lands ~50x outside the 1e-4
bound against the recurrence, three hold it.  The kernels keep the
cumulative decay in log2 units (one ex2 a factor); the model uses e^x.

What bounds it on the H100: bytes (r, k, v, logw read once, out written
once; the design adds B*H*(S/C)*K^2*4 bytes of chunk states written and
read once, and reads k, v and logw in both launches).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _trace
from repro_torch.kernels.gemm_tiled import SMEM_LIMIT, on_cpu

__all__ = ["wkv6", "wkv6_plain", "wkv6_scan_plain", "wkv6_smem_bytes", "scan_exponents",
           "tf32_round", "LAUNCHES", "HEAD_DIMS", "SUB"]

LAUNCHES = 0
HEAD_DIMS = (16, 32, 64)         # the K the kernel is instantiated for

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


@_trace.plain_twin
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
        inter = torch.matmul((rc * torch.exp(lae)).float(), state.float())
        r_ed = rc[:, :, :, None, :] * torch.exp(torch.clamp(
            lae[:, :, :, None, :] - la[:, :, None, :, :], max=0.0))  # (B, H, C, C, K)
        scores = torch.einsum("bhtsk,bhsk->bhts", r_ed.float(), kc.float())
        scores = torch.where(mask, scores, torch.zeros((), device=r.device))
        intra = torch.matmul(scores.float(), vc.float())
        bonus = (rc * uu * kc).sum(-1, keepdim=True)
        outs.append(inter + intra + bonus * vc)
        dec_end = torch.exp(la[:, :, -1:, :] - la)
        state = state * torch.exp(la[:, :, -1, :])[..., None] + torch.matmul(
            (kc * dec_end).transpose(-1, -2).float(), vc.float())
    out = torch.cat(outs, dim=2) if outs else torch.zeros_like(rr)
    return out.permute(0, 2, 1, 3).contiguous(), state


SUB = 16                         # steps of a sub-block: the factorization's unit


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 (10 explicit significand bits), nearest
    even, on the bit pattern: what the kernel's operand split computes."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """a @ b on TF32 operands as the kernel's tensor cores take them:
    (small, main) with main = big.big and, at 3 passes, small = small.big +
    big.small (x = big + small, big = TF32(x), small = TF32(x - big));
    at 1 pass small is 0 (the one-pass rung)."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    main = a_big.float() @ b_big.float()
    if passes == 1:
        return torch.zeros_like(main), main
    small = (tf32_round(a - a_big).float() @ b_big.float()
             + a_big.float() @ tf32_round(b - b_big).float())
    return small, main


def _blocks(x: torch.Tensor, chunk: int, cp: int) -> torch.Tensor:
    """(B, S, H, K) -> (B, H, S / chunk, CP, K) f32, each chunk padded to
    CP steps with zeros (identity steps: logw = 0, r = k = v = 0)."""
    b, s, h, kd = x.shape
    x = x.float().reshape(b, s // chunk, chunk, h, kd).permute(0, 3, 1, 2, 4)
    return torch.nn.functional.pad(x, (0, 0, 0, cp - chunk))


def _cumulative(ww: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive and exclusive cumulative log decay of each chunk (the
    exclusive one is the inclusive one a step later, 0 at the start)."""
    la = torch.cumsum(ww, dim=-2)
    return la, torch.nn.functional.pad(la[..., :-1, :], (0, 0, 1, 0))


def _sub_block_exponents(la: torch.Tensor, lae: torch.Tensor, t0: int, chunk: int) -> dict:
    """Every exponent sub-block T (steps t0..t0+15) of a chunk uses, before
    the clamp at 0, each <= 0 wherever the cumulative sums are monotone:
      to_start   lae[t] - lae[t0]             (r~ = r e^., the rows' own factor)
      start      lae[t0]                      (e^. scales r~ to the chunk start: inter)
      between    lae[t0] - la[e'] for each earlier sub-block T' ending at e'
      to_end     la[e'] - la[s], s in T'      (k^ = k e^., T''s own factor)
      diag       lae[t] - la[s], t0 <= s < t  (the 16 x 16 diagonal block, f32)"""
    rows = slice(t0, t0 + SUB)
    bnd = lae[..., t0, :]
    ends = [la[..., e - 1:e, :] for e in range(SUB, t0 + 1, SUB)]
    strict = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool, device=la.device), -1)
    diag = lae[..., rows, None, :] - la[..., None, rows, :]
    return {"to_start": lae[..., rows, :] - bnd[..., None, :], "start": bnd,
            "between": [bnd - e[..., 0, :] for e in ends],
            "to_end": [e - la[..., e_i * SUB:(e_i + 1) * SUB, :] for e_i, e in enumerate(ends)],
            "diag": torch.where(strict[..., None], diag, torch.zeros((), device=la.device))}


def scan_exponents(logw: torch.Tensor, chunk: int) -> list[torch.Tensor]:
    """Every exponent ``wkv6_scan_plain`` (and the kernel) passes to exp,
    before the clamp at 0: the chunk decay la[C-1], the decay to the
    chunk's end la[C-1] - la, and each sub-block's (``_sub_block_exponents``)."""
    cp = -(-chunk // SUB) * SUB
    la, lae = _cumulative(_blocks(logw, chunk, cp))
    out = [la[..., chunk - 1, :], la[..., chunk - 1:chunk, :] - la]
    for t0 in range(0, cp, SUB):
        ex = _sub_block_exponents(la, lae, t0, chunk)
        out += [ex["to_start"], ex["start"], ex["diag"], *ex["between"], *ex["to_end"]]
    return out


def wkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    u: torch.Tensor, *, chunk: int = 64,
                    passes: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' arithmetic in torch ops, every (b, h, chunk) at once
    (``passes=1``: every product on one TF32 pass, the rung that cannot
    hold 1e-4):
      A  per chunk: the decay d = e^{la[C-1]} and the increment
         U = (k e^{la[C-1] - la})^T v;
      B  the scan S_{c+1} = diag(d_c) S_c + U_c, every chunk's incoming
         state and the final one (the state kernel does A and B in one
         walk, adding U_c's products straight into the scaled state);
      C  per 16-step sub-block T at t0: out = (r~ e^{lae[t0]}) S_c
         + sum over earlier T' of ((r~ e^{lae[t0] - la[e']}) k^_T'^T) v_T'
         + (diagonal scores, the bonus on their diagonal) v_T, with
         r~ = r e^{lae - lae[t0]} and k^ = k e^{la[e'] - la}: every
         exponent <= 0 (``scan_exponents``), every product on TF32 at
         ``passes`` (``_mm_tf32``), the diagonal scores and the bonus in
         f32.  Returns (out (B, S, H, K) f32, state (B, H, K, K) f32)."""
    b, s, h, kd = _check(r, k, v, logw, u, chunk)
    nc, cp = s // chunk, -(-chunk // SUB) * SUB
    rr, kk, vv, ww = (_blocks(x, chunk, cp) for x in (r, k, v, logw))
    uu = u.float()[None, :, None, None, :]                     # (1, H, 1, 1, K)
    la, lae = _cumulative(ww)

    def ex(x):
        return torch.exp(torch.clamp(x, max=0.0))

    # A: each chunk's decay and its own increment
    la_end = la[..., chunk - 1, :]                             # (B, H, NC, K)
    inc = sum(_mm_tf32((kk * ex(la[..., chunk - 1:chunk, :] - la)).transpose(-1, -2), vv,
                       passes))
    # B: the scan over chunks, in order
    state = torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = ex(la_end[:, :, c])[..., None] * state + inc[:, :, c]
    if not nc:
        return torch.zeros((b, s, h, kd), dtype=torch.float32, device=r.device), state
    s_in = torch.stack(s_in, dim=2)                            # (B, H, NC, K, K)
    # C: the outputs, a sub-block at a time
    strict = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool, device=r.device), -1)
    outs = []
    for t0 in range(0, cp, SUB):
        e = _sub_block_exponents(la, lae, t0, chunk)
        rows = slice(t0, t0 + SUB)
        r_sub = rr[..., rows, :] * ex(e["to_start"])
        small, main = _mm_tf32(r_sub * ex(e["start"])[..., None, :], s_in, passes)
        blocks = [sum(_mm_tf32(r_sub * ex(btw)[..., None, :],
                               (kk[..., i * SUB:(i + 1) * SUB, :] * ex(end)).transpose(-1, -2),
                               passes))
                  for i, (btw, end) in enumerate(zip(e["between"], e["to_end"]))]
        diag = torch.einsum("bhctk,bhctsk,bhcsk->bhcts", rr[..., rows, :].float(),
                            ex(e["diag"]).float(), kk[..., rows, :].float())
        diag = torch.where(strict, diag, torch.zeros((), device=r.device))
        diag = diag + torch.diag_embed((rr[..., rows, :] * uu * kk[..., rows, :]).sum(-1))
        i_small, i_main = _mm_tf32(torch.cat(blocks + [diag], dim=-1), vv[..., :t0 + SUB, :],
                                   passes)
        outs.append((small + i_small) + (main + i_main))
    out = torch.cat(outs, dim=3)[..., :chunk, :]               # (B, H, NC, C, K)
    return out.permute(0, 2, 3, 1, 4).reshape(b, s, h, kd), state


def wkv6_smem_bytes(head_dim: int, chunk: int) -> int:
    """Shared memory of one CTA of the output kernel (phase C; the state
    kernel keeps one buffer of its ring where two do not fit, so this one
    sets the largest chunk): the chunk's r, cumulative log decay, k and k^ (rows of
    K + 4 floats) and v (K + 8) over CP = chunk rounded up to 16 steps, the
    incoming state (K rows of K + 8), u, the scan's 128 segment sums, and
    for each of 4 warps its decay row (K) and its 16 x 16 score block (rows
    of 20)."""
    cp = -(-chunk // SUB) * SUB
    return 4 * (cp * (4 * (head_dim + 4) + head_dim + 8) + head_dim * (head_dim + 8) + head_dim
                + 4 * (head_dim + SUB * 20) + 128)


@functools.cache
def _launcher():
    fn = _build.load("wkv6").wkv6_launch
    fn.argtypes = [_c.c_void_p] * 8 + [_c.c_int] * 5 + [_c.c_longlong, _c.c_void_p, _c.c_int]
    fn.restype = _c.c_int
    return fn


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous f32 tensor whose data is 16-byte aligned (the
    kernels copy rows by 16-byte async copies)."""
    x = x.float().contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused WKV6 forward.  r/k/v/logw: (B, S, H, K); u: (H, K).  S must be
    a multiple of ``chunk`` (pad upstream with logw = 0, k = v = 0
    identity steps).  Returns (out (B, S, H, K) f32, final state
    (B, H, K, K) f32).  CPU tensors run ``wkv6_plain``; CUDA tensors
    launch the two kernels (one call of ``LAUNCHES``) or raise."""
    global LAUNCHES
    b, s, h, kd = _check(r, k, v, logw, u, chunk)
    if _trace.ACTIVE:
        # four products a step (r.state, r.k scores, scores.v, the state
        # update), each three TF32 passes; the chunk states in f32
        return _trace.launch(_trace.KernelSite(
            kernel="wkv6", entry="wkv6_launch", mainloop=None, policy="tf32x3", terms=3,
            contractions=4, outputs=(((b, s, h, kd), torch.float32),
                                     ((b, h, kd, kd), torch.float32)),
            workspace_dtype=torch.float32, grid=(b * h,),
            blocks=(_trace.Block("chunks", (s,), (chunk,), divisible=True),)),
            r, k, v, logw, u)
    if on_cpu(r, k, v, logw, u):
        return wkv6_plain(r, k, v, logw, u, chunk=chunk)
    if kd not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes K in {HEAD_DIMS}; got K={kd}")
    smem = wkv6_smem_bytes(kd, chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk={chunk} at K={kd} needs {smem} bytes of shared memory "
                         f"(> {SMEM_LIMIT})")
    rr, kk, vv, ww, uu = (_aligned(x) for x in (r, k, v, logw, u))
    out = torch.empty((b, s, h, kd), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    if b * h:
        nc = s // chunk
        ws = torch.empty((b, h, nc, kd, kd), dtype=torch.float32, device=r.device)
        dev = r.device.index if r.device.index is not None else torch.cuda.current_device()
        _build.check(_launcher()(rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
                                 uu.data_ptr(), out.data_ptr(), state.data_ptr(), ws.data_ptr(),
                                 b, s, h, kd, chunk, smem,
                                 torch.cuda.current_stream(r.device).cuda_stream, dev),
                     "wkv6_launch")
        LAUNCHES += 1
    return out, state
