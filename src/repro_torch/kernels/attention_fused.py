"""Flash attention on the Hopper tensor cores: prefill forward,
single-token decode (``csrc/attention_fused.cu``) and the training
backward (``csrc/attention_bwd.cu``).

Replaces the TPU kernels ``repro/kernels/attention_fused.py:_fwd_kernel``
(``pallas_call`` at ``:224``, via ``_fwd_impl``), ``:_decode_kernel``
(``pallas_call`` at ``:579``), ``:_bwd_dq_kernel`` (``pallas_call`` at
``:354``) and ``:_bwd_dkv_kernel`` (``pallas_call`` at ``:374``, both via
``_bwd_impl``).  The forward and decode walk the KV sequence in tiles of
``BKV`` = 32 rows with the online softmax (running max m, running sum l,
unnormalised output), so the (Sq, Skv) score tensor never reaches device
memory; the forward also writes ``lse = m + log l`` per row.  Every
contraction runs the precision ladder on the tensor cores (bf16 /
refine_a / bf16x3 / refine_ab from staged bf16 hi/lo tiles; bf16x6 and
the fp8 / int8 / fp8x3 / int8x3 rungs from f32 tiles, their bf16 terms
made per fragment; f32 on the CUDA cores).  The quantized rungs take
``repro``'s pow2 quantize-dequantize with one scale per staged tile, as
the TPU kernel takes one per block: the forward's 64 x hd Q block (decode:
the G heads of a kv head), each 32 x hd K and V tile, each 64 x 32 (decode
G x 32) probability tile; the backward's 32-row Q, dO, K and V tiles and
32 x 32 P and dS tiles.  The plain twins take the same tiles.  Masks: causal,
sliding window and tail padding for the forward and backward; the
ring-buffer slot rule ``pos - ((pos - c) mod S) >= 0`` (a floor mod) or
the linear ``c <= pos`` for decode, at a per-row ``pos``.  GQA: query
head h reads kv head ``h // G``; decode gives one block per (row, kv
head) covering the group's G query heads so K/V are read once per group.
Softcap ``cap * tanh(s / cap)`` before masking.

What bounds them on the H100: their roofline bound is bytes for decode
and, at gemma3-1b's training shapes, operations for the forward and
backward (a few GFLOP against a few MB), but at head_dim 256 the design
is bounded by shared memory: a 64 x 256 f32 tile is 64 KB, so the TPU's
128 x 128 blocks do not fit.  The forward at the bf16 rung runs a Hopper
kernel (``csrc/flash_sm90.cuh``): a producer warpgroup stages Q once and
64-row K/V tiles through a 2-stage ring (TMA for bf16 inputs, converting
loads for f32), and one consumer warpgroup computes S = QK^T by
``wgmma`` into registers, runs the online softmax there in the twin's
32-column steps, and multiplies P (bf16, from registers) by V with O kept
in registers for the whole walk.  The other rungs' forward stages Q, K
and V as bf16 hi/lo pairs (or f32) with a 64-row q block and 32-row KV
tiles, and keeps O in shared memory as an f32 accumulator reloaded into
WMMA fragments (217 KB, one block per SM).  Both walk only the KV tiles a
q block's mask reaches (the TPU kernel's ``_block_live`` as loop bounds);
``LAUNCHES_BY_LOOP`` counts which of the two each forward launch ran.
Decode reads the cache once per tick, so bytes bound it; the kernel
reads it in place in its stored type and stops its walk at ``pos`` (a
ring's slots past ``pos`` are masked until it wraps).  Its grid of one
block per (row, kv head) is 4 CTAs for gemma3 at B = 4, so at the bf16
rung the walk is split over CTAs (``decode_splits``: twice the SM count
where the cache allows); each split writes its unnormalised O, m and l to
a workspace and the last block of a (row, kv head), by an atomic ticket,
combines them in split order in the same launch
(``flash_decode_split_plain`` is that arithmetic in plain PyTorch).

The backward rebuilds ``p = exp(s' - lse)`` (``s'`` the softcapped score)
instead of storing it, with ``di = rowsum(dO * O)`` computed outside the
kernels as one tensor op, as the TPU code does.  At the bf16 rung its two
kernels run on Hopper's ``wgmma`` (``csrc/flash_bwd_sm90.cuh``): the
wrapper rounds q, k, v and dO to bf16 once, and a CTA of two consumer
warpgroups owns 64 rows (dq: query rows of one head; dk/dv: KV rows of
one kv head), loads them once by TMA and walks 64-row tiles of the other
side through a 2-stage ring, with S, dP, P, dS and the accumulators in
registers.  The dk/dv kernel walks the group's query heads inside the
CTA, unless that grid would leave SMs empty: then each query head has its
own CTA and writes its partial dk/dv, which the wrapper sums over the
group (the TPU code's own per-query-head gradients).
``LAUNCHES_BY_LOOP_DQ`` / ``_DKV`` count which kernel ran.  The other
rungs take 32-row q and KV tiles, so that at head_dim 256 four staged
operand tiles and two f32 accumulators fit in 221 KB: ``dq`` owns 32
query rows and walks the live KV tiles accumulating ``dS.K``; ``dk/dv``
owns 32 KV rows and walks, for each of the group's G query heads in
turn, the live q tiles accumulating ``P^T.dO`` and ``dS^T.Q``, reading
the transposed tiles in place as col-major fragments.  Every output tile
has one owner, so there are no atomics and the result is deterministic.

Each wrapper has a plain PyTorch twin (``*_plain``) that walks the WMMA
kernels' 32-row tiles in the same order, so kernel and plain version
round to bf16 at the same points; the wgmma kernels' 64-row tiles change
only the order of the f32 sums (the forward keeps the twin's 32-column
softmax steps).  ``flash_attention`` is differentiable: its
``autograd.Function`` saves (q, k, v, out, lse) and runs the backward
kernels (twin of ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import precision as prec
from repro_torch.kernels import _build, _trace
from repro_torch.kernels.gemm_tiled import (MAINLOOPS, SPLIT_ARGTYPES, TICKETS_PER_SM,
                                            WS_SLOTS_PER_SM, on_cpu, split_ranges,
                                            split_site_fields, split_workspace, whole_splits)
from repro_torch.kernels.gemm_tiled import sm_count as _sm_count

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "bwd_delta", "flash_decode", "flash_decode_plain", "flash_decode_split_plain",
           "decode_splits", "FUSED_POLICIES", "BKV", "LAUNCHES", "LAUNCHES_BY_LOOP",
           "LAUNCHES_BY_LOOP_DQ", "LAUNCHES_BY_LOOP_DKV", "SPLIT_LAUNCHES"]

BKV = 32
BQ = 64        # the forward kernel's q block (its Q and P scale tiles)
BT = 32        # the backward kernels' q and kv tiles
NEG_INF = -1e30
POLICY_CODES = {"bf16": 0, "refine_a": 1, "bf16x3": 2, "refine_ab": 3, "f32": 4,
                "bf16x6": 5, "fp8": 6, "int8": 7, "fp8x3": 8, "int8x3": 9}
FUSED_POLICIES = tuple(POLICY_CODES)

# Launch counts of the kernels, keyed by kernel, and of the forward's two
# kernels (``wmma``: flash_common.cuh, every rung; ``sm90``: the bf16 rung
# on wgmma); the same for the backward's dq and dk/dv (``wmma``:
# attention_bwd.cu, every rung but bf16; ``sm90``: flash_bwd_sm90.cuh).
LAUNCHES = {"flash_attention": 0, "flash_decode": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
LAUNCHES_BY_LOOP = dict.fromkeys(MAINLOOPS, 0)
LAUNCHES_BY_LOOP_DQ = dict.fromkeys(MAINLOOPS, 0)
LAUNCHES_BY_LOOP_DKV = dict.fromkeys(MAINLOOPS, 0)
SM90_ROWS = 64   # rows of the wgmma backward's tiles (its dk/dv grid rule)
# decode launches whose KV walk ran split over CTAs (``decode_splits`` > 1)
SPLIT_LAUNCHES = {"flash_decode": 0}
DECODE_MAX_SPLITS = 64   # csrc/flash_common.cuh's bound


# ------------------------------------------------------------ plain twins

def _policy_dot(spec: str, x: torch.Tensor, y: torch.Tensor, policy: str,
                x_tile=None, y_tile=None) -> torch.Tensor:
    """einsum under the ladder: the policy's bf16 terms upcast and
    multiplied in f32, summed smallest first; f32 is one exact pass.  The
    quantized rungs scale each operand per tile (``prec.tile_terms``;
    None: the whole tensor)."""
    if policy == "f32":
        return torch.einsum(spec, x.float(), y.float())
    if policy in ("fp8", "int8", "fp8x3", "int8x3"):
        x_terms = prec.tile_terms(x, policy, x_tile or (0,) * x.dim())
        y_terms = prec.tile_terms(y, policy, y_tile or (0,) * y.dim())
    else:
        x_terms, y_terms = prec.operand_terms(x, y, policy)
    out = None
    for tx, ty in prec.policy_terms(policy):
        part = torch.einsum(spec, x_terms[tx].float(), y_terms[ty].float())
        out = part if out is None else out + part
    return out


def _pad_kv(x: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[1]) % BKV
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


# Scale tiles of the quantized rungs (``prec.tile_terms``), per operand layout.
_KV_TILE = (1, 0, 1, 0)                     # (B, 32, Kv, hd): one K or V tile
_FWD_TILES = ((1, BQ, 1, 1, 0), (1, 1, 1, BQ, 0))    # q; p (B, Kv, G, Sq, 32)
_DECODE_TILES = ((1, 0, 1, 0, 0), (1, 1, 0, 0, 0))   # the G heads of a kv head


def _walk(q, k, v, keep_fn, softcap, precision, tiles, t_lo=0, t_hi=None):
    """The kernels' online softmax over KV tiles [t_lo, t_hi) (default all)
    from a fresh state: q (B,Sq,Kv,G,hd), k/v (B,Skv,Kv,hd) padded to BKV
    rows; keep_fn(cols) -> bool mask broadcastable to (B,Kv,G,Sq,BKV);
    ``tiles``: the scale tiles of q and p.  Returns the unnormalised
    (acc (B,Kv,G,Sq,hd), m (B,Kv,G,Sq), l (B,Kv,G,Sq)), f32."""
    q_tile, p_tile = tiles
    b, sq, kvh, g, hd = q.shape
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    t_hi = k.shape[1] // BKV if t_hi is None else t_hi
    for k0 in range(t_lo * BKV, t_hi * BKV, BKV):
        s = _policy_dot("bqkgd,bskd->bkgqs", q, k[:, k0:k0 + BKV], precision, q_tile, _KV_TILE)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        cols = k0 + torch.arange(BKV, device=q.device)
        s = torch.where(keep_fn(cols), s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = _policy_dot("bkgqs,bskd->bkgqd", p, v[:, k0:k0 + BKV], precision, p_tile,
                         _KV_TILE)
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc, m, l


def _online_softmax(q, k, v, keep_fn, softcap, precision, tiles=_FWD_TILES):
    """The kernels' KV walk (``_walk``), normalised.  Returns (out
    (B,Sq,Kv,G,hd) f32, lse (B,Kv*G,Sq) f32)."""
    b, sq, kvh, g, _ = q.shape
    acc, m, l = _walk(q, k, v, keep_fn, softcap, precision, tiles)
    l = torch.clamp(l, min=1e-30)
    out = acc / l[..., None]
    lse = (m + torch.log(l)).reshape(b, kvh * g, sq)
    return out.permute(0, 3, 1, 2, 4), lse


def _keep(rows, cols, sq, skv, causal, window):
    """The forward and backward keep-mask for global row / col indices."""
    keep = (cols < skv) & (rows < sq)
    if causal:
        keep = keep & (cols <= rows)
        if window is not None:
            keep = keep & (cols > rows - window)
    return keep


@_trace.plain_twin
def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          precision: str = "bf16"):
    """Plain PyTorch twin of the forward kernel (same tiles, same masks).
    Returns (out (B,Sq,Kv,G,hd) f32, lse (B,Kv*G,Sq) f32)."""
    sq, skv = q.shape[1], k.shape[1]
    if not causal:
        window = None
    rows = torch.arange(sq, device=q.device)[:, None]
    return _online_softmax(
        q, _pad_kv(k), _pad_kv(v),
        lambda cols: _keep(rows, cols[None, :], sq, skv, causal, window),
        softcap, precision)


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in the kernels' (B, Kv*G, Sq) layout."""
    b, sq, kvh, g, _ = out.shape
    di = (out.float() * do.float()).sum(dim=-1)
    return di.reshape(b, sq, kvh * g).transpose(1, 2).contiguous()


def _probs(s, lse, dp, di, keep, softcap):
    """Rebuild p from the scores and lse under the mask, and form
    ds = p (dp - di), through the softcap's chain term."""
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    p = torch.where(keep, torch.exp(s - lse), torch.zeros_like(s))
    ds = p * (dp - di)
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


def _bwd_setup(q, lse, di, causal, window):
    b, sq, kvh, g, _ = q.shape
    return (None if not causal else window,
            lse.float().reshape(b, kvh, g, sq), di.float().reshape(b, kvh, g, sq),
            torch.arange(sq, device=q.device))


@_trace.plain_twin
def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, *, causal: bool = True,
                                 window: int | None = None,
                                 softcap: float | None = None,
                                 precision: str = "bf16") -> torch.Tensor:
    """Plain twin of the dq kernel: walks the 32-row KV tiles in order,
    accumulating dS.K.  ``di`` is ``rowsum(dO * O)`` in lse's (B, Kv*G,
    Sq) layout.  Returns dq (B, Sq, Kv, G, hd) f32."""
    sq, skv = q.shape[1], k.shape[1]
    window, lse4, di4, rows = _bwd_setup(q, lse, di, causal, window)
    do = do.float()
    kp, vp = _pad_kv(k), _pad_kv(v)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    q_tile, ds_tile = (1, BT, 1, 1, 0), (1, 1, 1, BT, 0)
    for k0 in range(0, kp.shape[1], BKV):
        kt, vt = kp[:, k0:k0 + BKV], vp[:, k0:k0 + BKV]
        cols = k0 + torch.arange(BKV, device=q.device)
        keep = _keep(rows[:, None], cols[None, :], sq, skv, causal, window)
        s = _policy_dot("bqkgd,bskd->bkgqs", q, kt, precision, q_tile, _KV_TILE)
        dp = _policy_dot("bqkgd,bskd->bkgqs", do, vt, precision, q_tile, _KV_TILE)
        _, ds = _probs(s, lse4[..., None], dp, di4[..., None], keep, softcap)
        dq = dq + _policy_dot("bkgqs,bskd->bqkgd", ds, kt, precision, ds_tile, _KV_TILE)
    return dq


@_trace.plain_twin
def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, *, causal: bool = True,
                                  window: int | None = None,
                                  softcap: float | None = None,
                                  precision: str = "bf16"):
    """Plain twin of the dk/dv kernel: for each of the group's heads in
    turn, walks the 32-row q tiles in order, accumulating P^T.dO and
    dS^T.Q.  Returns (dk, dv) (B, Skv, Kv, hd) f32."""
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    window, lse4, di4, _ = _bwd_setup(q, lse, di, causal, window)
    pad = (0, 0, 0, 0, 0, 0, 0, (-sq) % BKV)
    qp = torch.nn.functional.pad(q, pad)
    dop = torch.nn.functional.pad(do.float(), pad)
    lsep = torch.nn.functional.pad(lse4, (0, (-sq) % BKV))
    dip = torch.nn.functional.pad(di4, (0, (-sq) % BKV))
    cols = torch.arange(skv, device=q.device)
    dk = torch.zeros((b, skv, kvh, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kv_tile, p_tile = (1, BT, 1, 0), (1, 1, 0, BT)
    for gi in range(g):
        for q0 in range(0, qp.shape[1], BKV):
            qt, dot = qp[:, q0:q0 + BKV, :, gi], dop[:, q0:q0 + BKV, :, gi]
            rows = q0 + torch.arange(BKV, device=q.device)
            keep = _keep(rows[:, None], cols[None, :], sq, skv, causal, window)
            s = _policy_dot("bqkd,bskd->bkqs", qt, k, precision, _KV_TILE, kv_tile)
            dp = _policy_dot("bqkd,bskd->bkqs", dot, v, precision, _KV_TILE, kv_tile)
            p, ds = _probs(s, lsep[:, :, gi, q0:q0 + BKV, None], dp,
                           dip[:, :, gi, q0:q0 + BKV, None], keep, softcap)
            dv = dv + _policy_dot("bkqs,bqkd->bskd", p, dot, precision, p_tile, _KV_TILE)
            dk = dk + _policy_dot("bkqs,bqkd->bskd", ds, qt, precision, p_tile, _KV_TILE)
    return dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              window: int | None = None,
                              softcap: float | None = None,
                              precision: str = "bf16"):
    """Plain PyTorch twin of the backward: di, then the dq and dk/dv
    walks.  Returns (dq, dk, dv) f32 in q's / k's / v's shapes."""
    kw = dict(causal=causal, window=window, softcap=softcap, precision=precision)
    di = bwd_delta(out, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw))


def _decode_keep(pos, s_cache, window):
    """Decode's keep-mask: keep_fn(cols) for positions ``pos`` (B,)."""
    pos = pos.to(dtype=torch.int64)[:, None]     # (B, 1)

    def keep_fn(cols):
        c = cols[None, :]
        if window is not None:
            keep = (pos - torch.remainder(pos - c, s_cache) >= 0) & (c < s_cache)
        else:
            keep = (c <= pos) & (c < s_cache)
        return keep[:, None, None, None, :]                      # (B,1,1,1,BKV)
    return keep_fn


@_trace.plain_twin
def flash_decode_plain(q, k_cache, v_cache, pos, *, window: int | None = None,
                       softcap: float | None = None,
                       precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch twin of the decode kernel."""
    keep_fn = _decode_keep(pos.to(q.device), k_cache.shape[1], window)
    return _online_softmax(q, _pad_kv(k_cache), _pad_kv(v_cache), keep_fn,
                           softcap, precision, _DECODE_TILES)[0]


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, kvh: int, s_cache: int, sms: int, precision: str = "bf16") -> int:
    """KV splits of a decode launch, dense or paged alike: 1 at every rung
    but bf16 (the carried rungs take P's scales per tile from the running
    max) and when the (row, kv head) blocks alone give twice ``sms`` CTAs;
    else the fewest splits of whole BKV-row tiles of the ``s_cache``-row
    cache that reach twice ``sms`` CTAs (one tile each where the cache is
    too short), none empty, at most DECODE_MAX_SPLITS and within the split
    workspace."""
    tiles = -(-s_cache // BKV)
    groups = b * kvh
    want = -(-2 * sms // max(groups, 1))
    if precision != "bf16" or want <= 1 or groups > TICKETS_PER_SM * sms:
        return 1
    most = min(tiles, DECODE_MAX_SPLITS, WS_SLOTS_PER_SM * sms // groups)
    return whole_splits(tiles, want, most)


def flash_decode_split_plain(q, k_cache, v_cache, pos, splits: int, *,
                             window: int | None = None, softcap: float | None = None,
                             precision: str = "bf16") -> torch.Tensor:
    """The split decode kernel's arithmetic in plain PyTorch: each row's
    live KV tiles (up to ``pos``) cut into ``splits`` ranges
    (``split_ranges``; a range may be empty), the online softmax run over
    each from a fresh state, and the unnormalised partials combined in
    split order with weights exp(m_s - max m)."""
    s_cache = k_cache.shape[1]
    kp, vp = _pad_kv(k_cache), _pad_kv(v_cache)
    pos = pos.to(q.device)
    keep_fn = _decode_keep(pos, s_cache, window)
    outs = []
    for i in range(q.shape[0]):
        live = -(-min(s_cache, int(pos[i]) + 1) // BKV)
        row_keep = lambda cols, i=i: keep_fn(cols)[i:i + 1]  # noqa: E731
        parts = [_walk(q[i:i + 1], kp[i:i + 1], vp[i:i + 1], row_keep, softcap, precision,
                       _DECODE_TILES, lo, hi) for lo, hi in split_ranges(live, splits)]
        top = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        acc, l = 0.0, 0.0
        for acc_s, m_s, l_s in parts:
            w = torch.exp(m_s - top)
            l = l + l_s * w
            acc = acc + acc_s * w[..., None]
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs).permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------- kernels

def _inputs(*xs: torch.Tensor) -> tuple[list[torch.Tensor], int]:
    """All f32 or all bf16, contiguous; returns (tensors, in_bf16)."""
    bf16 = all(x.dtype == torch.bfloat16 for x in xs)
    dtype = torch.bfloat16 if bf16 else torch.float32
    return [x.to(dtype).contiguous() for x in xs], int(bf16)


def _check_policy(precision: str) -> None:
    if precision not in POLICY_CODES:
        raise ValueError(f"fused attention runs {FUSED_POLICIES}; got {precision!r}")


def _check_head_dim(hd: int) -> None:
    if hd % 16 or hd > 256:
        raise ValueError(f"head_dim {hd} unsupported: the kernels take multiples "
                         f"of 16 up to 256")


@functools.cache
def _launchers():
    """(forward, decode) C launchers of the built library, typed once."""
    lib = _build.load("attention_fused")
    c = ctypes
    fwd, dec = lib.attention_fwd_launch, lib.attention_decode_launch
    fwd.argtypes = [c.c_void_p] * 5 + [c.c_int] * 9 + [c.c_float, c.c_int, c.POINTER(c.c_int),
                                                        c.c_void_p, c.c_int]
    dec.argtypes = [c.c_void_p] * 5 + [c.c_int] * 7 + [c.c_float, c.c_int, *SPLIT_ARGTYPES,
                                                        c.c_void_p, c.c_int]
    fwd.restype = dec.restype = c.c_int
    return fwd, dec


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _window_arg(causal: bool, window: int | None) -> int:
    return int(window) if (causal and window is not None) else 0


def _softcap_arg(softcap: float | None) -> float:
    return float(softcap) if softcap is not None else 0.0


def _site(kernel: str, entry: str, precision: str, contractions: int, outputs,
          **fields) -> _trace.KernelSite:
    """An attention launch: ``contractions`` tensor-core products a pass
    (forward and decode 2: S = QK^T and PV; dq 3; dk/dv 4), the bf16 rung
    on the wgmma kernels where the launcher has them."""
    return _trace.KernelSite(
        kernel=kernel, entry=entry, policy=precision, terms=prec.num_passes(precision),
        contractions=contractions, outputs=tuple((tuple(shape), torch.float32)
                                                 for shape in outputs), **fields)


def decode_site(kernel: str, entry: str, q, s_cache: int, precision: str) -> _trace.KernelSite:
    """A dense or paged decode launch: its KV walk split over
    ``decode_splits`` ranges of BKV-row tiles of the cache."""
    b, _, kvh, _, _ = q.shape
    splits = decode_splits(b, kvh, s_cache, _trace.AUDIT_SMS, precision)
    return _site(kernel, entry, precision, 2, (q.shape,), mainloop=None,
                 **split_site_fields(-(-s_cache // BKV), splits))


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        precision: str = "bf16"):
    """The forward kernel: q (B, Sq, Kv, G, hd) pre-scaled, k/v (B, Skv,
    Kv, hd).  Returns (out (B, Sq, Kv, G, hd) f32, lse (B, Kv*G, Sq) f32).
    CPU tensors run the plain twin; CUDA tensors launch the kernel (the
    Hopper one at the bf16 rung, the WMMA one at every other) or raise."""
    _check_policy(precision)
    if _trace.ACTIVE:
        b, sq, kvh, g, _ = q.shape
        return _trace.launch(_site("flash_attention", "attention_fwd_launch", precision, 2,
                                   (q.shape, (b, kvh * g, sq)),
                                   mainloop="sm90" if precision == "bf16" else "wmma"), q, k, v)
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, precision=precision)
    b, sq, kvh, g, hd = q.shape
    _check_head_dim(hd)
    (q, k, v), in_bf16 = _inputs(q, k, v)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, kvh * g, sq), dtype=torch.float32, device=q.device)
    loop = ctypes.c_int(-1)
    rc = _launchers()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), in_bf16, b, sq, k.shape[1], kvh, g, hd, int(causal),
            _window_arg(causal, window), _softcap_arg(softcap),
            POLICY_CODES[precision], ctypes.byref(loop),
            torch.cuda.current_stream(q.device).cuda_stream, _device_index(q))
    _build.check(rc, "attention_fwd_launch")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES_BY_LOOP[MAINLOOPS[loop.value]] += 1
    return out, lse


@functools.cache
def _bwd_launchers():
    """(dq, dk/dv) C launchers of the built backward library, typed once."""
    lib = _build.load("attention_bwd")
    c = ctypes
    dq, dkv = lib.attention_bwd_dq_launch, lib.attention_bwd_dkv_launch
    ints = [c.c_int] * 9 + [c.c_float, c.c_int]
    tail = [c.POINTER(c.c_int), c.c_void_p, c.c_int]
    dq.argtypes = [c.c_void_p] * 7 + ints + tail
    dkv.argtypes = [c.c_void_p] * 8 + ints + [c.c_longlong] + tail
    dq.restype = dkv.restype = c.c_int
    return dq, dkv


def _tma_operand(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous bf16 on a 16-byte aligned base, as the wgmma
    backward's tensor maps take it (``.to`` rounds to nearest even, as the
    WMMA kernels' staging and the twin's ``_policy_dot`` round)."""
    x = x.to(torch.bfloat16).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bwd_args(q, k, v, do, lse, di, causal, window, softcap, precision):
    """The launchers' shared arguments: (input pointers, keep-alive
    tensors, scalars before the loop pointer).  At the bf16 rung (the
    wgmma kernels) q, k, v and do go as bf16, rounded once here; the other
    rungs take q, k, v as they are and do as f32.  ``di`` is used as
    given."""
    b, sq, kvh, g, hd = q.shape
    _check_head_dim(hd)
    if precision == "bf16":
        q, k, v, do = (_tma_operand(x) for x in (q, k, v, do))
        in_bf16 = 1
    else:
        (q, k, v), in_bf16 = _inputs(q, k, v)
        do = do.float().contiguous()
    lse, di = (x.float().contiguous() for x in (lse, di))
    tensors = (q, k, v, do, lse, di)
    scalars = (in_bf16, b, sq, k.shape[1], kvh, g, hd, int(causal),
               _window_arg(causal, window), _softcap_arg(softcap), POLICY_CODES[precision])
    return [x.data_ptr() for x in tensors], tensors, scalars


def _stream_tail(x: torch.Tensor, loop: ctypes.c_int):
    return ctypes.byref(loop), torch.cuda.current_stream(x.device).cuda_stream, _device_index(x)


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool = True,
                           window: int | None = None,
                           softcap: float | None = None,
                           precision: str = "bf16") -> torch.Tensor:
    """The dq kernel: dq (B, Sq, Kv, G, hd) f32 from q, k, v, the output
    gradient ``do``, the forward's ``lse`` and ``di = rowsum(dO * O)``
    (both (B, Kv*G, Sq)).  CPU tensors run the plain twin; CUDA tensors
    launch the kernel (the Hopper one at the bf16 rung, the WMMA one at
    every other) or raise."""
    _check_policy(precision)
    kw = dict(causal=causal, window=window, softcap=softcap, precision=precision)
    if _trace.ACTIVE:
        return _trace.launch(_site("flash_attention_bwd_dq", "attention_bwd_dq_launch",
                                   precision, 3, (q.shape,),
                                   mainloop="sm90" if precision == "bf16" else "wmma"),
                             q, k, v, do, lse, di)
    if on_cpu(q, k, v, do, lse, di):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw)
    ptrs, _keep_alive, scalars = _bwd_args(q, k, v, do, lse, di, causal, window, softcap,
                                           precision)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    loop = ctypes.c_int(-1)
    _build.check(_bwd_launchers()[0](*ptrs, dq.data_ptr(), *scalars, *_stream_tail(q, loop)),
                 "attention_bwd_dq_launch")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    LAUNCHES_BY_LOOP_DQ[MAINLOOPS[loop.value]] += 1
    return dq


def _dkv_per_head(b: int, skv: int, kvh: int, g: int, device_index: int) -> bool:
    """The wgmma dk/dv kernel's grid rule: one CTA per query head, writing
    per-head partials that the wrapper sums over the group, when the
    group-in-CTA grid (64 KV rows of one kv head a CTA) would leave SMs
    empty."""
    return g > 1 and b * kvh * -(-skv // SM90_ROWS) < _sm_count(device_index)


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None,
                            precision: str = "bf16"):
    """The dk/dv kernel: (dk, dv) (B, Skv, Kv, hd) f32, arguments as
    ``flash_attention_bwd_dq``.  At the bf16 rung, when the grid of one
    CTA per kv head would not fill the card, the kernel writes each query
    head's dk and dv to a (G, B, Skv, Kv, hd) scratch and they are summed
    over the group here (one launch either way)."""
    _check_policy(precision)
    kw = dict(causal=causal, window=window, softcap=softcap, precision=precision)
    if _trace.ACTIVE:
        return _trace.launch(_site("flash_attention_bwd_dkv", "attention_bwd_dkv_launch",
                                   precision, 4, (k.shape, v.shape),
                                   mainloop="sm90" if precision == "bf16" else "wmma"),
                             q, k, v, do, lse, di)
    if on_cpu(q, k, v, do, lse, di):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
    ptrs, _keep_alive, scalars = _bwd_args(q, k, v, do, lse, di, causal, window, softcap,
                                           precision)
    b, sq, kvh, g, hd = q.shape
    per_head = precision == "bf16" and _dkv_per_head(b, k.shape[1], kvh, g, _device_index(q))
    out = torch.empty((2, g if per_head else 1, *k.shape), dtype=torch.float32, device=q.device)
    loop = ctypes.c_int(-1)
    _build.check(_bwd_launchers()[1](*ptrs, out[0].data_ptr(), out[1].data_ptr(), *scalars,
                                     k.numel() if per_head else 0, *_stream_tail(q, loop)),
                 "attention_bwd_dkv_launch")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    LAUNCHES_BY_LOOP_DKV[MAINLOOPS[loop.value]] += 1
    dk, dv = (out.sum(dim=1) if per_head else out[:, 0]).unbind(0)
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        precision: str = "bf16"):
    """Gradients of ``flash_attention`` with respect to q, k and v, from
    the forward's f32 ``out`` and ``lse`` and the output gradient ``do``:
    di = rowsum(dO * O) as one tensor op, then the dq and dk/dv kernels
    (their plain twins on CPU tensors).  Returns (dq, dk, dv) f32 in the
    shapes of q, k and v."""
    kw = dict(causal=causal, window=window, softcap=softcap, precision=precision)
    di = bwd_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw))


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the backward on the backward kernels (twin
    of ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, precision):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       softcap=softcap, precision=precision)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        precision=precision)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.float(), **ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    precision: str = "bf16") -> torch.Tensor:
    """Fused flash attention in the model's GQA layout, differentiable.

    q: (B, Sq, Kv, G, hd) pre-scaled; k/v: (B, Skv, Kv, hd).  Returns
    (B, Sq, Kv, G, hd) f32.  CPU tensors run the plain twins; CUDA
    tensors launch the kernels or raise.
    """
    _check_policy(precision)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, precision)


def flash_decode(q, k_cache, v_cache, pos, *, window: int | None = None,
                 softcap: float | None = None,
                 precision: str = "bf16") -> torch.Tensor:
    """Single-token fused decode against the post-write dense cache.

    q: (B, 1, Kv, G, hd) pre-scaled; caches (B, S, Kv, hd); pos (B,)
    per-row positions.  ``window`` selects the ring mask.  Returns
    (B, 1, Kv, G, hd) f32.
    """
    _check_policy(precision)
    if q.shape[1] != 1:
        raise ValueError("flash_decode is the single-token cell")
    if _trace.ACTIVE:
        return _trace.launch(decode_site("flash_decode", "attention_decode_launch", q,
                                         k_cache.shape[1], precision), q, k_cache, v_cache, pos)
    if on_cpu(q, k_cache, v_cache, pos):
        return flash_decode_plain(q, k_cache, v_cache, pos, window=window,
                                  softcap=softcap, precision=precision)
    b, _, kvh, g, hd = q.shape
    _check_head_dim(hd)
    if g > 16:
        raise ValueError(f"decode kernel covers up to 16 query heads per kv head; got {g}")
    (q, k_cache, v_cache), in_bf16 = _inputs(q, k_cache, v_cache)
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    index, stream = _device_index(q), torch.cuda.current_stream(q.device).cuda_stream
    splits = decode_splits(b, kvh, k_cache.shape[1], _sm_count(index), precision)
    rc = _launchers()[1](q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            pos.data_ptr(), in_bf16, b, k_cache.shape[1], kvh, g, hd,
            int(window is not None), float(softcap) if softcap is not None else 0.0,
            POLICY_CODES[precision], splits, *split_workspace(index, stream), stream, index)
    _build.check(rc, "attention_decode_launch")
    LAUNCHES["flash_decode"] += 1
    SPLIT_LAUNCHES["flash_decode"] += splits > 1
    return out
