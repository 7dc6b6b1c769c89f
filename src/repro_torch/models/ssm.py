"""Mamba-2 (SSD) mixer, the state-space half of the zamba2 hybrid (twin of
``repro.models.ssm``).

Chunked "state-space duality" evaluation: within a chunk the token-pair
interactions are a masked GEMM (the ``C.B^T`` scores go through the
precision policy's router, so they reach ``gemm_tiled`` on the kernel
route), across chunks an (H, P, N) state is carried in chunk order.  The
per-head decay is a scalar, so the pairwise decays are rank-1 within a
chunk; every relative decay exp(ll_t - ll_s) with s <= t has a
non-positive exponent.  The JAX package scans the chunks one at a time;
the port computes a bounded group of chunks' intra-chunk parts and state
increments at once, then carries the state through them in order.

Decode carries (conv, ssd) and is O(1) per token.  The dtype casts follow
the JAX code line for line (the projections' f32 outputs, the f32 conv,
scan and state, the activations in the config's dtype).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.ops import routed_einsum as peinsum
from repro_torch.models import layers as L

__all__ = ["init_mamba2", "mamba2_layer", "MambaState", "init_mamba_state"]

_NGROUPS = 1  # B/C projection groups; 1 at zamba2-7b's scale
# the most bytes of (B, C, C, H) f32 pair terms one group of chunks may take
# (a 256-step chunk at zamba2-7b's 112 heads takes 29 MB a row)
_GROUP_BYTES = 1 << 28


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, conv_width - 1, conv_dim) raw (pre-conv) inputs, f32
    ssd: torch.Tensor    # (B, H, P, N) state, f32


def _dims(d_model: int, head_dim: int, state: int) -> tuple[int, int, int]:
    d_inner = 2 * d_model
    nheads = d_inner // head_dim
    conv_dim = d_inner + 2 * _NGROUPS * state
    return d_inner, nheads, conv_dim


def init_mamba_state(batch: int, d_model: int, head_dim: int, state: int,
                     conv_width: int, *, device: torch.device | str = "cpu") -> MambaState:
    d_inner, nheads, conv_dim = _dims(d_model, head_dim, state)
    return MambaState(
        conv=torch.zeros((batch, conv_width - 1, conv_dim), dtype=torch.float32, device=device),
        ssd=torch.zeros((batch, nheads, head_dim, state), dtype=torch.float32, device=device))


def init_mamba2(gen: torch.Generator, d_model: int, head_dim: int, state: int,
                conv_width: int) -> dict:
    """Random params with the JAX package's shapes and scales."""
    d_inner, nheads, conv_dim = _dims(d_model, head_dim, state)
    dev = gen.device
    return {
        "in_proj": L.init_linear(gen, d_model, d_inner + conv_dim + nheads),
        "conv_w": 0.1 * torch.randn((conv_width, conv_dim), generator=gen, device=dev,
                                    dtype=torch.float32),
        "conv_b": torch.zeros(conv_dim, dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 8.0, nheads, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros(nheads, dtype=torch.float32, device=dev),
        "d_skip": torch.ones(nheads, dtype=torch.float32, device=dev),
        "norm_in": L.init_rmsnorm(d_model, dev),
        "norm": L.init_rmsnorm(d_inner, dev),
        "out_proj": L.init_linear(gen, d_inner, d_model, scale=d_inner ** -0.5),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal conv: xbc (B, S, C), w (W, C), b (C) -> silu(.) (B, S, C)."""
    width = w.shape[0]
    if prev is None:
        prev = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                           device=xbc.device)
    xp = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype))


def _ssd_chunked(x, bmat, cmat, rel, dt, chunk: int, policy):
    """Chunked SSD scan.

    x (B, S, H, P) f32, bmat / cmat (B, S, N) f32, rel (B, S, H) per-step
    log decay (< 0), dt (B, S, H).  Returns (y (B, S, H, P), state (B, H,
    P, N)).  A ragged S is padded with identity steps (rel = 0: decay 1;
    dt = x = B = C = 0): their outputs are dropped and the carried state
    is unchanged.  The chunks go in groups of at most ``_GROUP_BYTES`` of
    (B, C, C, H) f32 pair terms, the state carried through each group's
    chunks in order, so memory stays bounded in S.
    """
    b, s0, h, p = x.shape
    if s0 % chunk:
        pad = chunk - s0 % chunk
        x, bmat, cmat, rel, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                  for t in (x, bmat, cmat, rel, dt))
    s, n = x.shape[1], bmat.shape[-1]
    nc = s // chunk
    group = max(1, _GROUP_BYTES // (4 * b * chunk * chunk * h))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, nc, group):
        g = min(group, nc - c0)
        # (B, g C, ...) -> (B g, C, ...), batch-major
        xc, bc, cc, relc, dtc = (t[:, c0 * chunk:(c0 + g) * chunk].reshape(
            b * g, chunk, *t.shape[2:]) for t in (x, bmat, cmat, rel, dt))
        ll = torch.cumsum(relc, dim=1)                 # (Bg, C, H) inclusive log decay
        # intra-chunk: scores[t, s] = (C_t . B_s) exp(ll_t - ll_s) dt_s, s <= t
        cb = peinsum("btn,bsn->bts", cc, bc, policy)
        dec_ts = torch.exp(torch.clamp(ll[:, :, None, :] - ll[:, None, :, :], max=0.0))
        scores = cb[:, :, :, None] * dec_ts * dtc[:, None, :, :]
        scores = torch.where(mask[None, :, :, None], scores, torch.zeros((), device=x.device))
        y_intra = torch.einsum("btsh,bshp->bthp", scores.float(), xc.float())
        del dec_ts, scores
        # each chunk's state increment: decayed to the chunk's end, outer products
        dec_end = torch.exp(ll[:, -1:, :] - ll)        # (Bg, C, H)
        upd = torch.einsum("bchp,bcn->bhpn", ((dtc * dec_end)[..., None] * xc).float(),
                           bc.float())
        # carry the state through the group's chunks in order: each reads its input state
        decay = torch.exp(ll[:, -1]).reshape(b, g, h)[..., None, None]
        upd = upd.reshape(b, g, h, p, n)
        states_in = []
        for c in range(g):
            states_in.append(state)
            state = state * decay[:, c] + upd[:, c]
        state_in = torch.stack(states_in, dim=1).reshape(b * g, h, p, n)
        # inter-chunk: y_t += C_t . (exp(ll_t) * state_in)
        y_inter = (torch.einsum("bcn,bhpn->bchp", cc.float(), state_in.float())
                   * torch.exp(ll)[..., None])
        ys.append((y_inter + y_intra).reshape(b, g * chunk, h, p))
    return torch.cat(ys, dim=1)[:, :s0], state


def mamba2_layer(p: dict, x: torch.Tensor, *, head_dim: int, ssm_state: int,
                 conv_width: int, policy, chunk: int = 128,
                 state: MambaState | None = None, norm_eps: float = 1e-5,
                 return_state: bool = False,
                 ) -> tuple[torch.Tensor, MambaState | None]:
    """Pre-norm residual Mamba-2 mixer layer.

    Train: state None.  Decode: state given, x (B, 1, D).  Prefill: state
    None and ``return_state`` -> the final state emitted.
    """
    b, s, d = x.shape
    d_inner, nheads, conv_dim = _dims(d, head_dim, ssm_state)
    n = ssm_state
    dtype = x.dtype
    decode = state is not None

    resid = x
    xn = L.rmsnorm(p["norm_in"], x, norm_eps)
    zxbcdt = L.linear(p["in_proj"], xn, policy)          # f32
    z = zxbcdt[..., :d_inner]
    raw = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]

    xbc = _causal_conv(raw, p["conv_w"], p["conv_b"], state.conv if decode else None)
    new_conv = None
    if decode or return_state:
        # the last (width - 1) raw projected inputs (pre-conv) are the conv state
        joined = torch.cat([state.conv.to(raw.dtype), raw], dim=1) if decode else raw
        pad = conv_width - 1 - joined.shape[1]
        if pad > 0:
            joined = F.pad(joined, (0, 0, pad, 0))
        new_conv = joined[:, -(conv_width - 1):].float()

    x32 = xbc[..., :d_inner].reshape(b, s, nheads, head_dim).float()
    b32 = xbc[..., d_inner:d_inner + n].float()
    c32 = xbc[..., d_inner + n:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    rel = -dt * torch.exp(p["a_log"].float())             # (B, S, H) < 0

    if decode:
        st = state.ssd                                    # (B, H, P, N)
        a_t = torch.exp(rel[:, 0])                        # (B, H)
        st = st * a_t[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", (dt[:, 0, :, None] * x32[:, 0]).float(), b32[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", c32[:, 0].float(), st.float())[:, None]
        new_ssd = st
    else:
        y, new_ssd = _ssd_chunked(x32, b32, c32, rel, dt, min(chunk, s), policy)

    y = y + p["d_skip"].float()[None, None, :, None] * x32
    y = y.reshape(b, s, d_inner).to(dtype)
    y = L.rmsnorm(p["norm"], y, norm_eps) * F.silu(z).to(dtype)
    out = resid + L.linear(p["out_proj"], y, policy).to(dtype)

    new_state = MambaState(conv=new_conv, ssd=new_ssd) if decode or return_state else None
    return out, new_state
