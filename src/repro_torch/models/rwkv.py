"""RWKV-6 "Finch" (arXiv:2404.05892), twin of ``repro.models.rwkv``: an
attention-free layer with token shift, data-dependent per-channel decay
and the WKV linear-attention recurrence.

Prefill (and training) runs the chunked parallel form ``_wkv_chunked``:
within a chunk the pairwise decays are an explicit (C, C, K) tensor,
across chunks a (K, V) state is carried in a Python loop (the JAX
package's ``lax.scan``).  Every relative decay is e^{la_t - la_s} with
s <= t, so every exponent is <= 0.  Its contractions go through
``routed_einsum`` at the layer's policy, on whichever GEMM impl the route
names, as in the JAX package; the fused ``kernels/wkv6`` kernel is an
entry point of its own there and here, not called by the model.

Decode carries (shift_tm, shift_cm, wkv) and is O(1) per token.  The
dtype casts follow the JAX code line for line (activations in the
config's dtype, the projections' f32 outputs, the f32 log decay and
state): bf16 parity depends on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.ops import routed_einsum as peinsum
from repro_torch.models import layers as L

__all__ = ["init_rwkv6", "rwkv6_layer", "time_mix_inputs", "RWKVState", "init_rwkv_state"]

_LORA_DIM = 32


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor   # (B, D) last token seen by time-mix
    shift_cm: torch.Tensor   # (B, D) last token seen by channel-mix
    wkv: torch.Tensor        # (B, H, K, V) linear-attention state


def init_rwkv_state(batch: int, d_model: int, head_dim: int, *,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> RWKVState:
    h = d_model // head_dim
    return RWKVState(
        shift_tm=torch.zeros((batch, d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32, device=device))


def init_rwkv6(gen: torch.Generator, d: int, d_ff: int, head_dim: int) -> dict:
    """Random params with the JAX package's shapes and scales."""
    del head_dim
    dev = gen.device

    def lora():
        return {"a": L.init_linear(gen, d, _LORA_DIM),
                "b": L.init_linear(gen, _LORA_DIM, d, scale=0.01)}

    return {
        "norm_tm": L.init_rmsnorm(d, dev),
        "norm_cm": L.init_rmsnorm(d, dev),
        # DDLerp token-shift mixes (mu) + low-rank data-dependent parts
        "mu_x": torch.zeros(d, dtype=torch.float32, device=dev),
        "mu": torch.zeros((5, d), dtype=torch.float32, device=dev),   # w, k, v, r, g
        "lora_w": lora(), "lora_k": lora(), "lora_v": lora(),
        "lora_r": lora(), "lora_g": lora(),
        "w0": torch.full((d,), -0.7, dtype=torch.float32, device=dev),  # decay bias
        "u": 0.1 * torch.randn(d, generator=gen, device=dev, dtype=torch.float32),
        "wr": L.init_linear(gen, d, d),
        "wk": L.init_linear(gen, d, d),
        "wv": L.init_linear(gen, d, d),
        "wg": L.init_linear(gen, d, d),
        "wo": L.init_linear(gen, d, d),
        "ffn_r": L.init_linear(gen, d, d),
        "ffn_k": L.init_linear(gen, d, d_ff),
        "ffn_v": L.init_linear(gen, d_ff, d),
    }


def _ddlerp(p: dict, x: torch.Tensor, dx: torch.Tensor, policy):
    """Data-dependent token-shift interpolation -> (x_w, x_k, x_v, x_r, x_g)."""
    xxx = x + dx * p["mu_x"].to(x.dtype)
    outs = []
    for i, name in enumerate(("w", "k", "v", "r", "g")):
        lo = p[f"lora_{name}"]
        dd = L.linear(lo["b"], torch.tanh(L.linear(lo["a"], xxx, policy)), policy)
        mix = p["mu"][i].to(x.dtype) + dd.to(x.dtype)
        outs.append(x + dx * mix)
    return outs


def _wkv_chunked(r, k, v, logw, u, chunk: int, policy="bf16"):
    """Chunked WKV: r/k/v/logw (B, S, H, K) (logw <= 0), u (H, K).

    Returns (out (B, S, H, K), final state (B, H, K, V)), f32.  A ragged
    S is padded with identity steps (decay 1, k = v = 0): their outputs
    are dropped and the carried state is unchanged.  The MXU-shaped
    contractions run through the policy router; the bonus is a plain f32
    contraction."""
    b, s0, h, kd = r.shape
    if s0 % chunk:
        pad = (0, 0, 0, 0, 0, chunk - s0 % chunk)
        r, k, v, logw = (F.pad(t, pad) for t in (r, k, v, logw))
    s = r.shape[1]
    n = s // chunk

    def chunks(t):  # (B, S, H, K) -> (n, B, H, C, K)
        return t.reshape(b, n, chunk, h, kd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(logw)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    state = torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
    outs = []
    for rr, kk, vv, lw in zip(rc, kc, vc, wc):
        la = torch.cumsum(lw, dim=2)             # inclusive cum log decay
        lae = la - lw                            # exclusive: decay to t-1
        # inter-chunk: r_t reads S_{t-1} = S_0 decayed by w_1..w_{t-1}
        r_dec = rr * torch.exp(lae)
        inter = peinsum("bhck,bhkv->bhcv", r_dec, state, policy)
        # intra-chunk (strict causal), r folded into the decay tensor
        r_ed = rr[:, :, :, None, :] * torch.exp(torch.clamp(
            lae[:, :, :, None, :] - la[:, :, None, :, :], max=0.0))
        scores = peinsum("bhtsk,bhsk->bhts", r_ed, kk, policy)
        scores = torch.where(mask, scores, torch.zeros((), device=r.device))
        intra = peinsum("bhts,bhsv->bhtv", scores, vv, policy)
        bonus = torch.einsum("bhck,bhck->bhc", (rr * u[None, :, None, :]).float(), kk.float())
        outs.append(inter + intra + bonus[..., None] * vv)
        # state update: decay to the chunk's end, add decayed outer products
        dec_end = torch.exp(la[:, :, -1:, :] - la)
        state = state * torch.exp(la[:, :, -1, :])[..., None] + peinsum(
            "bhck,bhcv->bhkv", kk * dec_end, vv, policy)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, kd)
    return out[:, :s0], state


def time_mix_inputs(p: dict, xn: torch.Tensor, prev: torch.Tensor, *, head_dim: int,
                    policy) -> tuple[torch.Tensor, ...]:
    """The time-mix's WKV operands from the normed input ``xn`` and its
    shifted copy ``prev``: (r, k, v (B, S, H, K) f32, g (B, S, D) f32,
    logw (B, S, H, K) f32, u (H, K) f32)."""
    b, s, d = xn.shape
    h = d // head_dim
    dx = prev - xn
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, xn, dx, policy)
    r = L.linear(p["wr"], x_r, policy).reshape(b, s, h, head_dim)
    k = L.linear(p["wk"], x_k, policy).reshape(b, s, h, head_dim)
    v = L.linear(p["wv"], x_v, policy).reshape(b, s, h, head_dim)
    g = F.silu(L.linear(p["wg"], x_g, policy))
    lw = p["w0"].float() + L.linear(p["lora_w"]["b"], torch.tanh(
        L.linear(p["lora_w"]["a"], x_w, policy)), policy)
    logw = -torch.exp(lw.reshape(b, s, h, head_dim))   # log decay, < 0
    u = p["u"].reshape(h, head_dim).float()
    return r.float(), k.float(), v.float(), g, logw, u


def rwkv6_layer(p: dict, x: torch.Tensor, *, head_dim: int, policy,
                state: RWKVState | None = None, norm_eps: float = 1e-5,
                chunk: int = 32, return_state: bool = False,
                ) -> tuple[torch.Tensor, RWKVState | None]:
    """Full RWKV-6 layer (time-mix + channel-mix), pre-norm residual.

    Train: state None, x (B, S, D).  Decode: state given, x (B, 1, D).
    Prefill: state None and ``return_state`` -> the final state emitted.
    """
    b, s, d = x.shape
    h = d // head_dim
    dtype = x.dtype
    decode = state is not None

    # ---------------- time mix ----------------
    xn = L.rmsnorm(p["norm_tm"], x, norm_eps)
    if decode:
        prev = state.shift_tm.to(dtype)[:, None, :]
    else:
        prev = F.pad(xn, (0, 0, 1, 0))[:, :-1]
    r32, k32, v32, g, logw, u = time_mix_inputs(p, xn, prev, head_dim=head_dim,
                                                policy=policy)
    if decode:
        st = state.wkv                                   # (B, H, K, V)
        rr, kk, vv = r32[:, 0], k32[:, 0], v32[:, 0]     # (B, H, K)
        bonus = torch.einsum("bhk,bhk->bh", (rr * u[None]).float(), kk.float())
        out = torch.einsum("bhk,bhkv->bhv", rr.float(), st.float()) + bonus[..., None] * vv
        new_wkv = st * torch.exp(logw[:, 0])[..., None] + kk[..., None] * vv[:, :, None, :]
        out = out[:, None]                               # (B, 1, H, V)
    else:
        out, new_wkv = _wkv_chunked(r32, k32, v32, logw, u, min(chunk, s), policy=policy)

    out = out.reshape(b, s, d).to(dtype) * g.to(dtype)
    x = x + L.linear(p["wo"], out, policy).to(dtype)

    # ---------------- channel mix ----------------
    xn2 = L.rmsnorm(p["norm_cm"], x, norm_eps)
    if decode:
        prev2 = state.shift_cm.to(dtype)[:, None, :]
    else:
        prev2 = F.pad(xn2, (0, 0, 1, 0))[:, :-1]
    dx2 = prev2 - xn2
    x_kc = xn2 + dx2 * 0.5
    x_rc = xn2 + dx2 * 0.5
    kk2 = torch.square(F.relu(L.linear(p["ffn_k"], x_kc, policy)))
    rr2 = torch.sigmoid(L.linear(p["ffn_r"], x_rc, policy))
    x = x + (rr2 * L.linear(p["ffn_v"], kk2.to(dtype), policy)).to(dtype)

    new_state = None
    if decode or return_state:
        new_state = RWKVState(shift_tm=xn[:, -1].float(), shift_cm=xn2[:, -1].float(),
                              wkv=new_wkv)
    return x, new_state
