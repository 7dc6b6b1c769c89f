"""Common building blocks (twin of ``repro.models.layers``), plain
functions over dict params.

Every matmul routes through ``core.refined_matmul.peinsum``, so the
precision policy, and through an ``ExecutionPolicy`` route the GEMM
impl, apply to every layer.  Initialisers draw the same shapes and
scales as the JAX package (distribution-equal, not bit-equal: a
``torch.Generator`` is not a JAX key).  ``unembed`` hands its logits
to ``runtime.act_sharding.constrain``, as the JAX package does; the
sharded ops return plain tensors (explicit SPMD), which it passes through
unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ops import Route
from repro_torch.core.refined_matmul import peinsum
from repro_torch.runtime.act_sharding import constrain

Policy = str | Route
Params = dict

__all__ = [
    "init_linear", "linear",
    "init_rmsnorm", "rmsnorm",
    "init_embedding", "embed", "unembed",
    "init_mlp", "mlp",
]


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, device=gen.device,
                               dtype=torch.float32)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: float | None = None,
                stack: tuple[int, ...] = ()) -> Params:
    """A (*stack, d_in, d_out) weight (``stack``: the experts of an MoE)."""
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": _normal(gen, (*stack, d_in, d_out), scale)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=torch.float32, device=gen.device)
    return p


def linear(p: Params, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) under a precision policy; f32 out."""
    y = peinsum("...i,io->...o", x, p["w"], policy)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics regardless of the activation dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int) -> Params:
    return {"table": _normal(gen, (vocab, d), d ** -0.5)}


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gather the rows first, then cast (the same values as casting the
    whole table, without writing a converted copy of it)."""
    return p["table"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Logits projection against the (V, d) table, an NT product the
    router hands to the GEMM impl as a view.  The logits take the installed
    constraint (B: dp, S, V: tp; ``runtime/act_sharding.py``)."""
    return constrain(peinsum("...d,vd->...v", x, p["table"], policy), "logits")


def init_mlp(gen: torch.Generator, d: int, d_ff: int, kind: str, *,
             bias: bool = False) -> Params:
    if kind == "swiglu":
        return {"wi": init_linear(gen, d, d_ff, bias=bias),
                "wg": init_linear(gen, d, d_ff, bias=bias),
                "wo": init_linear(gen, d_ff, d, bias=bias)}
    if kind in ("squared_relu", "gelu"):
        return {"wi": init_linear(gen, d, d_ff, bias=bias),
                "wo": init_linear(gen, d_ff, d, bias=bias)}
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp(p: Params, x: torch.Tensor, kind: str, policy: Policy) -> torch.Tensor:
    dtype = x.dtype
    h = linear(p["wi"], x, policy)
    if kind == "swiglu":
        h = F.silu(linear(p["wg"], x, policy)) * h
    elif kind == "squared_relu":
        h = F.relu(h).square()
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return linear(p["wo"], h.to(dtype), policy).to(dtype)
