"""The paper's precision protocol (Fig. 8 / Fig. 9): twin of
``repro.core.error``.

The paper measures the precision a narrow GEMM loses as the max norm of
the error matrix ``e = C_narrow - C_single`` over random U[-1, 1] (and
+-16) inputs, sweeping the matrix size N.  The metrics run in float64:
in host numpy for host arrays and tensors, as the JAX package's do, and
on the card where both operands are card tensors (the same max-norm,
whose subtraction and maximum are exact; the Frobenius norms to
rounding), so that an 8192 x 8192 result is not copied to the host.
``error_report`` also gives the error against the f64 product, so the
f32 baseline's own error shows (the paper treats f32 as exact); it forms
the f64 and f32 products where the operands are: on the card for card
tensors (f32 with TF32 off), with numpy on the host otherwise, as the JAX
package does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device

__all__ = ["max_norm_error", "relative_fro_error", "error_report", "random_operands"]


def _host64(x) -> np.ndarray:
    """A tensor or array as a host float64 numpy array (exact from f32 or
    bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype not in (torch.float32, torch.float64):
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _on_card(*xs) -> bool:
    return all(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in xs)


def max_norm_error(c, c_ref) -> float:
    """``||e||_max = max |c_ij - ref_ij|``, the paper's figure of merit, in
    float64."""
    if _on_card(c, c_ref):
        return float((c.double() - c_ref.double()).abs().max())
    return float(np.max(np.abs(_host64(c) - _host64(c_ref))))


def relative_fro_error(c, c_ref) -> float:
    if _on_card(c, c_ref):
        r64 = c_ref.double()
        return float(torch.linalg.vector_norm(c.double() - r64)
                     / max(float(torch.linalg.vector_norm(r64)), 1e-30))
    c64, r64 = _host64(c), _host64(c_ref)
    return float(np.linalg.norm(c64 - r64) / max(np.linalg.norm(r64), 1e-30))


def random_operands(n: int, *, value_range: float = 1.0, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """A, B ~ U[-r, r]^(n x n) in f32 (the paper's input protocol), drawn
    from ``np.random.default_rng(seed)`` as the JAX package draws them, on
    ``device``: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = rng.uniform(-value_range, value_range, size=(n, n)).astype(np.float32)
    b = rng.uniform(-value_range, value_range, size=(n, n)).astype(np.float32)
    return (torch.from_numpy(a).to(dev, dtype), torch.from_numpy(b).to(dev, dtype))


def _oracles(a, b):
    """(f64 product, f32 product): card tensors for card operands, host
    float64 arrays otherwise."""
    if _on_card(a, b):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a.double() @ b.double(), a.float() @ b.float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    a64, b64 = _host64(a), _host64(b)
    return (a64.astype(np.float64, copy=False) @ b64.astype(np.float64, copy=False),
            _host64(a64.astype(np.float32) @ b64.astype(np.float32)))


def error_report(a, b, results: dict) -> dict[str, dict[str, float]]:
    """Per policy: the max-norm and relative Frobenius error against the
    f64 product (the true error) and the max-norm error against the f32
    product (the paper's e).  ``results`` maps a policy name to its C."""
    c64, c32 = _oracles(a, b)
    out: dict[str, dict[str, float]] = {}
    for name, c in results.items():
        if not _on_card(c, c64):
            c = _host64(c)
        out[name] = {"max_vs_f64": max_norm_error(c, c64),
                     "max_vs_f32": max_norm_error(c, c32),
                     "rel_fro_vs_f64": relative_fro_error(c, c64)}
    return out
