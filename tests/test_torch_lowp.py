"""The port's fp8/int8 GEMM rungs against the JAX package's, on the CPU.

``gemm_lowp_plain`` (what CPU tensors run in place of the ``gemm_lowp``
CUDA kernel) is held against ``repro``'s ``gemm_lowp`` Pallas kernel in
interpret mode, and the ``cuda`` gemm impl's routed einsum against
``repro``'s ``pallas`` impl: both quantize every (bm, bk) tile of A and
(bk, bn) tile of B under its own amax scale on the grid
``tile_for(impl, m, n, k)`` gives.  The checklist is
``tests/test_lowp_gemm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ops import routed_einsum as jrouted_einsum
from repro.core.ops.route import Route as JRoute
from repro.core.ops.tiles import tile_for as jtile_for
from repro.kernels.gemm_lowp import gemm_lowp as jgemm_lowp
from repro_torch.core.ops import LADDER_BOUNDS, Route, gemm, routed_einsum, tile_for
from repro_torch.kernels.gemm_lowp import gemm_lowp, gemm_lowp_plain

QUANT_RUNGS = ("fp8", "int8", "fp8x3", "int8x3")
# The port follows repro's kernel as written: s = amax / qmax, y = x / s,
# the residual x - q*s and the dequantizing accumulate acc + P*(sa*sb),
# each operation rounded on its own.  XLA's CPU compiler, which runs
# repro's kernel in interpret mode, rewrites amax / 127.0 into
# amax * (1/127) (so one tile scale in ~20 is 1 ulp off) and contracts the
# residual and the accumulate into FMAs (measured with jax.jit on the
# same expressions).  A 1-ulp scale moves a value that sits on a rounding
# boundary by one quantization level, so the two agree to a bound per
# rung, max |port - repro| / max |repro| (measured worst over these cases:
# fp8 1.2e-3, int8 1.7e-4, fp8x3 7.9e-5, int8x3 3.5e-6); each bound lies
# below the per-tensor-scale route's distance from repro (fp8 >= 5.1e-2,
# int8 >= 9.9e-3, fp8x3 >= 1.5e-3, int8x3 >= 7.4e-5).
REPRO_REL = {"fp8": 5e-3, "int8": 1e-3, "fp8x3": 3e-4, "int8x3": 2e-5}
CUDA = {"gemm": "cuda"}
PALLAS = {"gemm": "pallas"}


def _problem(m, k, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32) * scale
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32) * scale
    return a, b


def _dist(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _hold(out, ref, rung):
    assert _dist(out, ref) <= REPRO_REL[rung], (rung, _dist(out, ref))


def _rel(out, a, b):
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(np.asarray(out, np.float64) - oracle).max() / np.abs(oracle).max())


@pytest.mark.parametrize("rung", QUANT_RUNGS)
@pytest.mark.parametrize("m,k,n", [(96, 160, 80), (300, 520, 270), (4, 96, 40)])
def test_plain_matches_repro_kernel(rung, m, k, n):
    """Ragged shapes on repro's grid (clamped 256-tiles): repro pads to
    the grid, the port's plain version pads internally (the kernel masks)."""
    a, b = _problem(m, k, n, seed=m + n)
    t = jtile_for("pallas", m, n, k)
    ap = np.pad(a, ((0, -m % t.bm), (0, -k % t.bk)))
    bp = np.pad(b, ((0, -k % t.bk), (0, -n % t.bn)))
    ref = np.asarray(jgemm_lowp(jnp.asarray(ap), jnp.asarray(bp), policy=rung, bm=t.bm,
                                bn=t.bn, bk=t.bk, interpret=True))[:m, :n]
    out = gemm_lowp_plain(torch.from_numpy(a), torch.from_numpy(b), rung, t.bm, t.bn, t.bk)
    _hold(out.numpy(), ref, rung)


@pytest.mark.parametrize("rung", QUANT_RUNGS)
def test_cuda_route_matches_repro_pallas_route(rung):
    """A routed einsum at the model's linear shape ('...i,io->...o', a
    leading batch folded into M): gemm=cuda against repro's gemm=pallas.
    The cuda impl once ran these rungs as per-tensor pow2 bf16 passes."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 150, 272)).astype(np.float32)
    w = (rng.uniform(-1, 1, (272, 300)) / 16).astype(np.float32)
    tt, jt = tile_for("cuda", 300, 300, 272), jtile_for("pallas", 300, 300, 272)
    assert (tt.bm, tt.bn, tt.bk) == (jt.bm, jt.bn, jt.bk)
    ref = np.asarray(jrouted_einsum("...i,io->...o", jnp.asarray(x), jnp.asarray(w),
                                    JRoute(precision=rung, backends=PALLAS, interpret=True)))
    out = routed_einsum("...i,io->...o", torch.from_numpy(x), torch.from_numpy(w),
                        Route(precision=rung, backends=CUDA))
    _hold(out.numpy(), ref, rung)
    per_tensor = routed_einsum("...i,io->...o", torch.from_numpy(x), torch.from_numpy(w),
                               Route(precision=rung))
    assert _dist(per_tensor.numpy(), ref) > REPRO_REL[rung]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_rungs_within_bounds_and_corrected_tighter(impl):
    a, b = _problem(96, 160, 80)
    errs = {}
    for rung in QUANT_RUNGS:
        out = gemm(torch.from_numpy(a), torch.from_numpy(b),
                   policy=Route(precision=rung, backends={"gemm": impl}))
        errs[rung] = _rel(out.numpy(), a, b)
        assert errs[rung] <= LADDER_BOUNDS[rung], (rung, errs[rung])
    assert errs["fp8x3"] < errs["fp8"] / 5 and errs["int8x3"] < errs["int8"] / 5


def test_per_tile_scales_beat_per_tensor_on_skewed_operands():
    """One 32-row block of A 64x larger: a per-tensor scale wastes int8
    codes on every other row, per-tile scales only on that block's tile."""
    a, b = _problem(96, 160, 80)
    a[:32] *= 64.0
    e_tile = _rel(gemm_lowp(torch.from_numpy(a), torch.from_numpy(b), policy="int8",
                            bm=32, bn=256, bk=256).numpy(), a, b)
    e_tensor = _rel(routed_einsum("mk,kn->mn", torch.from_numpy(a), torch.from_numpy(b),
                                  "int8").numpy(), a, b)
    assert e_tile < e_tensor / 2, (e_tile, e_tensor)


@pytest.mark.parametrize("rung", ["int8x3", "fp8"])
def test_grads_through_quant_rungs_match_repro(rung):
    """The backward contractions of a routed einsum run the same rung on
    the same impl (dA = g.B^T, dB = A^T.g, each quantized per tile)."""
    a, b = _problem(40, 72, 24, seed=9)
    g = np.random.default_rng(1).uniform(-1, 1, (40, 24)).astype(np.float32)
    jroute = JRoute(precision=rung, backends=PALLAS, interpret=True)
    _, vjp = jax.vjp(lambda x, y: jrouted_einsum("mk,kn->mn", x, y, jroute),
                     jnp.asarray(a), jnp.asarray(b))
    jda, jdb = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = routed_einsum("mk,kn->mn", ta, tb, Route(precision=rung, backends=CUDA))
    da, db = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    assert np.isfinite(da.numpy()).all() and da.abs().max() > 0
    _hold(da.numpy(), np.asarray(jda), rung)
    _hold(db.numpy(), np.asarray(jdb), rung)


def test_gemm_lowp_checks_its_grid():
    a, b = torch.ones(4, 8), torch.ones(8, 4)
    with pytest.raises(ValueError, match="policy"):
        gemm_lowp(a, b, policy="bf16")
    # the plain version pads any grid; the batched form is one per matrix
    a3, b3 = torch.randn(3, 20, 30), torch.randn(3, 30, 10)
    out = gemm_lowp(a3, b3, policy="int8x3", bm=8, bn=128, bk=128)
    for i in range(3):
        torch.testing.assert_close(out[i], gemm_lowp_plain(a3[i], b3[i], "int8x3", 8, 128, 128),
                                   rtol=0, atol=0)
