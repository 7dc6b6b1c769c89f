"""The port's Fig. 8 error protocol (``repro_torch.core.error``) against
``repro.core.error``, and the precision ladder's order on the port's GEMM
routes, on the CPU.

The metrics run in host float64 on both sides, so they agree exactly on
the same arrays; ``random_operands`` draws the same numpy stream, so the
operands are bit-equal; ``error_report`` on CPU operands forms its f64
and f32 products with numpy as ``repro`` does, so its values are equal.
The ladder order is ``tests/test_precision.py``'s (Fig. 8: each
refinement cuts the max-norm error against the f64 product), on the
``torch`` route and on ``cuda`` (the kernels' plain versions here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error as jerr
from repro_torch.core import error as err
from repro_torch.core.refined_matmul import refined_matmul

LADDER = ("bf16", "refine_a", "bf16x3", "refine_ab", "bf16x6", "f32")
GEMM_ROUTES = ("torch", "cuda")


def _operands(n, seed, value_range=1.0):
    return err.random_operands(n, value_range=value_range, seed=seed, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,value_range,seed", [(1, 1.0, 0), (33, 1.0, 7), (128, 16.0, 3)])
def test_random_operands_are_bit_equal(n, value_range, seed, dtype):
    ta, tb = err.random_operands(n, value_range=value_range, seed=seed, dtype=dtype,
                                 device="cpu")
    ja, jb = jerr.random_operands(n, value_range=value_range, seed=seed,
                                  dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    for t, j in ((ta, ja), (tb, jb)):
        assert t.dtype == dtype and t.shape == (n, n) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_random_operands_go_to_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert err.random_operands(4)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            err.random_operands(4)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
def test_metrics_equal_repros_exactly(kind):
    """max_norm_error and relative_fro_error on the same arrays (numpy, f32
    tensors, bf16 tensors against an f64 reference) equal repro's."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((70, 90)).astype(np.float32)
    ref = c.astype(np.float64) + rng.standard_normal((70, 90)) * 1e-3
    if kind == "bf16":
        tc = torch.from_numpy(c).to(torch.bfloat16)
        c = tc.float().numpy()
    else:
        tc = torch.from_numpy(c) if kind == "tensor" else c
    for ours, theirs in ((err.max_norm_error(tc, ref), jerr.max_norm_error(c, ref)),
                         (err.relative_fro_error(tc, ref), jerr.relative_fro_error(c, ref))):
        assert isinstance(ours, float) and ours == theirs
    assert err.max_norm_error(np.array([[1.0, 2.0], [3.0, 4.0]]),
                              np.array([[1.0, 2.5], [3.0, 3.0]])) == 1.0


@pytest.mark.parametrize("route", GEMM_ROUTES)
def test_error_report_equals_repros(route):
    """The same operands and the same results (the port's rungs) give the
    same keys and values in both packages' reports."""
    a, b = _operands(96, 3)
    results = {p: refined_matmul(a, b, policy=p, backend=route).numpy()
               for p in (*LADDER, "fp8x3", "int8x3")}
    ours = err.error_report(a, b, results)
    theirs = jerr.error_report(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), results)
    assert ours == theirs
    assert list(ours) == list(results)
    assert all(list(row) == ["max_vs_f64", "max_vs_f32", "rel_fro_vs_f64"]
               for row in ours.values())


@pytest.mark.parametrize("route", GEMM_ROUTES)
def test_error_strictly_improves_along_ladder(route):
    """tests/test_precision.py's ladder order (the paper's central claim,
    Fig. 8) on the port's route, n = 256 at U[-1, 1]."""
    a, b = _operands(256, 10)
    errs = {p: v["max_vs_f64"] for p, v in err.error_report(
        a, b, {p: refined_matmul(a, b, policy=p, backend=route) for p in LADDER}).items()}
    assert errs["refine_a"] < errs["bf16"]
    assert errs["bf16x3"] < errs["refine_a"]
    assert errs["refine_ab"] < 0.5 * errs["refine_a"]
    assert errs["bf16x6"] < errs["refine_ab"]
    assert errs["f32"] < errs["bf16"] / 50
    assert errs["refine_ab"] < errs["bf16"] / 8


@pytest.mark.parametrize("route", GEMM_ROUTES)
def test_bf16_error_grows_with_n_and_refinement_holds_at_16(route):
    """Fig. 8's growth of the bf16 error with N, and the +-16 inputs, where
    refine_ab still cuts the error by more than 8x."""
    es = []
    for n in (64, 256, 1024):
        a, b = _operands(n, n)
        es.append(err.error_report(a, b, {"bf16": refined_matmul(
            a, b, policy="bf16", backend=route)})["bf16"]["max_vs_f64"])
    assert es[0] < es[1] < es[2]
    a, b = _operands(256, 30, value_range=16.0)
    rep = err.error_report(a, b, {p: refined_matmul(a, b, policy=p, backend=route)
                                  for p in ("bf16", "refine_ab")})
    assert np.isfinite(rep["bf16"]["max_vs_f64"])
    assert rep["refine_ab"]["max_vs_f64"] < rep["bf16"]["max_vs_f64"] / 8
