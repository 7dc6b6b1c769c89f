"""The port's naive and batched GEMM kernels against the JAX package's,
on the CPU.

``gemm_naive_plain`` and both batched plain versions are held within
1e-5 (abs and rel, ``tests/test_kernels.py``'s) of ``repro``'s Pallas
kernels in interpret mode on the same numpy inputs: the same bf16 terms,
exact products, f32 sums in another order.  The ``cuda_naive`` route is
held against the ``pallas_naive`` route within 1e-4, ``repro``'s route
tolerance at ragged shapes (the refine_ab rung's four bf16 passes sum in
another order too).  The wrappers run their plain versions here, the
tensors lying on the CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.kernels import ops as j_kops
from repro.kernels import ref as j_ref
from repro.kernels.batched_gemm import batched_gemm as j_batched_gemm
from repro.kernels.batched_gemm import batched_gemm_naive as j_batched_gemm_naive
from repro.kernels.gemm_naive import gemm_naive as j_gemm_naive
from repro_torch.core import ops as tops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.batched_gemm import (batched_gemm, batched_gemm_naive,
                                              batched_gemm_naive_plain, batched_gemm_plain)
from repro_torch.kernels.gemm_naive import gemm_naive, gemm_naive_plain

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
ROUTE_ATOL = 1e-4


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128)])
def test_gemm_naive_plain_matches_repro_kernel(m, k, n):
    a, b = _rand((m, k), 7), _rand((k, n), 8)
    want = np.asarray(j_gemm_naive(jnp.asarray(a), jnp.asarray(b), bm=128, bn=128,
                                   interpret=True))
    for fn in (gemm_naive_plain, gemm_naive, ref.gemm_mixed_ref):
        got = fn(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("m,k,n", [(100, 130, 50), (257, 129, 65)])
@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
def test_cuda_naive_route_matches_pallas_naive_route(m, k, n, policy):
    a, b = _rand((m, k), m), _rand((k, n), n)
    want = np.asarray(jops.gemm(jnp.asarray(a), jnp.asarray(b), policy=policy,
                                backend="pallas_naive", interpret=True))
    got = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), policy=policy,
                    backend="cuda_naive")
    assert tuple(got.shape) == (m, n)
    assert np.abs(got.numpy() - want).max() <= ROUTE_ATOL
    oracle = (ref.gemm_mixed_ref if policy == "bf16" else ref.gemm_refined_ref)(
        torch.from_numpy(a), torch.from_numpy(b))
    assert np.abs(got.numpy() - oracle.numpy()).max() <= ROUTE_ATOL


def test_cuda_naive_route_decomposes_refine_ab_into_four_naive_passes(monkeypatch):
    tgemm = importlib.import_module("repro_torch.core.ops.gemm")
    calls = []
    real = tgemm.gemm_naive
    monkeypatch.setattr(tgemm, "gemm_naive", lambda a, b: calls.append(a.dtype) or real(a, b))
    a, b = _rand((48, 132), 1), _rand((132, 40), 2)
    out = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), policy="refine_ab",
                    backend="cuda_naive")
    assert calls == [torch.bfloat16] * 4
    out32 = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), policy="f32",
                      backend="cuda_naive")
    assert len(calls) == 4                        # f32 runs the reference
    np.testing.assert_allclose(out32.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    assert np.abs(out.numpy() - a.astype(np.float64) @ b).max() <= tops.LADDER_BOUNDS["refine_ab"]


@pytest.mark.parametrize("policy", ["bf16", "refine_ab", "f32"])
def test_cuda_naive_meets_the_family_contract(policy):
    spec = tops.get_family("gemm")
    problem = spec.make_problem(0)
    out = spec.run(problem, tops.Route(precision=policy, backends={"gemm": "cuda_naive"}))
    assert np.abs(out.double().numpy() - spec.oracle(problem)).max() <= spec.error_bound(policy)


def test_routed_einsum_gradients_on_cuda_naive_match_repro():
    """dA and dB of a linear ('...i,io->...o') on the cuda_naive route,
    against jax.grad through repro's pallas_naive route."""
    x, w, g = _rand((2, 24, 132), 3), _rand((132, 40), 4), _rand((2, 24, 40), 5)
    jroute = jops.Route(precision="bf16", backends={"gemm": "pallas_naive"}, interpret=True)
    jda, jdb = jax.grad(lambda a, b: jnp.sum(
        jops.routed_einsum("...i,io->...o", a, b, jroute) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tops.routed_einsum("...i,io->...o", xt, wt,
                             tops.Route(precision="bf16", backends={"gemm": "cuda_naive"}))
    out.backward(torch.from_numpy(g))
    assert np.abs(xt.grad.numpy() - np.asarray(jda)).max() <= ROUTE_ATOL
    assert np.abs(wt.grad.numpy() - np.asarray(jdb)).max() <= ROUTE_ATOL


@pytest.mark.parametrize("g,n", [(8, 16), (16, 16), (8, 32), (4, 64), (16, 8), (128, 16)])
def test_batched_plain_versions_match_repro_kernels(g, n):
    a, b = _rand((g, n, n), g), _rand((g, n, n), n)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    packed = np.asarray(j_batched_gemm(ja, jb, tile=128, interpret=True))
    np.testing.assert_allclose(np.asarray(j_ref.batched_gemm_packed_ref(ja, jb, 128 // n)),
                               packed, **KERNEL_TOL)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (batched_gemm_plain(ta, tb), batched_gemm(ta, tb),
                ref.batched_gemm_packed_ref(ta, tb, 128 // n)):
        assert tuple(got.shape) == (g, n, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), packed, **KERNEL_TOL)
    if g == 8 and n == 16:
        naive = np.asarray(j_batched_gemm_naive(ja, jb, interpret=True))
        for got in (batched_gemm_naive_plain(ta, tb), batched_gemm_naive(ta, tb),
                    ref.batched_gemm_ref(ta, tb)):
            np.testing.assert_allclose(got.numpy(), naive, **KERNEL_TOL)


@pytest.mark.parametrize("g", range(1, 41))
def test_gemm_batched_pads_any_group_count(g):
    """G needs no alignment: ``cuda`` pads to the packing multiple; every
    backend lands on repro's oracle."""
    n = (8, 16, 32)[g % 3]
    a, b = _rand((g, n, n), g + n), _rand((g, n, n), g * n)
    want = np.asarray(j_ref.batched_gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    for backend in ("cuda", "cuda_naive", "torch"):
        got = kops.gemm_batched(torch.from_numpy(a), torch.from_numpy(b), backend=backend)
        assert tuple(got.shape) == (g, n, n)
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_gemm_batched_backends_match_repros():
    a, b = _rand((12, 16, 16), 1), _rand((12, 16, 16), 2)
    for tb, jb in (("torch", "xla"), ("cuda", "pallas"), ("cuda_naive", "pallas_naive")):
        want = np.asarray(j_kops.gemm_batched(jnp.asarray(a), jnp.asarray(b), backend=jb,
                                              interpret=True))
        got = kops.gemm_batched(torch.from_numpy(a), torch.from_numpy(b), backend=tb)
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("n,g", [(1, 5), (2, 70), (4, 33), (128, 3)])
def test_gemm_batched_cuda_takes_every_divisor_of_the_tile(monkeypatch, n, g):
    """n in {1, 2, 4, 128} divides the packing tile, so repro's ``pallas``
    packs it; the port has no packed kernel for it and runs the naive one
    (any n), never ``torch``.  The packed entry refuses those n on the CPU
    as on the card."""
    import repro_torch.kernels.ops as kops_mod
    a, b = _rand((g, n, n), g + n), _rand((g, n, n), 3 * n)
    want = np.asarray(j_kops.gemm_batched(jnp.asarray(a), jnp.asarray(b), backend="pallas",
                                          interpret=True))
    monkeypatch.setattr(kops_mod, "batched_gemm", lambda *x, **k: pytest.fail("packed"))
    monkeypatch.setattr(kops_mod, "batched_gemm_ref", lambda *x, **k: pytest.fail("torch"))
    got = kops.gemm_batched(torch.from_numpy(a), torch.from_numpy(b), backend="cuda")
    assert tuple(got.shape) == (g, n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    pack = 128 // n
    with pytest.raises(ValueError, match="takes n in"):
        batched_gemm(torch.zeros(pack, n, n), torch.zeros(pack, n, n))


def test_block_diagonal_no_crosstalk():
    """Matrix i's result does not see matrix j's data: zeroing one input
    zeroes exactly one output."""
    a, b = _rand((8, 16, 16), 5), _rand((8, 16, 16), 6)
    a[3] = 0.0
    got = batched_gemm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (got[3] == 0.0).all() and (np.abs(got).reshape(8, -1).max(1)[[0, 1, 2, 4]] > 0).all()
    np.testing.assert_allclose(got, np.asarray(j_ref.batched_gemm_ref(jnp.asarray(a),
                                                                      jnp.asarray(b))),
                               **KERNEL_TOL)


def test_large_n_routes_to_torch_and_bad_shapes_raise(monkeypatch):
    """n > PACK_TILE leaves nothing to pack: ``cuda`` hands it to ``torch``, as
    repro's ``pallas`` hands it to ``xla``; the packed kernel itself
    raises where repro's does."""
    import repro_torch.kernels.ops as kops_mod
    a, b = _rand((3, 256, 256), 1), _rand((3, 256, 256), 2)
    monkeypatch.setattr(kops_mod, "batched_gemm", lambda *x, **k: pytest.fail("packed"))
    got = kops.gemm_batched(torch.from_numpy(a), torch.from_numpy(b), backend="cuda")
    want = np.asarray(j_kops.gemm_batched(jnp.asarray(a), jnp.asarray(b), backend="pallas",
                                          interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    with pytest.raises(ValueError, match="must divide"):
        batched_gemm(torch.zeros(8, 24, 24), torch.zeros(8, 24, 24))
    with pytest.raises(ValueError, match="multiple of pack"):
        batched_gemm(torch.zeros(6, 16, 16), torch.zeros(6, 16, 16))
    with pytest.raises(ValueError, match="matching"):
        kops.gemm_batched(torch.zeros(4, 4, 4), torch.zeros(4, 4, 5))
    with pytest.raises(ValueError, match="unknown backend"):
        kops.gemm_batched(torch.zeros(4, 4, 4), torch.zeros(4, 4, 4), backend="pallas")

