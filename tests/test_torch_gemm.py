"""The port's GEMM family against the JAX package's, on the CPU.

The port's ``gemm`` / ``routed_einsum`` on the ``cuda`` impl (its
kernels' plain versions, since the tensors lie on the CPU) and on the
``torch`` reference must land within 1e-4 abs of ``repro``'s ``pallas``
impl (interpret mode) on the same numpy inputs, and within the ladder
bound of the fp64 oracle.  Operands are the family's non-tile-aligned
48 x 132 x 40 problem, through the 2-D, linear, unembed (NT) and
batched attention-score specs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro_torch.core import ops as tops
from repro_torch.core.ops.registry import LADDER_BOUNDS

POLICIES = ("bf16", "refine_a", "bf16x3", "refine_ab", "f32")
# Same bf16 terms, exact products; only the f32 summation order differs.
PARITY_ATOL = 1e-4

# spec -> (a shape, b shape): every problem is m*n*k = 48*40*132 shaped
SPECS = {
    "mk,kn->mn": ((48, 132), (132, 40)),
    "...i,io->...o": ((2, 24, 132), (132, 40)),
    "...d,vd->...v": ((2, 24, 132), (40, 132)),
    "bqkgd,bskd->bkgqs": ((2, 12, 2, 2, 132), (2, 40, 2, 132)),
}


def _operands(spec, seed=0):
    rng = np.random.default_rng(seed)
    sa, sb = SPECS[spec]
    return (rng.uniform(-1, 1, sa).astype(np.float32),
            rng.uniform(-1, 1, sb).astype(np.float32))


def _oracle(spec, a, b):
    return np.einsum(spec, a.astype(np.float64), b.astype(np.float64))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("spec", list(SPECS))
def test_routed_einsum_matches_repro_pallas(spec, policy):
    a, b = _operands(spec)
    ref = np.asarray(jops.routed_einsum(
        spec, jnp.asarray(a), jnp.asarray(b),
        jops.Route(precision=policy, backends={"gemm": "pallas"})))
    oracle = _oracle(spec, a, b)
    for impl in ("cuda", "torch"):
        out = tops.routed_einsum(
            spec, torch.from_numpy(a), torch.from_numpy(b),
            tops.Route(precision=policy, backends={"gemm": impl}))
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        out = out.numpy()
        assert np.abs(out - ref).max() <= PARITY_ATOL, (impl, policy, spec)
        assert np.abs(out - oracle).max() <= LADDER_BOUNDS[policy], (impl, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_gemm_entry_matches_repro_gemm(policy):
    a, b = _operands("mk,kn->mn", seed=1)
    ref = np.asarray(jops.gemm(jnp.asarray(a), jnp.asarray(b), policy=policy,
                               backend="pallas"))
    for backend in ("cuda", "torch"):
        out = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), policy=policy,
                        backend=backend).numpy()
        assert np.abs(out - ref).max() <= PARITY_ATOL


@pytest.mark.parametrize("policy", ("bf16x6", "fp8", "int8x3"))
def test_unfused_rungs_decompose_at_the_router(policy, monkeypatch):
    """The one rung the cuda impl does not fuse, bf16x6, runs as bf16
    passes through it, like ``repro``'s reference route.  The quantized
    rungs no longer decompose: the cuda impl fuses them in one
    ``gemm_lowp`` call with per-tile scales, as ``repro``'s ``pallas``
    impl does, and is held against it within ``test_torch_lowp``'s
    per-rung bounds (relative to the largest output)."""
    from repro_torch.core.precision import num_passes
    tgemm = importlib.import_module("repro_torch.core.ops.gemm")
    calls = {"gemm_tiled": 0, "gemm_lowp": 0}
    for name in calls:
        real = getattr(tgemm, name)
        monkeypatch.setattr(tgemm, name, lambda *a, _real=real, _name=name, **k: (
            calls.__setitem__(_name, calls[_name] + 1) or _real(*a, **k)))
    a, b = _operands("mk,kn->mn", seed=2)
    out = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), policy=policy,
                    backend="cuda").numpy()
    if policy == "bf16x6":
        assert calls == {"gemm_tiled": num_passes(policy), "gemm_lowp": 0}
        ref = np.asarray(jops.gemm(jnp.asarray(a), jnp.asarray(b), policy=policy,
                                   backend="xla"))
        assert np.abs(out - ref).max() <= PARITY_ATOL
    else:
        assert calls == {"gemm_tiled": 0, "gemm_lowp": 1}
        ref = np.asarray(jops.gemm(jnp.asarray(a), jnp.asarray(b), policy=policy,
                                   backend="pallas", interpret=True))
        bound = {"fp8": 5e-3, "int8x3": 2e-5}[policy]
        assert np.abs(out - ref).max() <= bound * np.abs(ref).max()
    assert np.abs(out - _oracle("mk,kn->mn", a, b)).max() <= LADDER_BOUNDS[policy]


def test_routes_validate_against_capabilities(monkeypatch):
    """Route build checks each impl's declared rungs: an impl that declares
    fewer (here cuda_fused cut to the bf16 ladder; the registered one
    declares every rung) refuses the others or falls back to the
    reference with a warning."""
    import dataclasses
    from repro_torch.core.ops import registry
    impl = registry.get_impl("attention", "cuda_fused")
    narrow = ("bf16", "refine_a", "bf16x3", "refine_ab", "f32")
    monkeypatch.setitem(registry._IMPLS["attention"], "cuda_fused", dataclasses.replace(
        impl, capabilities=registry.Capabilities(policies=frozenset(narrow),
                                                 fused_policies=frozenset(narrow),
                                                 features=impl.capabilities.features)))
    pol = tops.ExecutionPolicy(default="bf16", logits="refine_ab",
                               backends={"gemm": "cuda", "attention": "cuda_fused"},
                               require={"attention": ("decode",)})
    assert pol.for_("logits").precision == "refine_ab"
    assert pol.for_("mlp").impl("gemm") == "cuda"
    with pytest.raises(ValueError, match="rung 'fp8'"):
        tops.ExecutionPolicy(default="fp8", backends={"attention": "cuda_fused"})
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        tops.ExecutionPolicy(backends={"gemm": "pallas"})
    with pytest.warns(RuntimeWarning, match="falling back"):
        fb = tops.ExecutionPolicy(default="bf16x6", fallback=True,
                                  backends={"attention": "cuda_fused"})
    assert fb.for_("attention").impl("attention") == "torch"
    assert tops.parse_backend_flags(["gemm=cuda", "attention=cuda_fused"]) == {
        "gemm": "cuda", "attention": "cuda_fused"}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family,impl", [("gemm", "torch"), ("gemm", "cuda"),
                                         ("attention", "torch"),
                                         ("attention", "cuda_fused")])
def test_every_impl_meets_its_family_contract(family, impl, policy):
    """Each registered impl, through its family's own problem maker and
    runner, lands within the family's error bound of the fp64 oracle."""
    spec = tops.get_family(family)
    problem = spec.make_problem(0)
    out = spec.run(problem, tops.Route(precision=policy, backends={family: impl}))
    err = np.abs(out.double().numpy() - spec.oracle(problem)).max()
    assert err <= spec.error_bound(policy), (family, impl, policy, err)
