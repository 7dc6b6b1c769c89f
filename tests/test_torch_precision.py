"""The port's precision ladder against the JAX package's, on the CPU:
every split and quantized term is BIT-equal (both round to nearest even
when casting to bf16, and both round half to even in ``round``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro_torch.core import precision as tprec


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.standard_normal(512) * 10.0 ** rng.integers(-6, 6, 512),
        rng.uniform(-1, 1, 256),
        np.array([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-30, 0.5, 1.5, 2.5]),
    ]).astype(np.float32)
    return x


def _bits(x) -> np.ndarray:
    """Raw bit patterns of a torch or JAX bf16/f32 array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _same(t, j):
    tb, jb = _bits(t), _bits(j)
    assert tb.dtype == jb.dtype and tb.shape == jb.shape
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("seed", [0, 1])
def test_split2_split3_merge2_bit_equal(seed):
    x = _inputs(seed)
    t, j = tprec.split2(torch.from_numpy(x)), jprec.split2(jnp.asarray(x))
    for a, b in zip(t, j):
        _same(a, b)
    t3, j3 = tprec.split3(torch.from_numpy(x)), jprec.split3(jnp.asarray(x))
    for a, b in zip(t3, j3):
        _same(a, b)
    _same(tprec.merge2(*t), jprec.merge2(*j))


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_qdq_and_qdq_split2_bit_equal(fmt, scale):
    x = (np.random.default_rng(3).uniform(-1, 1, 4096) * scale).astype(np.float32)
    _same(tprec.qdq(torch.from_numpy(x), fmt), jprec.qdq(jnp.asarray(x), fmt))
    for a, b in zip(tprec.qdq_split2(torch.from_numpy(x), fmt),
                    jprec.qdq_split2(jnp.asarray(x), fmt)):
        _same(a, b)
    tq, ts = tprec.quantize_pow2(torch.from_numpy(x), fmt)
    jq, js = jprec.quantize_pow2(jnp.asarray(x), fmt)
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq, np.float32))


@pytest.mark.parametrize("policy", jprec.POLICIES)
def test_policy_terms_and_operand_terms_bit_equal(policy):
    assert tprec.num_passes(policy) == jprec.num_passes(policy)
    if policy == "f32":
        with pytest.raises(ValueError):
            tprec.policy_terms(policy)
        return
    assert tuple(tprec.policy_terms(policy)) == tuple(jprec.policy_terms(policy))
    rng = np.random.default_rng(7)
    a = rng.uniform(-2, 2, (16, 24)).astype(np.float32)
    b = rng.uniform(-2, 2, (24, 8)).astype(np.float32)
    ta, tb = tprec.operand_terms(torch.from_numpy(a), torch.from_numpy(b), policy)
    ja, jb = jprec.operand_terms(jnp.asarray(a), jnp.asarray(b), policy)
    assert len(ta) == len(ja) and len(tb) == len(jb)
    for x, y in zip(ta + tb, ja + jb):
        _same(x, y)


def test_qdq_is_straight_through():
    x = torch.linspace(-3, 3, 64, requires_grad=True)
    tprec.qdq(x, "int8").float().sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_policy_object_matches():
    for name in ("default", "attention", "mlp", "moe", "logits", "embed"):
        assert name in tprec.PrecisionPolicy._PRECISION_FIELDS
    p = tprec.PrecisionPolicy.mixed_hpc()
    q = jprec.PrecisionPolicy.mixed_hpc()
    for fam in ("attention", "mlp", "logits", "embed"):
        assert p.for_(fam) == q.for_(fam)
    with pytest.raises(ValueError):
        tprec.PrecisionPolicy(default="bf17")
