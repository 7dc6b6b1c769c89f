"""The arithmetic of the port's chunk-parallel WKV6 kernels against the
JAX package's, on the CPU.

``wkv6_scan_plain`` is the arithmetic of ``csrc/wkv6.cu`` in torch ops:
per chunk its decay and state increment (A), the scan of the chunk states
(B; the state kernel does A and B in one walk over the chunks) and the
outputs by 16-step sub-blocks (C), the off-diagonal
scores factored so that every exponent is <= 0 and every product on TF32
operands at three passes (TF32 rounding emulated to nearest even on the
bit pattern).  It is held against ``repro``'s Pallas ``wkv6`` in
interpret mode and its sequential ``wkv6_ref`` on the same numpy inputs
(``tests/test_kernels.py``'s recipe) at 1e-4 abs and rel,
``TestWKV6Kernel``'s tolerance: the chunked and sequential forms sum the
same f32 terms in other orders and the decays pass through exp; the
3xTF32 split keeps ~21 significand bits of each product.  One TF32 pass
keeps ~11 and must land outside that bound, or the bound would not tell
the rungs apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as j_wkv6_ref
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro_torch.kernels import wkv6 as wk

TOL = dict(rtol=1e-4, atol=1e-4)
BOUND = 1e-4


def _inputs(b=1, s=128, h=2, kd=64, seed=0, decay_scale=0.7):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, kd)).astype(np.float32) * 0.5 for _ in range(3))
    logw = -np.exp(rng.normal(size=(b, s, h, kd)).astype(np.float32) * 0.5 - decay_scale)
    u = rng.normal(size=(h, kd)).astype(np.float32) * 0.1
    return r, k, v, logw.astype(np.float32), u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# every chunk the card tests take (16, 32, 64, 80, 96, 128) and one that 16
# does not divide (its last sub-block ragged)
CHUNKS = (16, 32, 40, 64, 80, 96, 128)


@pytest.mark.parametrize("kd", (16, 32, 64))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_scan_plain_matches_repro_kernel_and_oracle(chunk, kd):
    xs = _inputs(s=2 * chunk, kd=kd, seed=chunk + kd)
    jo, js = j_wkv6(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    ro, rs = j_wkv6_ref(*map(jnp.asarray, xs))
    out, st = wk.wkv6_scan_plain(*_t(*xs), chunk=chunk)
    assert out.dtype == st.dtype == torch.float32
    assert tuple(out.shape) == xs[0].shape and tuple(st.shape) == (1, 2, kd, kd)
    for got, want in ((out, jo), (out, ro), (st, js), (st, rs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scan_plain_strong_decay():
    """Fast-decaying channels (``decay_scale=-1.5``: la reaches ~-300 in a
    64-step chunk, where e^{-la} would overflow): finite, and the oracle's
    values."""
    xs = _inputs(b=2, seed=9, decay_scale=-1.5)
    out, st = wk.wkv6_scan_plain(*_t(*xs), chunk=64)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    ro, rs = j_wkv6_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("chunk,decay_scale", [(64, 0.7), (40, 0.7), (128, -1.5), (64, -1.5)])
def test_every_exponent_is_at_most_zero(chunk, decay_scale):
    """Before the clamp: each factor e^x of the design has x <= 0, so none
    overflows (the sequential cumulative sums are monotone)."""
    xs = _inputs(s=2 * chunk, seed=5, decay_scale=decay_scale)
    exps = wk.scan_exponents(torch.from_numpy(xs[3]), chunk)
    assert len(exps) > 2
    assert all(bool((e <= 0).all()) for e in exps)


def test_one_tf32_pass_misses_the_bound():
    """At B=1, S=512, H=8, K=64 (chunk 64) the model on one TF32 pass lands
    outside 1e-4 of the recurrence, and at three passes inside it."""
    xs = _inputs(b=1, s=512, h=8, kd=64, seed=1)
    ro, rs = (np.asarray(x) for x in j_wkv6_ref(*map(jnp.asarray, xs)))

    def err(passes):
        out, st = wk.wkv6_scan_plain(*_t(*xs), chunk=64, passes=passes)
        return max(np.abs(out.numpy() - ro).max(), np.abs(st.numpy() - rs).max())

    assert err(3) <= BOUND < err(1)


def test_tf32_round_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32 keeps 10 explicit significand bits
    x = torch.tensor([one + ulp / 2, one + 1.5 * ulp, -(one + ulp / 2), one + 0.75 * ulp,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one + 2 * ulp, -one, one + ulp, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(wk.tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    t = wk.tf32_round(y)
    assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((t - y).abs() <= y.abs() * 2.0 ** -11).all()
