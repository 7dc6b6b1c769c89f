"""The port's WKV6 kernel module against the JAX package's, on the CPU.

``wkv6`` (its plain chunked version, the tensors lying on the CPU),
``wkv6_plain`` and the sequential oracle ``wkv6_ref`` are held against
``repro``'s Pallas ``wkv6`` in interpret mode and its ``wkv6_ref`` on the
same numpy inputs (``tests/test_kernels.py``'s recipe), and against
``repro.models.rwkv._wkv_chunked`` at ``policy="f32"``.  Tolerance: 1e-4
abs and rel, ``TestWKV6Kernel``'s: the chunked and sequential forms sum
the same f32 terms in other orders, and the decays pass through exp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as j_wkv6_ref
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro.models.rwkv import _wkv_chunked as j_wkv_chunked
from repro_torch.kernels import ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.models.rwkv import _wkv_chunked

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b=2, s=128, h=2, kd=64, seed=0, decay_scale=0.7):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, kd)).astype(np.float32) * 0.5 for _ in range(3))
    logw = -np.exp(rng.normal(size=(b, s, h, kd)).astype(np.float32) * 0.5 - decay_scale)
    u = rng.normal(size=(h, kd)).astype(np.float32) * 0.1
    return r, k, v, logw.astype(np.float32), u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("s,chunk", [(64, 64), (128, 64), (256, 32), (128, 128), (192, 96)])
def test_plain_and_ref_match_repro_kernel_and_oracle(s, chunk):
    xs = _inputs(s=s, seed=s + chunk)
    jo, js = j_wkv6(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    ro, rs = j_wkv6_ref(*map(jnp.asarray, xs))
    for fn in (lambda *a: wkv6(*a, chunk=chunk), lambda *a: wkv6_plain(*a, chunk=chunk),
               ref.wkv6_ref):
        out, st = fn(*_t(*xs))
        assert out.dtype == st.dtype == torch.float32
        assert tuple(out.shape) == xs[0].shape and tuple(st.shape) == (2, 2, 64, 64)
        for got in ((out, jo), (out, ro), (st, js), (st, rs)):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(got[1]), **TOL)


def test_strong_decay_numerics():
    """Fast-decaying channels (the regime the masked form keeps exact):
    finite, and the oracle's values."""
    xs = _inputs(seed=9, decay_scale=-1.5)
    out, _ = wkv6_plain(*_t(*xs), chunk=64)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(j_wkv6_ref(*map(jnp.asarray, xs))[0]),
                               **TOL)
    np.testing.assert_allclose(out.numpy(), ref.wkv6_ref(*_t(*xs))[0].numpy(), **TOL)


def test_matches_the_models_chunked_form_at_f32():
    """The kernel's chunked form == the model's routed chunked form,
    repro's and the port's, at ``policy="f32"``; a ragged S (100) goes
    through the model form's identity-step padding."""
    xs = _inputs(seed=3)
    jo, js = j_wkv_chunked(*map(jnp.asarray, xs[:4]), jnp.asarray(xs[4]), 32, policy="f32")
    out, st = wkv6_plain(*_t(*xs), chunk=32)
    to, ts = _wkv_chunked(*_t(*xs), 32, policy="f32")
    for a, b in ((out, jo), (st, js), (to, jo), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    ragged = [x[:, :100] for x in xs[:4]] + [xs[4]]
    jo, js = j_wkv_chunked(*map(jnp.asarray, ragged), 32, policy="f32")
    to, ts = _wkv_chunked(*_t(*ragged), 32, policy="f32")
    assert tuple(to.shape) == (2, 100, 2, 64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(to.numpy(), ref.wkv6_ref(*_t(*ragged))[0].numpy(), **TOL)


@pytest.mark.parametrize("fn", [wkv6, wkv6_plain])
def test_rejects_ragged_seq(fn):
    with pytest.raises(ValueError, match="multiple of chunk"):
        fn(*_t(*_inputs(s=100)), chunk=64)
    with pytest.raises(ValueError, match="u must be"):
        r, k, v, logw, u = _t(*_inputs(s=64))
        fn(r, k, v, logw, u[:1], chunk=64)
