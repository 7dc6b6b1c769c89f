"""Training the port's recurrent stacks (rwkv6-7b's RWKV-6 and zamba2-7b's
Mamba-2 + shared attention) against the JAX package, on the CPU.

At the smoke configs with 8-step chunks (the WKV and SSD states carried
over four chunks of the 32-token batch), step 0's loss and every gradient
leaf are held against ``repro``'s ``jax.value_and_grad`` of its train loss
on both routes and at f32 and bf16 activations, and three smoke steps'
losses against ``repro``'s train step (``torch_train_testlib``).  The
comparisons run on slow-decay copies of the random init: its decays
(RWKV-6 ~0.6 a step, Mamba-2 e^(-0.7..-5.6)) forget the state within a
chunk, so a fault in the carried state would land under rounding.  The
control, the state reset at every chunk boundary, must land outside the
f32 bound.
"""

import numpy as np
import pytest

from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from torch_train_testlib import (assert_step0, init_tree, outside, repro_kv_tile,  # noqa: F401
                                 smoke_losses, split_chunks, step0)

ARCHS = ("rwkv6-7b", "zamba2-7b")
# both stacks carry their state over 8-step chunks
CHUNKS = {"rwkv6-7b": dict(rwkv_chunk=8), "zamba2-7b": dict(ssm_chunk=8)}
# slow-decay copies: RWKV-6's decay bias w0 at -4 (log decay -exp(-4) =
# -0.018 a step, 0.86 of the state kept over a chunk), Mamba-2's A from
# 0.01 to 0.1 and dt_bias -2 (dt ~ 0.13), as serve_zamba2 does on the card
RWKV_SLOW_W0 = -4.0
ZAMBA2_SLOW_A = (0.01, 0.1)
ZAMBA2_SLOW_DT_BIAS = -2.0


def _slow_decay(tree: dict) -> dict:
    """A copy of repro's param tree whose recurrent state decays slowly."""
    out = {k: v for k, v in tree.items()}
    for seg, seg_tree in tree.items():
        if not seg.startswith("seg"):
            continue
        out[seg] = {pos: dict(p) for pos, p in seg_tree.items()}
        for p in out[seg].values():
            if "w0" in p:
                p["w0"] = np.full_like(p["w0"], RWKV_SLOW_W0)
            if "a_log" in p:
                count, nh = p["a_log"].shape
                p["a_log"] = np.broadcast_to(np.log(np.linspace(
                    *ZAMBA2_SLOW_A, nh, dtype=np.float32)), (count, nh)).copy()
                p["dt_bias"] = np.full_like(p["dt_bias"], ZAMBA2_SLOW_DT_BIAS)
    return out


def _tree(arch):
    return _slow_decay(init_tree(arch))


def test_slow_decay_copies_keep_the_state_over_a_chunk():
    """The copies' per-step decay keeps most of the state over an 8-step
    chunk, where the random init's forgets it."""
    rw = _tree("rwkv6-7b")["seg0"]["pos0"]["w0"]
    assert np.exp(-np.exp(rw)).min() ** 8 > 0.8
    assert np.exp(-np.exp(init_tree("rwkv6-7b")["seg0"]["pos0"]["w0"])).max() ** 8 < 0.05
    z = _tree("zamba2-7b")["seg0"]["pos0"]
    dt = np.log1p(np.exp(z["dt_bias"]))                 # softplus at a zero input
    assert np.exp(-dt * np.exp(z["a_log"])).min() ** 8 > 0.8


@pytest.mark.parametrize("activation_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["torch", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_and_every_gradient_match_repro(repro_kv_tile, arch, route,
                                                   activation_dtype):
    assert_step0(step0(arch, _tree(arch), route, activation_dtype, **CHUNKS[arch]),
                 activation_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_smoke_steps_match_repro(repro_kv_tile, arch):
    jl, tl = smoke_losses(arch, _tree(arch), **CHUNKS[arch])
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_reset_control_lands_outside_the_bound(repro_kv_tile, monkeypatch, arch):
    """The port with its state reset at every chunk boundary, against
    repro's step 0 at f32 on the kernel routes: its loss and gradients land
    outside the bounds the port is held to."""
    tree = _tree(arch)
    if arch == "rwkv6-7b":      # (r, k, v, logw) chunked, then u, chunk
        real = R._wkv_chunked
        monkeypatch.setattr(R, "_wkv_chunked", lambda r, k, v, logw, u, chunk, policy="bf16": (
            split_chunks(real, (r, k, v, logw), chunk, u, chunk, policy=policy)))
    else:                       # (x, B, C, rel, dt) chunked, then chunk, policy
        real = S._ssd_chunked
        monkeypatch.setattr(S, "_ssd_chunked", lambda x, b, c, rel, dt, chunk, policy: (
            split_chunks(real, (x, b, c, rel, dt), chunk, chunk, policy)))
    s = step0(arch, tree, "kernels", "float32", **CHUNKS[arch])
    assert outside(s) > 10
    assert abs(s.t_loss - s.loss) > 1e-4
