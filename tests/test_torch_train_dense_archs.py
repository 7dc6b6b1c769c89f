"""Training starcoder2-15b and command-r-35b (dense configs) against the
JAX package, on the CPU.

At the smoke configs, step 0's loss and every gradient leaf are held
against ``repro``'s ``jax.value_and_grad`` of its train loss on both
routes, at f32 and bf16 activations, and three smoke steps' losses
against ``repro``'s train step (``torch_train_testlib``).  starcoder2's
six bias leaves are seeded non-zero in ``repro``'s tree first (init makes
them zero, so a dropped bias or a bias without a gradient would agree);
command-r trains its parallel block and its untied tables as they are.
"""

import numpy as np
import pytest

from torch_train_testlib import assert_step0, init_tree, smoke_losses, step0
from torch_train_testlib import repro_kv_tile  # noqa: F401

ARCHS = ("starcoder2-15b", "command-r-35b")
# starcoder2's biases: N(0, BIAS_SCALE^2), as its serve test seeds them
BIAS_SCALE = 0.5


def _seeded_biases(tree, rng):
    """A copy of repro's numpy tree with every ``b`` leaf drawn from
    N(0, BIAS_SCALE^2); the rest shared."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, BIAS_SCALE, np.shape(v)).astype(np.asarray(v).dtype)
                    if k == "b" else _seeded_biases(v, rng)) for k, v in tree.items()}
    return tree


def _tree(arch):
    tree = init_tree(arch)
    return _seeded_biases(tree, np.random.default_rng(3)) if arch == "starcoder2-15b" else tree


def test_starcoder2_biases_are_seeded():
    s = step0("starcoder2-15b", _tree("starcoder2-15b"), "torch", "float32")
    biases = [p for p in s.grads if p.endswith("/b")]
    assert len(biases) == 6 * 2         # six bias leaves in each of the smoke config's layers
    # every bias but the key projection's (blind to the softmax) gets a gradient
    assert all(np.abs(s.grads[p]).max() > 1e-6 for p in biases if not p.endswith("wk/b"))


@pytest.mark.parametrize("activation_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["torch", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_and_every_gradient_match_repro(repro_kv_tile, arch, route,
                                                   activation_dtype):
    assert_step0(step0(arch, _tree(arch), route, activation_dtype), activation_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_smoke_steps_match_repro(repro_kv_tile, arch):
    jl, tl = smoke_losses(arch, _tree(arch))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=1e-4)
