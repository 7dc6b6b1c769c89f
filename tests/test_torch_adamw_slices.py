"""AdamW's sliced update and sliced global norm (``repro_torch.optim.adamw``,
``SLICE``) against the whole-leaf arithmetic and the JAX package's
``global_norm``, on the CPU.

An elementwise update cut into blocks of rows computes every element
with the same expression, so params and both moments must come out
bit-equal to the whole-leaf update, contiguous leaves and gradients or
not (a row block of a transposed leaf is a view: nothing is copied).
The norm's sum over blocks runs in another order: within 1e-6 relative
of ``repro``'s, and bit-equal to the whole-leaf sum for leaves no larger
than ``SLICE``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.core.tree import leaves, tree_map
from repro_torch.optim import adamw

# clip_norm far below the gradients' norm: the clip scales every step
CFG = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
                        clip_norm=0.5)


def _tree(seed):
    """A matrix, a 3-D stack, a vector, a transposed (non-contiguous)
    matrix and a scalar, odd sizes so blocks end mid-leaf."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return {"w": t(37, 53), "stack": t(3, 19, 23), "b": t(101),
            "wt": t(41, 29).t(), "s": t(1)[0]}


def _run(slice_elems, monkeypatch, *, grad_t=False):
    monkeypatch.setattr(adamw, "SLICE", slice_elems)
    params = _tree(0)
    state = adamw.init(params)
    for i in range(3):
        grads = tree_map(lambda x: 4.0 * x, _tree(10 + i))
        if grad_t:
            grads["w"] = grads["w"].t().contiguous().t()       # a non-contiguous gradient
        # the same global norm for both slicings: the update alone is compared
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
        params, state, m = adamw.step(CFG, state, params, grads, gnorm=gnorm)
        assert float(m["grad_norm"]) > CFG.clip_norm
    return params, state


@pytest.mark.parametrize("grad_t", [False, True])
def test_sliced_update_is_bit_equal_to_the_whole_leaf(monkeypatch, grad_t):
    p_whole, s_whole = _run(1 << 26, monkeypatch, grad_t=grad_t)
    p_cut, s_cut = _run(64, monkeypatch, grad_t=grad_t)
    assert not p_cut["wt"].is_contiguous()
    for a, b in zip(leaves((p_whole, s_whole.m, s_whole.v)), leaves((p_cut, s_cut.m, s_cut.v))):
        assert torch.equal(a, b)
    assert int(s_cut.step) == 3


def test_sliced_norm_matches_repro(monkeypatch):
    tree = _tree(3)
    monkeypatch.setattr(adamw, "SLICE", 100)     # every leaf over 100 elements cut
    got = float(adamw.global_norm(tree))
    want = float(jadamw.global_norm({k: jnp.asarray(v.numpy()) for k, v in tree.items()}))
    assert abs(got - want) <= 1e-6 * want


def test_small_leaves_keep_the_whole_leaf_sum():
    tree = _tree(4)
    assert all(x.numel() <= adamw.SLICE for x in leaves(tree))
    old = torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))
    assert torch.equal(adamw.global_norm(tree), old)


def test_step_without_gnorm_uses_the_sliced_norm(monkeypatch):
    monkeypatch.setattr(adamw, "SLICE", 64)
    params, grads = _tree(0), _tree(1)
    _, _, m = adamw.step(CFG, adamw.init(params), params, grads)
    assert torch.equal(m["grad_norm"], adamw.global_norm(grads))
