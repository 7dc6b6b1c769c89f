"""The port's dynamic loss scaling (``repro_torch.optim.loss_scale``) and
(hi, lo) bf16 master weights (``repro_torch.optim.dual_half``) against the
JAX package's, on the CPU, as ``tests/test_optim.py`` holds ``repro``'s.

Loss scaling: the same scale and good-step sequences over a fixed pattern
of finite and non-finite steps (halving, doubling after the growth
interval, the floor at 1), and the same unscaled gradients.  Dual-half:
the same (hi, lo) split of a param tree and a walk of 50 updates
bit-equal at every step; 100 tiny updates track an f32 master far closer
than plain bf16 weights would.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import dual_half as jdual
from repro.optim import loss_scale as jls
from repro_torch.core.tree import leaves
from repro_torch.optim import dual_half, loss_scale

# finite (1) and non-finite (0) steps: growth after 3 finite steps in a
# row, halvings down to and held at the floor of 1
PATTERN = [1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1]


def _bits(x) -> np.ndarray:
    """A bf16 / f32 tensor or array as its raw bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def test_scale_and_unscale_roundtrip():
    st = loss_scale.init(initial=1024.0, device="cpu")
    assert float(loss_scale.scale_loss(st, torch.tensor(2.0))) == 2048.0
    grads, finite = loss_scale.unscale_and_check(st, {"w": torch.tensor([1024.0, 2048.0])})
    assert grads["w"].tolist() == [1.0, 2.0] and bool(finite)
    assert st.scale.dtype == torch.float32 and st.good_steps.dtype == torch.int32


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_unscaled_gradients_and_flag_match_repro(bad):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32) * 3e4,
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for poison in (False, True):
        if poison:
            tree["b"]["c"][2] = bad
        st, jst = (loss_scale.init(initial=3.0 * 2 ** 12, device="cpu"),
                   jls.init(initial=3.0 * 2 ** 12))
        ours, t_fin = loss_scale.unscale_and_check(
            st, {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}})
        theirs, j_fin = jls.unscale_and_check(jst, jax.tree.map(jnp.asarray, tree))
        assert bool(t_fin) == bool(j_fin) == (not poison)
        for t, j in zip(leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("initial,interval", [(2.0 ** 15, 3), (4.0, 1), (1.0, 5)])
def test_scale_sequence_matches_repro(initial, interval):
    """update() over PATTERN: the same scale and good steps after every
    step, the scale never below 1."""
    st = loss_scale.init(initial=initial, growth_interval=interval, device="cpu")
    jst = jls.init(initial=initial, growth_interval=interval)
    seq, jseq = [], []
    for flag in PATTERN:
        st = loss_scale.update(st, bool(flag))
        jst = jls.update(jst, jnp.asarray(bool(flag)))
        seq.append((float(st.scale), int(st.good_steps)))
        jseq.append((float(jst.scale), int(jst.good_steps)))
    assert seq == jseq
    assert min(s for s, _ in seq) >= 1.0
    assert st.growth_interval == interval


def test_state_goes_to_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert loss_scale.init().scale.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            loss_scale.init()


def _tree(seed=2):
    rng = np.random.default_rng(seed)
    return {"w": rng.uniform(-2, 2, (16, 8)).astype(np.float32),
            "layers": [{"b": rng.uniform(-1, 1, 8).astype(np.float32)}] * 2,
            "s": rng.standard_normal(3).astype(np.float32) * 1e-3}


def _port_tree(tree):
    return {"w": torch.from_numpy(tree["w"]),
            "layers": [{"b": torch.from_numpy(x["b"])} for x in tree["layers"]],
            "s": torch.from_numpy(tree["s"])}


def _same(dual, jd):
    for t, j in zip(leaves(dual.hi) + leaves(dual.lo),
                    jax.tree.leaves(jd.hi) + jax.tree.leaves(jd.lo)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(t), _bits(j))


def test_split_and_merge_match_repro():
    tree = _tree()
    dual, jd = dual_half.to_dual(_port_tree(tree)), jdual.to_dual(jax.tree.map(jnp.asarray, tree))
    _same(dual, jd)
    rec, jrec = dual_half.from_dual(dual), jdual.from_dual(jd)
    for t, j, x in zip(leaves(rec), jax.tree.leaves(jrec), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(_bits(t), _bits(j))
        np.testing.assert_allclose(t.numpy(), x, rtol=0, atol=2 ** -14 * 2)


def test_a_walk_of_50_updates_is_bit_equal_to_repro():
    tree = _tree(4)
    rng = np.random.default_rng(5)
    dual, jd = dual_half.to_dual(_port_tree(tree)), jdual.to_dual(jax.tree.map(jnp.asarray, tree))
    for _ in range(50):
        upd = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32),
                           tree)
        dual = dual_half.apply_update(dual, _port_tree(upd))
        jd = jdual.apply_update(jd, jax.tree.map(jnp.asarray, upd))
        _same(dual, jd)


def test_apply_update_tracks_an_f32_master():
    """100 tiny updates through (hi, lo) track an f32 master far better
    than plain bf16 weights do (tests/test_optim.py's claim)."""
    rng = np.random.default_rng(3)
    w0 = rng.uniform(-1, 1, (64,)).astype(np.float32)
    updates = (rng.normal(size=(100, 64)) * 1e-4).astype(np.float32)
    master = w0.copy()
    dual = dual_half.to_dual({"w": torch.from_numpy(w0)})
    plain = torch.from_numpy(w0).to(torch.bfloat16)
    for u in updates:
        master += u
        dual = dual_half.apply_update(dual, {"w": torch.from_numpy(u)})
        plain = (plain.float() + torch.from_numpy(u)).to(torch.bfloat16)
    err_dual = np.abs(dual_half.from_dual(dual)["w"].numpy() - master).max()
    err_bf16 = np.abs(plain.float().numpy() - master).max()
    assert err_dual < err_bf16 / 4 and err_dual < 1e-3


def test_params_that_need_grad_split_without_a_graph():
    p = {"w": torch.ones(4, requires_grad=True)}
    dual = dual_half.to_dual(p)
    assert not dual.hi["w"].requires_grad and not dual.lo["w"].requires_grad
