"""The port's MoE path against the JAX package's, on the CPU: the grouped
family, the MoE FFN's two dispatch layouts, and the Mixtral and DBRX
smoke models serving and training.

Inputs are made from numpy seeds (params from ``repro``'s
``init_params`` through ``from_jax_numpy``) and handed to both packages.
The port's ``cuda_grouped`` impl runs its kernels' plain versions on CPU
tensors, its backward included; ``repro`` runs the twin impls:
``pallas_grouped`` in interpret mode, and ``xla`` for the port's
``torch``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import ops as jops
from repro.core.ops import ExecutionPolicy as JExecutionPolicy
from repro.core.ops.tiles import TileConfig as JTileConfig
from repro.core.ops.tiles import align_group_counts as j_align_group_counts
from repro.kernels.gemm_grouped import tile_group_ids as j_tile_group_ids
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import api as japi
from repro.models import moe as JM
from repro.runtime import serve_step as jserve_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.convert import from_jax_numpy
from repro_torch.core import ops
from repro_torch.core.ops.registry import LADDER_BOUNDS
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api
from repro_torch.models import moe as M
from repro_torch.runtime import serve_step

# repro's twin of each port impl: torch = xla, cuda_grouped = pallas_grouped
IMPLS = {"torch": "xla", "cuda_grouped": "pallas_grouped"}
PROFILES = {"uniform": [6, 6, 6, 5], "skewed": [17, 3, 2, 1], "empty": [12, 0, 11, 0]}
RUNGS = ["bf16", "refine_a", "bf16x3", "refine_ab", "f32", "bf16x6"]
# The fp8 / int8 rungs scale per tile: the port per kernel tile (16 rows x
# 64 of x at bm 16, 64 x 128 of w; dW 64 x 32 of x^T and 32 x 128 of dy),
# repro per BlockSpec block; each is held to the rung's ladder bound of the
# f64 oracle, and to REPRO_TOL of the other.  The tiles differ along K, so
# int8 (whose step follows the scale) reads up to 0.018 (forward) from
# repro, int8x3 3.1e-4, e4m3 (scale-free within its range) 4.8e-7; the
# port computing bf16 in place of a one-pass rung, or one pass in place of
# x3, reads 0.014 to 0.27, int8x3 under a scale twice too large 2.3e-3.
LOWP_RUNGS = ["fp8", "int8", "fp8x3", "int8x3"]
REPRO_TOL = {"fp8": 1e-3, "int8": 4e-2, "fp8x3": 1e-3, "int8x3": 1e-3}
BM = 16
# The two packages multiply the same bf16 terms (or f32 values) exactly
# and sum them in f32 in another order: over K = 130 with |terms| <= 1
# (measured at most 2.9e-6 on every profile and rung).
SUM_ORDER_ATOL = 2e-5
# Model logits and losses with f32 activations (the serve and train tests'
# bound for f32 paths; the Mixtral and DBRX smoke logits read 2.6e-6).
F32_ATOL = 1e-4
# bf16 activations, XLA's excess precision off: both packages round the
# same values to bf16 at the same points (the Mixtral smoke logits read
# 2.4e-7, |logits| <= 4.2); an f32 sum in another order can still land on
# the neighbouring bf16 value now and then (the gemma3 serve test's bound).
BF16_LOGITS_ATOL = 5e-2
# Gradients at the bf16 policy, relative to each leaf's norm: the same
# terms, sums in another order (the train test's bound).
BF16_GRAD_REL = 5e-2
# repro's per-step compile options: round to bf16 wherever the code says so
EXACT_BF16 = {"xla_allow_excess_precision": False}
S_CTX = 48


def _jroute(policy, impl, bm=BM):
    return jops.Route(precision=policy, backends={"grouped": impl},
                      tiles=JTileConfig(bm, 128, 128), interpret=True)


def _layout(sizes, d=130, f=50, seed=0):
    """Sorted, BM-aligned buffer (padding rows zero), weights, offsets and
    the valid-row mask, as numpy."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(
        j_align_group_counts(np.asarray(sizes), BM))]).astype(np.int32)
    x = np.zeros((int(offsets[-1]), d), np.float32)
    valid = np.zeros(int(offsets[-1]), bool)
    w = rng.uniform(-1, 1, (len(sizes), d, f)).astype(np.float32)
    for g, sz in enumerate(sizes):
        x[offsets[g]:offsets[g] + sz] = rng.uniform(-1, 1, (sz, d))
        valid[offsets[g]:offsets[g] + sz] = True
    return x, w, offsets, valid


def _oracle(x, w, offsets):
    out = np.zeros((x.shape[0], w.shape[2]))
    for g in range(w.shape[0]):
        out[offsets[g]:offsets[g + 1]] = (x[offsets[g]:offsets[g + 1]].astype(np.float64)
                                          @ w[g].astype(np.float64))
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ================================================= layout and dispatch

@pytest.mark.parametrize("bm", [8, 16, 128])
def test_align_and_tile_group_ids_are_repro_s(bm):
    for counts in ([0, 5, 17, 0], [16, 16, 1, 0], [0, 0, 0, 3], [129, 0, 2]):
        c = np.asarray(counts)
        got = ops.align_group_counts(_t(c), bm).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_align_group_counts(jnp.asarray(c), bm)))
        np.testing.assert_array_equal(ops.align_group_counts(c, bm), got)
        off = np.concatenate([[0], np.cumsum(got)]).astype(np.int32)
        off_zero = np.concatenate([off[:2], off[1:]])     # a zero-width group
        for o in (off, off_zero):
            n_rows = int(o[-1]) + 2 * bm + 5
            np.testing.assert_array_equal(
                gg.tile_group_ids(_t(o), n_rows, bm).numpy(),
                np.asarray(j_tile_group_ids(jnp.asarray(o), n_rows, bm)))


def _moe_params(seed=0, e=4, d=32, d_ff=48, mlp_kind="swiglu", starve=None, favour=None):
    """repro's init_moe (numpy leaves); ``starve`` an expert no token
    picks, ``favour`` one every token picks first."""
    import jax.random as jr
    p = jax.tree.map(np.asarray, JM.init_moe(jr.PRNGKey(seed), d, d_ff, e, mlp_kind))
    w = p["router"]["w"].copy()
    if starve is not None:
        w[:, starve] = -10.0
    if favour is not None:
        w[:] = 0.0
        w[:, favour] = 5.0
    p["router"]["w"] = w
    return p


def _tparams(p):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), p)


def _x(shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_sorted_dispatch_is_repro_s(monkeypatch):
    """The buffer, offsets and alignment the sorted path hands the grouped
    family are bit-equal to repro's, an unpicked expert (count 0)
    included; so is the FFN's output to f32 sum order."""
    import repro_torch.core.ops as tops
    p = _moe_params(starve=3)
    x = _x((2, 8, 32))                                # T*k = 32: bm 32 in both
    got = {"j": [], "t": []}

    def spy(store, fn):
        def wrapped(xs, w, offsets, **kw):
            store.append((np.asarray(xs), np.asarray(offsets)))
            return fn(xs, w, offsets, **kw)
        return wrapped

    monkeypatch.setattr(jops, "grouped_matmul", spy(got["j"], jops.grouped_matmul))
    monkeypatch.setattr(tops, "grouped_matmul", spy(got["t"], tops.grouped_matmul))
    kw = dict(num_experts=4, top_k=2, capacity_factor=1.25, mlp_kind="swiglu")
    jout, jaux = JM.moe_ffn(p, jnp.asarray(x), policy=JExecutionPolicy(
        default="f32", backends={"grouped": "pallas_grouped"}, interpret=True).for_("moe"), **kw)
    tout, taux = M.moe_ffn(_tparams(p), _t(x), policy=ops.ExecutionPolicy(
        default="f32", backends={"grouped": "cuda_grouped"}).for_("moe"), **kw)
    assert len(got["j"]) == len(got["t"]) == 3
    for i, ((jxs, joff), (txs, toff)) in enumerate(zip(got["j"], got["t"])):
        np.testing.assert_array_equal(toff, joff)
        if i < 2:       # wi, wg: the dispatch buffer itself
            np.testing.assert_array_equal(txs, jxs)
        else:           # wo: the activated hidden rows, in the same layout
            np.testing.assert_allclose(txs, jxs, atol=SUM_ORDER_ATOL)
            assert ((txs == 0) == (jxs == 0)).all()
    assert np.diff(got["t"][0][1])[3] == 32          # the starved expert: one tile
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=SUM_ORDER_ATOL)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)


# ======================================================= grouped family

@pytest.mark.parametrize("policy", RUNGS)
@pytest.mark.parametrize("profile", list(PROFILES))
def test_grouped_matmul_matches_repro(profile, policy):
    """Each port impl against its repro twin, both within the rung's
    ladder bound of the f64 oracle; padding rows come back zero."""
    x, w, off, valid = _layout(PROFILES[profile])
    oracle = _oracle(x, w, off)
    for impl, jimpl in IMPLS.items():
        jout = np.asarray(jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(off),
                                              policy=_jroute(policy, jimpl)))
        tout = ops.grouped_matmul(_t(x), _t(w), _t(off), bm=BM,
                                  policy=ops.Route(policy, {"grouped": impl})).numpy()
        assert tout.shape == jout.shape and tout.dtype == np.float32
        for out in (tout, jout):
            assert np.abs(out - oracle)[valid].max() < LADDER_BOUNDS[policy], (impl, policy)
        np.testing.assert_allclose(tout, jout, atol=SUM_ORDER_ATOL, err_msg=impl)
        assert not tout[~valid].any()


def test_padding_rows_do_not_leak():
    """Garbage in padding rows reaches no valid row (twin of repro's
    ``test_padding_rows_do_not_leak``)."""
    x, w, off, valid = _layout(PROFILES["uniform"])
    noisy = x.copy()
    noisy[~valid] = 1e3                     # violate the zero padding on purpose
    for policy in ("f32", "bf16"):
        route = ops.Route(policy, {"grouped": "cuda_grouped"})
        clean = ops.grouped_matmul(_t(x), _t(w), _t(off), policy=route, bm=BM).numpy()
        dirty = ops.grouped_matmul(_t(noisy), _t(w), _t(off), policy=route, bm=BM).numpy()
        np.testing.assert_array_equal(clean[valid], dirty[valid])


def test_cuda_grouped_refuses_unfused_rungs_at_route_build():
    """cuda_grouped declares every rung repro's pallas_grouped declares and
    fuses each in its kernels (f32 included: no ``torch`` fallback), so a
    route refuses none; an alignment the kernel cannot serve still
    raises."""
    from repro_torch.core.ops import registry
    caps = registry.get_impl("grouped", "cuda_grouped").capabilities
    assert caps.policies == caps.fused_policies == registry.ALL_POLICIES
    for rung in ("bf16x6", "fp8x3", "int8", "f32"):
        pol = ops.ExecutionPolicy(default="bf16", moe=rung, backends={"grouped": "cuda_grouped"})
        assert pol.for_("moe").impl("grouped") == "cuda_grouped"
    with pytest.raises(ValueError, match="multiple of 16"):
        gg.grouped_gemm(torch.zeros(8, 4), torch.zeros(1, 4, 4),
                        torch.tensor([0, 8], dtype=torch.int32), bm=8)


@pytest.mark.parametrize("policy", LOWP_RUNGS)
def test_grouped_quantized_rungs_match_repro(policy, monkeypatch):
    """Forward, dx and dW of ``cuda_grouped`` at the fp8 / int8 rungs (the
    kernels' plain twins) against ``pallas_grouped`` and the f64 oracle;
    the f32 ``torch`` reference never runs."""
    monkeypatch.setattr(ops.grouped, "_torch_grouped_matmul",
                        lambda *a, **k: pytest.fail("torch reference"))
    x, w, off, valid = _layout(PROFILES["skewed"], d=72, f=40)
    gy = _x((x.shape[0], 40), seed=4) * valid[:, None]
    bound = LADDER_BOUNDS[policy]
    oracle = _oracle(x, w, off)
    jout = np.asarray(jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(off),
                                          policy=_jroute(policy, "pallas_grouped")))

    def jloss(x, w):
        out = jops.grouped_matmul(x, w, jnp.asarray(off),
                                  policy=_jroute(policy, "pallas_grouped"))
        return (out * jnp.asarray(gy)).sum()

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    out = ops.grouped_matmul(tx, tw, _t(off), bm=BM,
                             policy=ops.Route(policy, {"grouped": "cuda_grouped"}))
    tdx, tdw = torch.autograd.grad((out * _t(gy)).sum(), (tx, tw))
    odx = np.zeros_like(x, dtype=np.float64)
    odw = np.zeros(w.shape)
    for g in range(w.shape[0]):
        sl = slice(int(off[g]), int(off[g + 1]))
        odx[sl] = gy[sl].astype(np.float64) @ w[g].T.astype(np.float64)
        odw[g] = x[sl].T.astype(np.float64) @ gy[sl].astype(np.float64)
    for name, t, j, o in (("out", out.detach().numpy(), jout, oracle),
                          ("dx", tdx.numpy(), np.asarray(jdx), odx),
                          ("dw", tdw.numpy(), np.asarray(jdw), odw)):
        assert t.shape == j.shape and np.isfinite(t).all(), name
        for got in (t, j):
            assert np.abs(got - o).max() <= bound, (name, policy)
        assert np.abs(t - j).max() <= REPRO_TOL[policy], (name, policy)
    assert not out.detach().numpy()[~valid].any()


@pytest.mark.parametrize("policy", ["bf16", "refine_ab", "f32", "bf16x6"])
def test_grouped_grads_match_repro(policy):
    """dx and dW through the port's autograd (the dx and dW kernels' plain
    twins) against ``jax.grad`` on ``pallas_grouped``; the dW block of a
    zero-width group (offsets repeat) is exactly 0 in both."""
    x, w, off, _ = _layout(PROFILES["skewed"], d=72, f=40)
    off = np.concatenate([off[:2], off[1:]]).astype(np.int32)     # group 1 empty
    w = np.concatenate([w[:1], w[:1] * 0.5, w[1:]])
    gy = _x((x.shape[0], 40), seed=4)

    def jloss(x, w):
        out = jops.grouped_matmul(x, w, jnp.asarray(off),
                                  policy=_jroute(policy, "pallas_grouped"))
        return (out * jnp.asarray(gy)).sum()

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    out = ops.grouped_matmul(tx, tw, _t(off), bm=BM,
                             policy=ops.Route(policy, {"grouped": "cuda_grouped"}))
    tdx, tdw = torch.autograd.grad((out * _t(gy)).sum(), (tx, tw))
    # |terms| <= 1 over runs of <= 32 rows (dW) and K = 40 (dx)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=SUM_ORDER_ATOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), atol=SUM_ORDER_ATOL)
    assert not tdw[1].any() and not np.asarray(jdw)[1].any()


# ====================================================== MoE FFN

def _jffn(p, x, grouped, **kw):
    pol = JExecutionPolicy(default="f32", backends={"grouped": grouped} if grouped else {},
                           interpret=True).for_("moe")
    out, aux = JM.moe_ffn(p, jnp.asarray(x), policy=pol, **kw)
    return np.asarray(out), float(aux)


def _tffn(p, x, grouped, **kw):
    pol = ops.ExecutionPolicy(default="f32",
                              backends={"grouped": grouped} if grouped else {}).for_("moe")
    out, aux = M.moe_ffn(_tparams(p), _t(x), policy=pol, **kw)
    return out.numpy(), float(aux)


def test_capacity_path_drops_what_repro_drops():
    """At capacity_factor 1.25 with every token on expert 0 first, the
    reference path drops overflow assignments, the same ones as repro's
    ``xla`` path; the sorted path drops none."""
    p = _moe_params(favour=0)
    x = _x((2, 6, 32))
    kw = dict(num_experts=4, top_k=2, capacity_factor=1.25, mlp_kind="swiglu")
    t_cap, t_aux = _tffn(p, x, None, **kw)
    j_cap, j_aux = _jffn(p, x, None, **kw)
    np.testing.assert_allclose(t_cap, j_cap, atol=SUM_ORDER_ATOL)
    t_full, _ = _tffn(p, x, None, dropless=True, **kw)
    t_grp, _ = _tffn(p, x, "cuda_grouped", **kw)
    assert np.abs(t_cap - t_full).max() > 0.05          # something was dropped
    np.testing.assert_allclose(t_grp, t_full, atol=SUM_ORDER_ATOL)
    assert t_aux == pytest.approx(j_aux, abs=1e-6)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu", "squared_relu"])
def test_sorted_equals_dropless_capacity(mlp_kind):
    p = _moe_params(mlp_kind=mlp_kind)
    x = _x((2, 6, 32))
    kw = dict(num_experts=4, top_k=2, capacity_factor=4.0, mlp_kind=mlp_kind)
    out_ref, aux_ref = _tffn(p, x, None, **kw)
    out_grp, aux_grp = _tffn(p, x, "cuda_grouped", **kw)
    np.testing.assert_allclose(out_grp, out_ref, atol=SUM_ORDER_ATOL)
    assert aux_grp == aux_ref
    j_out, _ = _jffn(p, x, "pallas_grouped", **kw)
    np.testing.assert_allclose(out_grp, j_out, atol=SUM_ORDER_ATOL)


def test_dropless_decode_does_not_depend_on_the_batch():
    p = _moe_params()
    x = _x((3, 1, 32))
    kw = dict(num_experts=4, top_k=2, capacity_factor=1.0, mlp_kind="swiglu")
    both, _ = _tffn(p, x, "cuda_grouped", **kw)
    for i in range(3):
        solo, _ = _tffn(p, x[i:i + 1], "cuda_grouped", **kw)
        np.testing.assert_array_equal(both[i], solo[0])


@pytest.mark.parametrize("top_k", [1, 3])
def test_other_top_k_match_repro(top_k):
    """k = 1 and k = 3 (contributions summed by ascending expert, as
    repro's scatter adds them) on both dispatch layouts."""
    p = _moe_params(e=4)
    x = _x((2, 5, 32))
    kw = dict(num_experts=4, top_k=top_k, capacity_factor=4.0, mlp_kind="swiglu")
    for impl, jimpl in IMPLS.items():
        t_out, t_aux = _tffn(p, x, None if impl == "torch" else impl, **kw)
        j_out, j_aux = _jffn(p, x, None if impl == "torch" else jimpl, **kw)
        np.testing.assert_allclose(t_out, j_out, atol=SUM_ORDER_ATOL, err_msg=impl)
        assert t_aux == pytest.approx(j_aux, abs=1e-6)


# ============================================= Mixtral and DBRX smoke models

ROUTES = {"torch": {}, "grouped": {"grouped": "cuda_grouped"}}
J_ROUTES = {"torch": {}, "grouped": {"grouped": "pallas_grouped"}}


@pytest.fixture(scope="module")
def jparams():
    init = jax.jit(japi.init_params, static_argnums=1)
    return {arch: jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), j_get_smoke(arch)))
            for arch in ("mixtral-8x7b", "dbrx-132b")}


def _cfgs(arch, activation_dtype):
    return (dataclasses.replace(j_get_smoke(arch), activation_dtype=activation_dtype),
            dataclasses.replace(get_smoke(arch), activation_dtype=activation_dtype))


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)(*args)


def _logits(jtree, arch, policy, activation_dtype, route, decode_steps=2):
    """(jax, port) logits of a 20-token prefill (past Mixtral's window of
    16) and decode steps at per-row positions, on twin routes."""
    jcfg, tcfg = _cfgs(arch, activation_dtype)
    tparams = from_jax_numpy(jtree, tcfg, "cpu")
    jpol = JExecutionPolicy(default=policy, backends=J_ROUTES[route], interpret=True)
    tpol = execution_policy_for(tcfg, default=policy, backends=ROUTES[route])
    toks = np.random.default_rng(5).integers(2, tcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache = _exact(jserve_step.make_prefill(jcfg, jpol, s_ctx=S_CTX), jtree,
                        {"tokens": jnp.asarray(toks)})
    tl, tcache = serve_step.make_prefill(tcfg, tpol, s_ctx=S_CTX)(
        tparams, {"tokens": _t(toks).long()})
    pairs = [(np.asarray(jl), tl.numpy())]
    jdecode, tdecode = jserve_step.make_decode(jcfg, jpol), serve_step.make_decode(tcfg, tpol)
    pos = np.array([20, 20], np.int32)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(decode_steps):
        jl, jcache = _exact(jdecode, jtree, jcache, jnp.asarray(nxt)[:, None], jnp.asarray(pos))
        tl, tcache = tdecode(tparams, tcache, _t(nxt).long()[:, None], _t(pos))
        pairs.append((np.asarray(jl), tl.numpy()))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1
    return pairs


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("activation_dtype", ["float32", "bfloat16"])
def test_mixtral_logits_match_repro(jparams, route, activation_dtype):
    """Prefill (capacity 1.25 on the reference path, which drops here too)
    and dropless decode logits, f32 policy on f32 activations and the
    bf16 policy on bf16 activations."""
    f32 = activation_dtype == "float32"
    pairs = _logits(jparams["mixtral-8x7b"], "mixtral-8x7b", "f32" if f32 else "bf16",
                    activation_dtype, route)
    for jl, tl in pairs:
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= (F32_ATOL if f32 else BF16_LOGITS_ATOL)
        assert (jl[:, -1].argmax(-1) == tl[:, -1].argmax(-1)).all()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("activation_dtype", ["float32", "bfloat16"])
def test_dbrx_logits_match_repro(jparams, route, activation_dtype):
    """DBRX's smoke model (full attention, no window; 16 experts, top-4 at
    full size), the f32 policy on f32 activations and the bf16 policy on
    bf16 activations, as Mixtral's test holds them."""
    f32 = activation_dtype == "float32"
    for jl, tl in _logits(jparams["dbrx-132b"], "dbrx-132b", "f32" if f32 else "bf16",
                          activation_dtype, route, decode_steps=1):
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= (F32_ATOL if f32 else BF16_LOGITS_ATOL)
        assert (jl[:, -1].argmax(-1) == tl[:, -1].argmax(-1)).all()


MOE_ARCHS = ["mixtral-8x7b", "dbrx-132b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_staggered_f32_serve_is_token_exact_against_repro(jparams, arch):
    """Continuous batching on cuda_grouped against repro's engine on
    pallas_grouped (twin of repro's staggered grouped-serve test): the
    same tokens for every request."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jpol = JExecutionPolicy(default="f32", backends=J_ROUTES["grouped"], interpret=True)
    tpol = execution_policy_for(tcfg, default="f32", backends=ROUTES["grouped"],
                                require={"attention": ("decode",)})
    rng = np.random.default_rng(17)
    prompts = [rng.integers(2, tcfg.vocab_size, 4 + (i % 2)).astype(np.int32) for i in range(3)]
    budgets = [3 + (i % 2) for i in range(3)]
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=24, policy=jpol)
    jeng.load(jax.tree.map(jnp.asarray, jparams[arch]))
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jeng.run(jreqs)
    teng = ServeEngine(tcfg, batch_size=2, max_ctx=24, policy=tpol, device="cpu")
    teng.load(from_jax_numpy(jparams[arch], tcfg, "cpu"))
    treqs = [Request(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    teng.run(treqs)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_train_step0_matches_repro(jparams, policy):
    """Step 0 on the Mixtral smoke model, grouped route, f32 activations:
    total loss, LM loss, aux loss and every gradient leaf against repro's
    ``loss_fn`` (through ``from_jax_numpy``, which flattens the (count,
    E, D, F) expert stacks)."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", "float32")
    jtree = jparams["mixtral-8x7b"]
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 33)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    jpol = JExecutionPolicy(default=policy, backends=J_ROUTES["grouped"], interpret=True)

    def jloss(p):
        return japi.loss_fn(p, jbatch, jcfg, policy=jpol, remat=True)

    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jtree))
    tparams = from_jax_numpy(jtree, tcfg, "cpu")
    for p in leaves(tparams):
        p.requires_grad_(True)
    tpol = execution_policy_for(tcfg, default=policy, backends=ROUTES["grouped"])
    ttotal, tm = api.loss_fn(tparams, {"tokens": _t(toks[:, :-1]).long(),
                                       "labels": _t(toks[:, 1:]).long()},
                             tcfg, policy=tpol, remat=True)
    tgrads = torch.autograd.grad(ttotal, leaves(tparams))
    for key, j, t in (("total", jtotal, ttotal), ("loss", jm["loss"], tm["loss"]),
                      ("aux", jm["aux_loss"], tm["aux_loss"])):
        assert abs(float(t) - float(j)) <= F32_ATOL, key
    assert float(tm["aux_loss"]) > 0
    jg = dict(leaves_with_paths(from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")))
    assert list(jg) == [p for p, _ in leaves_with_paths(tparams)]
    for (path, ref), got in zip(jg.items(), tgrads):
        ref, got = ref.numpy(), got.numpy()
        if policy == "f32":
            np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=1e-3, err_msg=path)
        else:
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= BF16_GRAD_REL, (path, rel)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_paged_moe_serve_matches_repro_and_dense(jparams, arch):
    """Paged KV serves the MoE family too: the attention sublayers read
    4-row pages (Mixtral's are ring layers, window 16 < 24; DBRX's attend
    to the whole context), the MoE sublayers hold nothing.  An f32
    staggered paged engine on cuda_grouped emits repro's paged engine's
    tokens and the port's dense engine's, and frees every page."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jpol = JExecutionPolicy(default="f32", backends=J_ROUTES["grouped"], interpret=True)
    tpol = execution_policy_for(tcfg, default="f32", backends=ROUTES["grouped"],
                                require={"attention": ("decode", "paged_decode")})
    rng = np.random.default_rng(19)
    prompts = [rng.integers(2, tcfg.vocab_size, 4 + 7 * (i % 2)).astype(np.int32)
               for i in range(3)]
    budgets = [9, 4, 6]
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=24, policy=jpol, kv_layout="paged",
                        kv_page_size=4)
    jeng.load(jax.tree.map(jnp.asarray, jparams[arch]))
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jeng.run(jreqs)
    tparams = from_jax_numpy(jparams[arch], tcfg, "cpu")
    outs = {}
    for layout in ("paged", "dense"):
        teng = ServeEngine(tcfg, batch_size=2, max_ctx=24, policy=tpol, device="cpu",
                           kv_layout=layout, kv_page_size=4)
        teng.load(tparams)
        treqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, budgets))]
        teng.run(treqs)
        assert all(r.done for r in treqs) and teng.pages_outstanding() == 0
        outs[layout] = [r.out_tokens for r in treqs]
    assert outs["paged"] == outs["dense"] == [r.out_tokens for r in jreqs]
