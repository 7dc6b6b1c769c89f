"""The port's training path against the JAX package's, on the CPU.

Params come from ``repro``'s ``api.init_params`` (numpy) through
``repro_torch.convert.from_jax_numpy``; inputs are made from numpy seeds
and handed to both packages.  The port's kernel routes (``cuda`` /
``cuda_fused``) run their kernels' plain versions on CPU tensors, their
backward included; ``repro`` runs the twin routes, ``pallas`` /
``pallas_fused`` in interpret mode (its fused attention at the port's
32-row KV tile), and ``xla`` for the port's ``torch``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.ops import ExecutionPolicy as JExecutionPolicy
from repro.core.ops.gemm import routed_einsum as j_routed_einsum
from repro.core.ops.route import Route as JRoute
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JSyntheticLMDataset
from repro.kernels import attention_fused as jaf
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.runtime.train_step import make_loss_fn as j_make_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.convert import from_jax_numpy
from repro_torch.core.ops import registry
from repro_torch.core.ops.registry import LADDER_BOUNDS
from repro_torch.core.ops.gemm import routed_einsum
from repro_torch.core.ops.route import Route
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.kernels import attention_fused as taf
from repro_torch.launch.train import TrainLoop
from repro_torch.optim import adamw
from repro_torch.runtime.train_step import make_loss_fn, make_train_step

ROUTES = {"torch": {}, "kernels": {"gemm": "cuda", "attention": "cuda_fused"}}
J_ROUTES = {"torch": {}, "kernels": {"gemm": "pallas", "attention": "pallas_fused"}}

# f32 everywhere: the JAX suite's own bounds for fused-attention grads
# (tests/test_attention_fused.py), for every gradient here.
F32_ATOL, F32_RTOL = 1e-4, 1e-3
# Flash backward at the bf16 policy on f32 inputs: both packages split the
# same f32 values into the same bf16 terms, but the f32 sums run in
# another order, so a probability or ds can round to the neighbouring
# bf16 value in one of them (|grads| <= ~3 here).
FLASH_BF16_ATOL = 2e-2
# the flash gradients at the quantized rungs against repro's (see
# test_flash_attention_grads_match_repro)
QUANT_GRAD_TOL = {"fp8": 1e-3, "fp8x3": 1e-3, "int8x3": 2e-3}
# Routed-GEMM grads: the same bf16 terms multiplied exactly, f32 sums in
# another order over K <= 48 (|grads| <= ~20).
GEMM_ATOL = 1e-4
# One train step with bf16 activations: gradients are relative to each
# leaf's norm, loss and params absolute.  The packages round the same
# bf16 activations at the same points, but XLA's and PyTorch's f32 sums
# differ in order, so an activation can round to the neighbouring bf16
# value in one of them and carry that through the backward.
BF16_LOSS_ATOL = 2e-3
BF16_GRAD_REL = 5e-2
# Params after one AdamW step at bf16.  A first Adam step moves a
# coordinate by about lr * sign(g), so where the two packages' gradients
# differ in sign the params land 2 lr apart.  That can happen only where
# |g| is below the gradient difference: at most 1.4e-2 of the leaf's
# max |g| here.  Outside |g| < BF16_SIGN_SAFE * max |g| the params must
# agree to F32_ATOL (3e-7 measured); the steps of at most BF16_FLIP_FRAC
# of a leaf's coordinates may flip (4.9e-3 measured), and the mean
# difference stays under BF16_PARAM_MEAN_ATOL.
BF16_SIGN_SAFE = 5e-2
BF16_FLIP_FRAC = 2e-2
BF16_PARAM_MEAN_ATOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1)
SEQ, BATCH = 32, 2
_J_ADAMW_STEP = jax.jit(jadamw.step, static_argnums=0)
# repro's per-step compile options: round to bf16 wherever the code says so
EXACT_BF16 = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(japi.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      j_get_smoke("gemma3-1b"))


@pytest.fixture
def repro_kv_tile(monkeypatch):
    """repro's fused attention walks the KV sequence in the port's 32-row
    tiles, so both round probabilities against the same running max."""
    monkeypatch.setattr(jaf, "flash_attention",
                        functools.partial(jaf.flash_attention, block_kv=32))


def _cfgs(activation_dtype):
    return (dataclasses.replace(j_get_smoke("gemma3-1b"), activation_dtype=activation_dtype),
            dataclasses.replace(get_smoke("gemma3-1b"), activation_dtype=activation_dtype))


def _port_params(tree, tcfg):
    params = from_jax_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def _batch(vocab, seed=7):
    toks = np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


# ------------------------------------------------------------ flash backward

FLASH_CASES = {
    "causal": dict(causal=True, window=None, softcap=None),
    "window": dict(causal=True, window=20, softcap=None),
    "softcap": dict(causal=True, window=None, softcap=4.0),
}


def _oracle_flash_grads(q, k, v, do, *, causal, window, softcap):
    """dq, dk, dv of f64 softmax attention with the same masks."""
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v))
    s = torch.einsum("bqkgd,bskd->bkgqs", tq, tk)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(q.shape[1])[:, None]
    cols = torch.arange(k.shape[1])[None, :]
    keep = cols <= rows if causal else torch.ones_like(cols > rows)
    if causal and window is not None:
        keep = keep & (cols > rows - window)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, tv)
    return [g.numpy() for g in torch.autograd.grad(out, (tq, tk, tv),
                                                  torch.from_numpy(do).double())]


@pytest.mark.parametrize("policy", ["f32", "bf16", "bf16x6", "fp8", "int8", "fp8x3", "int8x3"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_grads_match_repro(case, policy):
    """dq, dk, dv of the port's ``flash_attention`` (the plain backward
    twin through ``_FlashAttention``) against ``repro``'s fused backward
    kernels in interpret mode, GQA with G = 4 over 2 kv heads."""
    rng = np.random.default_rng(11)
    b, s, kv, g, hd = 2, 72, 2, 4, 16
    q = (rng.uniform(-1, 1, (b, s, kv, g, hd)) * hd ** -0.5).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (b, s, kv, hd)).astype(np.float32) for _ in range(2))
    do = rng.uniform(-1, 1, (b, s, kv, g, hd)).astype(np.float32)
    kw = dict(FLASH_CASES[case], precision=policy)

    def jloss(q, k, v):
        return jnp.sum(jaf.flash_attention(q, k, v, block_kv=32, interpret=True, **kw)
                       * jnp.asarray(do))

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if policy == "int8":
        # repro's int8 backward does not run on XLA:CPU here (its DotThunk
        # has no bf16 x bf16 = f32); the f64 gradients stand in for it
        jgrads = _oracle_flash_grads(q, k, v, do, **FLASH_CASES[case])
    else:
        jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2))).lower(*args).compile(
            compiler_options=EXACT_BF16)(*args)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = taf.flash_attention(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, jg, tg in zip(("dq", "dk", "dv"), jgrads, tgrads):
        assert tg.shape == jg.shape and tg.dtype == torch.float32
        if policy in ("f32", "bf16x6"):      # the same f32 values or bf16 terms
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=F32_ATOL,
                                       rtol=F32_RTOL, err_msg=name)
        elif policy == "int8":      # against the f64 gradients: the rung's error
            assert np.abs(tg.numpy() - np.asarray(jg)).max() <= LADDER_BOUNDS[policy], name
        elif policy in QUANT_GRAD_TOL:
            # scales per tile (the port's 32-row backward tiles, repro's
            # BlockSpec blocks): the readings here reach 7.6e-6 (fp8), 6.1e-5
            # (fp8x3) and 1.4e-3 (int8x3); bf16 in place of a one-pass rung,
            # or one pass in place of x3, reads 2.4e-3 to 0.1
            assert np.abs(tg.numpy() - np.asarray(jg)).max() <= QUANT_GRAD_TOL[policy], name
        else:
            assert np.abs(tg.numpy() - np.asarray(jg)).max() <= FLASH_BF16_ATOL, name


def test_flash_attention_grads_keep_input_dtypes():
    q = torch.zeros(1, 40, 1, 2, 16, dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.zeros(1, 40, 1, 16, dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    grads = torch.autograd.grad(taf.flash_attention(q, k, v).sum(), (q, k, v))
    assert [x.dtype for x in grads] == [torch.bfloat16] * 3


# --------------------------------------------------------- routed-GEMM backward

GEMM_SPECS = {
    "linear": ("...i,io->...o", (2, 5, 24), (24, 40)),
    "unembed": ("...d,vd->...v", (2, 5, 48), (36, 48)),
}


def _gemm_grads(route_name, policy, spec, a, b, g):
    jroute = JRoute(precision=policy, backends=J_ROUTES[route_name], interpret=True)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    jda, jdb = jax.jit(lambda x, y, g: jax.vjp(
        lambda x, y: j_routed_einsum(spec, x, y, jroute), x, y)[1](g)).lower(*args).compile(
            compiler_options=EXACT_BF16)(*args)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    out = routed_einsum(spec, ta, tb, Route(precision=policy, backends=ROUTES[route_name]))
    tda, tdb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    return (np.asarray(jda), np.asarray(jdb)), (tda.numpy(), tdb.numpy())


@pytest.mark.parametrize("spec", list(GEMM_SPECS))
@pytest.mark.parametrize("route,policy", [
    *(("kernels", p) for p in ("bf16", "refine_a", "bf16x3", "refine_ab", "f32")),
    *(("torch", p) for p in ("bf16", "refine_a", "bf16x3", "refine_ab", "bf16x6", "f32")),
])
def test_routed_gemm_grads_match_repro(spec, route, policy):
    """dA/dB of ``cuda`` (through the plain kernel twins) against
    ``repro``'s ``pallas`` custom VJP, and of ``torch`` against ``xla``."""
    es, a_shape, b_shape = GEMM_SPECS[spec]
    rng = np.random.default_rng(len(spec) + len(policy))
    a = rng.uniform(-1, 1, a_shape).astype(np.float32)
    b = rng.uniform(-1, 1, b_shape).astype(np.float32)
    out_shape = a_shape[:-1] + (b_shape[1] if spec == "linear" else b_shape[0],)
    g = rng.uniform(-1, 1, out_shape).astype(np.float32)
    (jda, jdb), (tda, tdb) = _gemm_grads(route, policy, es, a, b, g)
    assert tda.shape == a.shape and tdb.shape == b.shape
    assert np.abs(tda - jda).max() <= GEMM_ATOL
    assert np.abs(tdb - jdb).max() <= GEMM_ATOL


def test_routed_gemm_backward_runs_the_route():
    """The backward contractions go to the route's impl at its rung."""
    calls = []
    impl = registry.get_impl("gemm", "cuda")
    fn = impl.fn
    try:
        object.__setattr__(impl, "fn", lambda a, b, *, policy: calls.append(policy) or fn(
            a, b, policy=policy))
        a = torch.ones(3, 4, requires_grad=True)
        b = torch.ones(4, 5, requires_grad=True)
        out = routed_einsum("mk,kn->mn", a, b, Route("bf16x3", {"gemm": "cuda"}))
        torch.autograd.grad(out.sum(), (a, b))
    finally:
        object.__setattr__(impl, "fn", fn)
    assert calls == ["bf16x3"] * 3


# ------------------------------------------------------------ train step

_J_GRAD_FNS: dict = {}


def _j_grad_fn(route, policy_name, activation_dtype, jparams, jbatch):
    """repro's loss and grads, compiled once per (route, rung, activations)
    for this module's batch shape, rounding to bf16 wherever the code
    says so.  Its callers hold repro's fused attention at the port's KV
    tile (``repro_kv_tile``)."""
    key = (route, policy_name, activation_dtype)
    if key not in _J_GRAD_FNS:
        jcfg, _ = _cfgs(activation_dtype)
        jpol = JExecutionPolicy(default=policy_name, backends=J_ROUTES[route], interpret=True)
        grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg, jpol), has_aux=True))
        _J_GRAD_FNS[key] = grad_fn.lower(jparams, jbatch).compile(compiler_options=EXACT_BF16)
    return _J_GRAD_FNS[key]


def _one_step(jparams, route, policy_name, activation_dtype):
    """(repro, port) results of one step on the same params and batch:
    loss metrics, the gradient tree and the params after AdamW."""
    _, tcfg = _cfgs(activation_dtype)
    tpol = execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route],
                                require={"gemm": ("vjp",), "attention": ("vjp",)})
    toks, labels = _batch(tcfg.vocab_size)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    # repro's make_train_step at one microbatch: its loss and grads, then
    # its AdamW step
    (_, jm), jgrads = _j_grad_fn(route, policy_name, activation_dtype, jparams, jbatch)(
        jparams, jbatch)
    jnew, _, jom = _J_ADAMW_STEP(jadamw.AdamWConfig(**OPT), jadamw.init(jparams), jparams,
                                 jgrads)

    tparams = _port_params(jparams, tcfg)
    loss, _ = make_loss_fn(tcfg, tpol)(tparams, tbatch)
    tgrads = torch.autograd.grad(loss, leaves(tparams))
    tnew, opt, tm = make_train_step(tcfg, adamw.AdamWConfig(**OPT), tpol)(
        tparams, adamw.init(tparams), tbatch)
    assert int(opt.step) == 1
    return (dict(jm, **jom), jgrads, jnew), (tm, tgrads, tnew, tcfg)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("activation_dtype", ["float32", "bfloat16"])
def test_train_step_matches_repro(jparams, repro_kv_tile, route, activation_dtype):
    """Loss, every gradient leaf (the flat layer list against the stacked
    tree) and the params after one AdamW step."""
    f32 = activation_dtype == "float32"
    (jm, jgrads, jnew), (tm, tgrads, tnew, tcfg) = _one_step(
        jparams, route, "f32" if f32 else "bf16", activation_dtype)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= (F32_ATOL if f32 else BF16_LOSS_ATOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=F32_RTOL if f32 else BF16_GRAD_REL)
    jg = dict(leaves_with_paths(from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")))
    assert list(jg) == [p for p, _ in leaves_with_paths(tnew)]
    for (path, ref), got in zip(jg.items(), tgrads):
        ref, got = ref.numpy(), got.numpy()
        if f32:
            np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=F32_RTOL, err_msg=path)
        else:
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= BF16_GRAD_REL, (path, rel)
    jp = dict(leaves_with_paths(from_jax_numpy(jax.tree.map(np.asarray, jnew), tcfg, "cpu")))
    p0 = dict(leaves_with_paths(from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")))
    lr, wd = OPT["lr"], 0.1
    for (path, ref), got in zip(jp.items(), leaves(tnew)):
        ref, got = ref.numpy(), got.detach().numpy()
        if path.startswith("layers/") and path.endswith("norm/scale"):
            # repro stacks each segment's norm scales into (count, d), so
            # its "ndim >= 2" rule decays them too; the port's are 1-D
            # vectors, which neither package means to decay.
            ref = ref + lr * wd * p0[path].numpy()
        diff = np.abs(got - ref)
        # A first Adam step moves a coordinate by lr * g / (|g| + eps):
        # where |g| is near eps, gradients that agree to F32_RTOL can
        # still give steps up to 2 lr apart.
        tiny = np.abs(jg[path].numpy()) < 1e-5
        if f32:
            assert diff.max() <= F32_ATOL + 2 * lr * tiny.any(), path
            assert (diff[~tiny] <= F32_ATOL).all(), path
        else:
            g = np.abs(jg[path].numpy())
            safe = g >= BF16_SIGN_SAFE * g.max()
            assert (diff[safe] <= F32_ATOL).all(), (path, diff[safe].max())
            assert (diff > F32_ATOL).mean() <= BF16_FLIP_FRAC, (path, (diff > F32_ATOL).mean())
            assert diff.mean() <= BF16_PARAM_MEAN_ATOL, (path, diff.mean())


def test_five_smoke_steps_match_repro(jparams, repro_kv_tile):
    """The loss over 5 smoke steps on the kernel routes at f32, each
    package training on its own twin of the same batches."""
    _, tcfg = _cfgs("float32")
    tpol = execution_policy_for(tcfg, default="f32", backends=ROUTES["kernels"])
    # no decay: repro decays its stacked norm scales (see above)
    opt_cfg = dict(lr=3e-3, warmup_steps=1, total_steps=5, weight_decay=0.0)
    data = dict(global_batch=BATCH, seq_len=SEQ, vocab_size=tcfg.vocab_size, seed=3)
    jds, tds = JSyntheticLMDataset(JDataConfig(**data)), SyntheticLMDataset(DataConfig(**data))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**opt_cfg), tpol)

    def jstep(params, opt, batch):
        """repro's make_train_step at one microbatch: loss and grads, then
        AdamW (each compiled once for the module)."""
        (_, m), grads = _j_grad_fn("kernels", "f32", "float32", params, batch)(params, batch)
        params, opt, om = _J_ADAMW_STEP(jadamw.AdamWConfig(**opt_cfg), opt, params, grads)
        return params, opt, dict(m, **om)

    jp, jo = jparams, jadamw.init(jparams)
    tp = _port_params(jparams, tcfg)
    to = adamw.init(tp)
    jl, tl = [], []
    for i in range(5):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in tds.batch(i).items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=F32_ATOL)


# ------------------------------------------------------------ data, restart

@pytest.mark.parametrize("seed,proc,nproc", [(0, 0, 1), (5, 1, 2)])
def test_synthetic_batches_are_bit_equal(seed, proc, nproc):
    cfg = dict(global_batch=4, seq_len=24, vocab_size=512, seed=seed)
    jds = JSyntheticLMDataset(JDataConfig(**cfg), proc=proc, nproc=nproc)
    tds = SyntheticLMDataset(DataConfig(**cfg), proc=proc, nproc=nproc)
    for i in (0, 1, 17):
        jb, tb = jds.batch(i), tds.batch(i)
        assert set(jb) == set(tb) == {"tokens", "labels"}
        for key in tb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


def _loop(ckpt_dir, tcfg, policy):
    return TrainLoop(tcfg, policy=policy,
                     opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0),
                     data_cfg=DataConfig(global_batch=2, seq_len=12,
                                         vocab_size=tcfg.vocab_size),
                     ckpt_dir=str(ckpt_dir), ckpt_every=5, remat=True, device="cpu")


@pytest.fixture
def one_thread():
    """Twenty smoke steps of small CPU ops: one thread runs them as fast
    as every core, and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_restart_is_bit_equal(tmp_path, one_thread):
    """Kill and restart: a run that crashes at step 5 and resumes from its
    checkpoint ends bit-equal to an uninterrupted 10-step run (the twin
    of tests/test_system.py's restart test), on the kernel routes."""
    tcfg = get_smoke("gemma3-1b")
    policy = execution_policy_for(tcfg, default="bf16", backends=ROUTES["kernels"],
                                  require={"gemm": ("vjp",), "attention": ("vjp",)})
    p_full, o_full, _ = _loop(tmp_path / "a", tcfg, policy).run(10, log_every=0)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        _loop(tmp_path / "b", tcfg, policy).run(10, log_every=0, fail_at_step=5)
    loop = _loop(tmp_path / "b", tcfg, policy)
    assert loop.mgr.latest_step() == 5
    p_res, o_res, hist = loop.run(10, log_every=0)
    assert len(hist) == 5
    for x, y in zip(leaves((p_full, o_full)), leaves((p_res, o_res))):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert int(o_full.step) == int(o_res.step) == 10


def test_route_without_vjp_fails_at_route_build(monkeypatch):
    impls = dict(registry._IMPLS["gemm"])
    monkeypatch.setitem(registry._IMPLS, "gemm", impls)
    registry.register_impl("gemm", "no_vjp", fused_policies=("bf16",))(lambda a, b, *, policy: a @ b)
    tcfg = get_smoke("gemma3-1b")
    with pytest.raises(ValueError, match="capability 'vjp'"):
        execution_policy_for(tcfg, backends={"gemm": "no_vjp"},
                             require={fam: ("vjp",) for fam in registry.families()})
    for fam, name in (("gemm", "cuda"), ("attention", "cuda_fused")):
        assert registry.get_impl(fam, name).capabilities.has("vjp")


def test_train_cli_on_cpu_and_cuda_without_a_card(capsys):
    from repro_torch.launch import train as train_cli
    args = ["--arch", "gemma3-1b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
            "--backend", "gemm=cuda", "--backend", "attention=cuda_fused"]
    train_cli.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "attention=cuda_fused gemm=cuda" in out and "trained 2 steps" in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            train_cli.main(args)


def test_serving_trained_params_builds_no_graph():
    from repro_torch.runtime import serve_step
    tcfg = get_smoke("gemma3-1b")
    params = TrainLoop(tcfg, policy=execution_policy_for(tcfg, backends=ROUTES["kernels"]),
                       opt_cfg=adamw.AdamWConfig(), data_cfg=DataConfig(2, 8, tcfg.vocab_size),
                       device="cpu").init_or_restore(0)[0]
    assert all(p.requires_grad for p in leaves(params))
    logits, cache = serve_step.make_prefill(
        tcfg, execution_policy_for(tcfg, backends=ROUTES["kernels"]), s_ctx=24)(
            params, {"tokens": torch.arange(2, 14)[None]})
    assert not logits.requires_grad
    assert not any(c.k.requires_grad for c in cache if c is not None)
