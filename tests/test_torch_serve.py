"""The port's gemma3 serving path against the JAX package's, on the CPU.

Params come from ``repro``'s ``api.init_params`` (numpy) through
``repro_torch.convert.from_jax_numpy``, so both packages compute the same
function.  The port runs both its ``torch`` reference routes and its
kernel routes (``cuda`` / ``cuda_fused``: the kernels' plain versions on
CPU tensors); ``repro`` runs the twin of each: ``xla``, and ``pallas`` /
``pallas_fused`` in interpret mode.
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
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import api as japi
from repro.runtime import serve_step as jserve_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for, layer_kinds
from repro_torch.convert import from_jax_numpy
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api
from repro_torch.runtime import serve_step

ROUTES = {"torch": {}, "kernels": {"gemm": "cuda", "attention": "cuda_fused"}}
# repro's twin of each route (impl names: torch=xla, cuda=pallas,
# cuda_fused=pallas_fused).
J_ROUTES = {"torch": {}, "kernels": {"gemm": "pallas", "attention": "pallas_fused"}}
F32_ATOL = 1e-4
# bf16 activations: both packages round the same values at the same
# points.  XLA's CPU compiler by default keeps excess f32 precision where
# the JAX code rounds to bf16, which alone moved the logits by up to
# 0.064; repro's steps are therefore compiled with that option off.
# Measured maxima over prefill + 3 decode steps, |logits| <= 3.02:
# bf16 2.4e-7 on both routes; refine_ab 0.0083 (torch) and 0.031
# (kernels: the attention kernels sum the small hi/lo terms in their own
# accumulator, so a probability or an output now and then rounds to the
# neighbouring bf16 value).  The greedy tokens agree in every case.
BF16_ATOL = 5e-2
S_CTX = 48
# repro's per-step compile options: round to bf16 wherever the code says so
EXACT_BF16 = {"xla_allow_excess_precision": False}


def _cfgs(activation_dtype):
    jcfg = dataclasses.replace(j_get_smoke("gemma3-1b"),
                               activation_dtype=activation_dtype)
    tcfg = dataclasses.replace(get_smoke("gemma3-1b"),
                               activation_dtype=activation_dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jparams():
    return japi.init_params(jax.random.PRNGKey(0), j_get_smoke("gemma3-1b"))


@pytest.fixture
def repro_kv_tile(monkeypatch):
    """repro's fused attention kernels walk the KV sequence in the port's
    32-row tiles, so both round the probabilities against the same
    running max."""
    import repro.kernels.attention_fused as jaf
    monkeypatch.setattr(jaf, "flash_attention",
                        functools.partial(jaf.flash_attention, block_kv=32))
    monkeypatch.setattr(jaf, "flash_decode",
                        functools.partial(jaf.flash_decode, block_kv=32))


def _port_params(jparams, tcfg):
    return from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)(*args)


def test_converter_keeps_the_scan_order(jparams):
    _, tcfg = _cfgs("bfloat16")
    p = _port_params(jparams, tcfg)
    kinds = layer_kinds(tcfg)
    assert len(p["layers"]) == len(kinds) == 16
    # layer 4 = segment 0, period 0, pattern position 4 (the global attn)
    np.testing.assert_array_equal(p["layers"][4]["wq"]["w"].numpy(),
                                  np.asarray(jparams["seg0"]["pos4"]["wq"]["w"][0]))
    # layer 7 = segment 0, period 1, pattern position 1 (an mlp)
    np.testing.assert_array_equal(p["layers"][7]["wi"]["w"].numpy(),
                                  np.asarray(jparams["seg0"]["pos1"]["wi"]["w"][1]))
    assert kinds[4] == "attn" and kinds[7] == "mlp"


def _prefill_decode_logits(jparams, policy_name, activation_dtype, route):
    """(jax logits, port logits) for a prefill of 20 tokens (past the
    window of 16) and three decode steps at per-row positions, each
    package on its twin of ``route``."""
    jcfg, tcfg = _cfgs(activation_dtype)
    tparams = _port_params(jparams, tcfg)
    jpol = JExecutionPolicy(default=policy_name, backends=J_ROUTES[route],
                            interpret=True)
    tpol = execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route])
    toks = np.random.default_rng(5).integers(2, tcfg.vocab_size, (2, 20)).astype(np.int32)

    jprefill = jserve_step.make_prefill(jcfg, jpol, s_ctx=S_CTX)
    jl, jcache = _exact(jprefill, jparams, {"tokens": jnp.asarray(toks)})
    tl, tcache = serve_step.make_prefill(tcfg, tpol, s_ctx=S_CTX)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    pairs = [(np.asarray(jl), tl.numpy())]
    jdecode = jserve_step.make_decode(jcfg, jpol)
    tdecode = serve_step.make_decode(tcfg, tpol)
    pos = np.array([20, 20], np.int32)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = _exact(jdecode, jparams, jcache, jnp.asarray(nxt)[:, None],
                            jnp.asarray(pos))
        tl, tcache = tdecode(tparams, tcache, torch.from_numpy(nxt).long()[:, None],
                             torch.from_numpy(pos))
        pairs.append((np.asarray(jl), tl.numpy()))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1
    return pairs


@pytest.mark.parametrize("route", list(ROUTES))
def test_f32_prefill_and_decode_logits_match_repro(jparams, repro_kv_tile, route):
    for jl, tl in _prefill_decode_logits(jparams, "f32", "float32", route):
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= F32_ATOL


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_activation_logits_match_repro(jparams, repro_kv_tile, policy, route):
    for jl, tl in _prefill_decode_logits(jparams, policy, "bfloat16", route):
        assert np.abs(jl - tl).max() <= BF16_ATOL
        np.testing.assert_array_equal(jl.argmax(-1), tl.argmax(-1))


def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    lens, news = (18, 6, 18, 9), (7, 9, 5, 8)
    return [cls(rid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_staggered_engine_is_token_exact_against_repro_at_f32(jparams):
    """Two slots, four requests admitted at different ticks (prompts past
    the ring window among them): the port's engine on its kernel routes
    emits exactly repro's tokens under the f32 policy."""
    jcfg, tcfg = _cfgs("float32")
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=S_CTX,
                        policy=JPolicy.uniform("f32"))
    jeng.load(jparams)
    jreqs = _requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)

    teng = ServeEngine(tcfg, batch_size=2, max_ctx=S_CTX, device="cpu",
                       policy=execution_policy_for(tcfg, default="f32",
                                                   backends=ROUTES["kernels"]))
    teng.load(_port_params(jparams, tcfg))
    treqs = _requests(Request, tcfg.vocab_size)
    stats = teng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in treqs)
    assert stats["tokens"] == sum(len(r.out_tokens) for r in treqs)
    assert teng.ticks == jeng.ticks


def test_engine_lifecycle_cancel_deadline_evacuate_resume(jparams):
    _, tcfg = _cfgs("float32")
    pol = execution_policy_for(tcfg, default="f32")
    params = _port_params(jparams, tcfg)

    def engine(max_queue=None):
        e = ServeEngine(tcfg, batch_size=2, max_ctx=S_CTX, device="cpu",
                        policy=pol, max_queue=max_queue)
        e.load(params)
        return e

    ref = _requests(Request, tcfg.vocab_size)
    engine().run(ref)
    eng = engine(max_queue=2)
    reqs = _requests(Request, tcfg.vocab_size)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(Exception, match="queue full"):
        eng.submit(reqs[2])
    eng.step()
    eng.step()
    orphans = eng.evacuate()
    assert eng.idle and {r.rid for r in orphans} == {0, 1}
    # recovery: a fresh engine resumes the partial streams token-exactly
    other = engine()
    other.run(orphans)
    assert [r.out_tokens for r in orphans] == [ref[0].out_tokens, ref[1].out_tokens]
    late = _requests(Request, tcfg.vocab_size)
    late[2].deadline_ticks = 1
    eng.submit(late[2])
    eng.submit(late[3])
    assert eng.cancel(3) and not eng.cancel(99)
    eng.run([])
    assert late[2].expired and late[3].cancelled and eng.idle
