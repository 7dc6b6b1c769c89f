"""The port's RWKV-6 serving path against the JAX package's, on the CPU.

rwkv6's smoke config; params from ``repro``'s ``api.init_params`` (numpy)
through ``repro_torch.convert.from_jax_numpy``, so both packages compute
the same function.  The port runs its ``torch`` reference route and its
kernel route (``gemm=cuda``: the kernels' plain versions on CPU tensors);
``repro`` runs the twin of each, ``xla`` and ``pallas`` in interpret mode.
"""

import dataclasses
import io
from contextlib import redirect_stdout

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
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import execution_policy_for, layer_kinds
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models.rwkv import RWKVState
from repro_torch.runtime import serve_step

ARCH = "rwkv6-7b"
ROUTES = {"torch": {}, "kernels": {"gemm": "cuda"}}
J_ROUTES = {"torch": {}, "kernels": {"gemm": "pallas"}}
F32_ATOL = 1e-4
# bf16 activations, repro's steps compiled with XLA's excess precision off
# (as in test_torch_serve.py): both packages round the same values at the
# same points, so only the f32 sums' order differs.  Measured maxima over
# prefill + 3 decode steps, |logits| <= 3.52: f32 4.4e-6, bf16 4.8e-7 and
# refine_ab 0.012 (a bf16 activation now and then rounds to its
# neighbour), alike on both routes; the greedy tokens agree.
BF16_ATOL = 5e-2
S_CTX = 64
EXACT_BF16 = {"xla_allow_excess_precision": False}


def _cfgs(activation_dtype):
    return (dataclasses.replace(j_get_smoke(ARCH), activation_dtype=activation_dtype),
            dataclasses.replace(get_smoke(ARCH), activation_dtype=activation_dtype))


@pytest.fixture(scope="module")
def jparams():
    return japi.init_params(jax.random.PRNGKey(0), j_get_smoke(ARCH))


def _port_params(jparams, tcfg):
    return from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)(*args)


def test_config_twins_repro():
    jc, tc = j_get_smoke(ARCH), get_smoke(ARCH)
    for f in ("d_model", "num_layers", "vocab_size", "d_ff", "rwkv_head_dim", "rwkv_chunk",
              "family"):
        assert getattr(jc, f) == getattr(tc, f), f
    full = get_config(ARCH)
    assert (full.d_model, full.num_layers, full.d_ff, full.vocab_size,
            full.d_model // full.rwkv_head_dim) == (4096, 32, 14336, 65536, 64)


def test_converter_keeps_lora_dicts_and_the_mu_stack(jparams):
    """The generic converter takes the nested lora_* dicts and indexes the
    (count, 5, d) mu stack per layer, in scan order."""
    _, tcfg = _cfgs("float32")
    p = _port_params(jparams, tcfg)
    assert len(p["layers"]) == len(layer_kinds(tcfg)) == 2
    for c in range(2):
        layer, seg = p["layers"][c], jparams["seg0"]["pos0"]
        assert tuple(layer["mu"].shape) == (5, tcfg.d_model)
        np.testing.assert_array_equal(layer["mu"].numpy(), np.asarray(seg["mu"][c]))
        for name in ("w", "k", "v", "r", "g"):
            for ab in ("a", "b"):
                np.testing.assert_array_equal(
                    layer[f"lora_{name}"][ab]["w"].numpy(),
                    np.asarray(seg[f"lora_{name}"][ab]["w"][c]))
        np.testing.assert_array_equal(layer["u"].numpy(), np.asarray(seg["u"][c]))
        np.testing.assert_array_equal(layer["ffn_v"]["w"].numpy(),
                                      np.asarray(seg["ffn_v"]["w"][c]))


def _prefill_decode_logits(jparams, policy_name, activation_dtype, route, prompt_len):
    """(jax logits, port logits) pairs for a prefill of ``prompt_len``
    tokens (two rows) and three decode steps, each package on its twin of
    ``route``; the decode states are compared too."""
    jcfg, tcfg = _cfgs(activation_dtype)
    tparams = _port_params(jparams, tcfg)
    jpol = JExecutionPolicy(default=policy_name, backends=J_ROUTES[route], interpret=True)
    tpol = execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route])
    toks = np.random.default_rng(5).integers(2, tcfg.vocab_size, (2, prompt_len)).astype(np.int32)
    jl, jcache = _exact(jserve_step.make_prefill(jcfg, jpol, s_ctx=S_CTX), jparams,
                        {"tokens": jnp.asarray(toks)})
    tl, tcache = serve_step.make_prefill(tcfg, tpol, s_ctx=S_CTX)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    pairs = [(np.asarray(jl), tl.numpy())]
    jdecode = jserve_step.make_decode(jcfg, jpol)
    tdecode = serve_step.make_decode(tcfg, tpol)
    pos = np.full(2, prompt_len, np.int32)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = _exact(jdecode, jparams, jcache, jnp.asarray(nxt)[:, None],
                            jnp.asarray(pos))
        tl, tcache = tdecode(tparams, tcache, torch.from_numpy(nxt).long()[:, None],
                             torch.from_numpy(pos))
        pairs.append((np.asarray(jl), tl.numpy()))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1
    states = []
    for c, st in enumerate(tcache):
        assert isinstance(st, RWKVState)
        jst = jcache["seg0"]["pos0"]
        states += [(np.asarray(getattr(jst, f)[c]), getattr(st, f).numpy())
                   for f in RWKVState._fields]
    return pairs, states


@pytest.mark.parametrize("route", list(ROUTES))
def test_f32_prefill_and_decode_logits_match_repro(jparams, route):
    """20 tokens: one chunk of 20 (the layer runs ``min(chunk, S)``, the
    JAX package's rule); the decode states are compared too."""
    pairs, states = _prefill_decode_logits(jparams, "f32", "float32", route, 20)
    for jl, tl in pairs + states:
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= F32_ATOL


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_activation_logits_match_repro(jparams, policy, route):
    pairs, _ = _prefill_decode_logits(jparams, policy, "bfloat16", route, 20)
    for jl, tl in pairs:
        assert np.abs(jl - tl).max() <= BF16_ATOL
        np.testing.assert_array_equal(jl.argmax(-1), tl.argmax(-1))


def test_f32_long_prompt_crosses_chunks(jparams):
    """A 150-token prompt runs three 64-step chunks (the last ragged,
    padded with identity steps), on the kernel route."""
    pairs, states = _prefill_decode_logits(jparams, "f32", "float32", "kernels", 150)
    for jl, tl in pairs + states:
        assert np.abs(jl - tl).max() <= F32_ATOL


def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    lens, news = (18, 6, 70, 9), (7, 9, 5, 8)
    return [cls(rid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_staggered_engine_is_token_exact_against_repro_at_f32(jparams):
    """Two slots, four requests admitted at different ticks (one prompt
    past a 64-step chunk): the port's engine on its kernel route emits
    exactly repro's tokens under the f32 policy, and the recurrent state
    spliced into a recycled slot carries nothing of its last request."""
    jcfg, tcfg = _cfgs("float32")
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=S_CTX * 2, policy=JPolicy.uniform("f32"))
    jeng.load(jparams)
    jreqs = _requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)

    teng = ServeEngine(tcfg, batch_size=2, max_ctx=S_CTX * 2, device="cpu",
                       policy=execution_policy_for(tcfg, default="f32",
                                                   backends=ROUTES["kernels"]))
    teng.load(_port_params(jparams, tcfg))
    treqs = _requests(Request, tcfg.vocab_size)
    stats = teng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in treqs)
    assert stats["tokens"] == sum(len(r.out_tokens) for r in treqs)
    assert teng.ticks == jeng.ticks
    # each alone on a fresh engine: the same tokens
    for r in _requests(Request, tcfg.vocab_size)[2:]:
        solo = ServeEngine(tcfg, batch_size=1, max_ctx=S_CTX * 2, device="cpu",
                           policy=execution_policy_for(tcfg, default="f32"))
        solo.load(teng.params)
        solo.run([r])
        assert r.out_tokens == treqs[r.rid].out_tokens


def test_serve_cli_runs_rwkv_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend", "gemm=cuda",
                     "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert "arch=rwkv6-smoke layers=2 device=cpu" in text
    assert "served 3 requests" in text


def test_paged_rwkv_serves_as_the_dense_engine(jparams):
    """rwkv6 has no growable attention layer: its paged engine has no page
    classes and no allocator work, keeps the recurrent state dense, and
    emits token for token what repro's paged engine and the port's dense
    engine emit (f32, staggered, a recycled slot)."""
    jcfg, tcfg = _cfgs("float32")
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=S_CTX * 2, policy=JPolicy.uniform("f32"),
                        kv_layout="paged")
    jeng.load(jparams)
    jreqs = _requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)
    params = _port_params(jparams, tcfg)
    outs = {}
    for layout in ("paged", "dense"):
        teng = ServeEngine(tcfg, batch_size=2, max_ctx=S_CTX * 2, device="cpu",
                           kv_layout=layout,
                           policy=execution_policy_for(tcfg, default="f32",
                                                       backends=ROUTES["kernels"]))
        teng.load(params)
        treqs = _requests(Request, tcfg.vocab_size)
        teng.run(treqs)
        assert all(r.done for r in treqs) and teng.pages_outstanding() == 0
        if layout == "paged":
            assert teng._allocators == {} and teng._tables == {}
            assert all(isinstance(c, RWKVState) for c in teng.cache)
        outs[layout] = [r.out_tokens for r in treqs]
    assert outs["paged"] == outs["dense"] == [r.out_tokens for r in jreqs]
