"""The port's dense architectures starcoder2-15b, command-r-35b and
nemotron-4-340b against the JAX package, on the CPU.

Each arch's smoke config; params from ``repro``'s ``api.init_params``
(numpy) through ``repro_torch.convert.from_jax_numpy``, so both packages
compute the same function.  The port runs its ``torch`` reference routes
and its kernel routes (``cuda`` / ``cuda_fused``: the kernels' plain
versions on CPU tensors); ``repro`` runs the twin of each, ``xla`` and
``pallas`` / ``pallas_fused`` in interpret mode.  What the three add to
the dense path already held by ``test_torch_serve.py``: biased QKV and
MLP projections with a GELU MLP (starcoder2), a 256000-vocab config with
an 8e6 RoPE theta (command-r), a squared-ReLU MLP (nemotron).
"""

import dataclasses
import functools
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
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
from repro_torch.runtime import serve_step

ARCHS = ("starcoder2-15b", "command-r-35b", "nemotron-4-340b")
ROUTES = {"torch": {}, "kernels": {"gemm": "cuda", "attention": "cuda_fused"}}
J_ROUTES = {"torch": {}, "kernels": {"gemm": "pallas", "attention": "pallas_fused"}}
F32_ATOL = 1e-4
# bf16 activations, repro's steps compiled with XLA's excess precision off
# and its flash kernels on the port's 32-row KV tile (as in
# test_torch_serve.py): both packages round the same values at the same
# points, so only the f32 sums' order differs.  The greedy tokens agree.
BF16_ATOL = 5e-2
S_CTX = 48
EXACT_BF16 = {"xla_allow_excess_precision": False}


def _cfgs(arch, activation_dtype):
    return (dataclasses.replace(j_get_smoke(arch), activation_dtype=activation_dtype),
            dataclasses.replace(get_smoke(arch), activation_dtype=activation_dtype))


@pytest.fixture(scope="module")
def jparams_by_arch():
    return {arch: japi.init_params(jax.random.PRNGKey(0), j_get_smoke(arch))
            for arch in ARCHS}


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


def twin_fields(tcfg, jcfg):
    """(port, repro) values of every field of the port's schema, the
    segments as (pattern, count) pairs (the two packages' ``Segment``
    classes differ); repro's fields the port's schema does not have (the
    legacy per-family backends, ``ssm_heads``, ``supported_shapes``) are
    left out."""
    def fields(cfg):
        out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tcfg)}
        out["segments"] = tuple((s.pattern, s.count) for s in cfg.segments)
        return out
    return fields(tcfg), fields(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_twins_repro(arch):
    for tcfg, jcfg in ((get_config(arch), j_get_config(arch)),
                       (get_smoke(arch), j_get_smoke(arch))):
        ours, theirs = twin_fields(tcfg, jcfg)
        assert ours == theirs


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_keeps_the_scan_order(jparams_by_arch, arch):
    """Layer 2 is period 1's attention, layer 3 its MLP; starcoder2's
    biases come across with their weights."""
    jparams = jparams_by_arch[arch]
    _, tcfg = _cfgs(arch, "float32")
    p = _port_params(jparams, tcfg)
    assert layer_kinds(tcfg) == ["attn", "mlp", "attn", "mlp"] and len(p["layers"]) == 4
    seg = jparams["seg0"]
    np.testing.assert_array_equal(p["layers"][2]["wq"]["w"].numpy(),
                                  np.asarray(seg["pos0"]["wq"]["w"][1]))
    np.testing.assert_array_equal(p["layers"][3]["wo"]["w"].numpy(),
                                  np.asarray(seg["pos1"]["wo"]["w"][1]))
    assert ("b" in p["layers"][2]["wq"]) == tcfg.qkv_bias
    assert ("b" in p["layers"][3]["wi"]) == tcfg.mlp_bias
    assert ("wg" in p["layers"][3]) == (tcfg.mlp_kind == "swiglu")


def _prefill_decode_logits(jparams, arch, policy_name, activation_dtype, route):
    """(jax logits, port logits) for a prefill of 20 tokens (two rows) and
    three decode steps, each package on its twin of ``route``."""
    jcfg, tcfg = _cfgs(arch, activation_dtype)
    tparams = _port_params(jparams, tcfg)
    jpol = JExecutionPolicy(default=policy_name, backends=J_ROUTES[route], interpret=True)
    tpol = execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route])
    toks = np.random.default_rng(5).integers(2, tcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache = _exact(jserve_step.make_prefill(jcfg, jpol, s_ctx=S_CTX), jparams,
                        {"tokens": jnp.asarray(toks)})
    tl, tcache = serve_step.make_prefill(tcfg, tpol, s_ctx=S_CTX)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    pairs = [(np.asarray(jl), tl.numpy())]
    jdecode = jserve_step.make_decode(jcfg, jpol)
    tdecode = serve_step.make_decode(tcfg, tpol)
    pos = np.full(2, 20, np.int32)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_logits_match_repro(jparams_by_arch, repro_kv_tile, arch, route):
    for jl, tl in _prefill_decode_logits(jparams_by_arch[arch], arch, "f32", "float32", route):
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= F32_ATOL


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_activation_logits_match_repro(jparams_by_arch, repro_kv_tile, arch, route,
                                            policy):
    for jl, tl in _prefill_decode_logits(jparams_by_arch[arch], arch, policy, "bfloat16",
                                         route):
        assert np.abs(jl - tl).max() <= BF16_ATOL
        np.testing.assert_array_equal(jl.argmax(-1), tl.argmax(-1))


def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    lens, news = (18, 6, 18, 9), (7, 9, 5, 8)
    return [cls(rid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_engine_is_token_exact_against_repro_at_f32(jparams_by_arch, arch):
    """Two slots, four requests admitted at different ticks: the port's
    engine on its kernel routes emits exactly repro's tokens under the f32
    policy."""
    jparams = jparams_by_arch[arch]
    jcfg, tcfg = _cfgs(arch, "float32")
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=S_CTX, policy=JPolicy.uniform("f32"))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_arch_on_the_cpu(arch):
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--backend", "gemm=cuda",
                     "--backend", "attention=cuda_fused", "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert f"arch={get_smoke(arch).name} layers=4 device=cpu" in text
    assert "served 3 requests" in text
