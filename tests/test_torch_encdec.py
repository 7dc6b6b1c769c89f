"""The port's encoder-decoder (whisper-medium, the audio family) against
the JAX package, on the CPU.

The smoke config; params from ``repro``'s ``api.init_params`` (numpy)
through ``repro_torch.convert.from_jax_numpy``, never re-initialised in
torch.  The port runs its ``torch`` reference routes and its kernel
routes (``cuda`` / ``cuda_fused``: the kernels' plain versions on CPU
tensors); ``repro`` runs the twin of each, ``xla`` and ``pallas`` /
``pallas_fused`` in interpret mode.  Held: the encoder's hidden states
(bidirectional attention over ``encoder_seq`` frames), the prefill's
logits and cross-attention caches, decode steps at per-row positions
(learned positional rows gathered per slot), and the engine's tokens,
dense and paged, under staggered admission.

Bounds, as ``test_torch_dense_archs.py`` sets them for the same routes:
F32_ATOL at f32 activations and the f32 policy (the f32 sums' order
differs); BF16_ATOL at bf16 activations, ``repro``'s steps compiled with
XLA's excess precision off and its flash kernels on the port's 32-row KV
tile, where the greedy tokens must agree too; tokens exact under the
``f32`` policy.
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
from repro.models import encdec as jencdec
from repro.runtime import serve_step as jserve_step
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import execution_policy_for, layer_kinds
from repro_torch.convert import from_jax_numpy
from repro_torch.core.ops.paged import PagedKVCache
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api
from repro_torch.models import encdec
from repro_torch.models import transformer as T
from repro_torch.models.attention import AttnCache
from repro_torch.runtime import serve_step

ARCH = "whisper-medium"
ROUTES = {"torch": {}, "kernels": {"gemm": "cuda", "attention": "cuda_fused"}}
J_ROUTES = {"torch": {}, "kernels": {"gemm": "pallas", "attention": "pallas_fused"}}
F32_ATOL = 1e-4
BF16_ATOL = 5e-2
S_CTX = 48
EXACT_BF16 = {"xla_allow_excess_precision": False}


def _cfgs(activation_dtype):
    return (dataclasses.replace(j_get_smoke(ARCH), activation_dtype=activation_dtype),
            dataclasses.replace(get_smoke(ARCH), activation_dtype=activation_dtype))


@pytest.fixture(scope="module")
def jparams():
    return japi.init_params(jax.random.PRNGKey(0), j_get_smoke(ARCH))


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


def _frames(tcfg, batch):
    rng = np.random.default_rng(7)
    return rng.standard_normal((batch, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)


def _policies(tcfg, policy_name, route):
    return (JExecutionPolicy(default=policy_name, backends=J_ROUTES[route], interpret=True),
            execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route]))


def test_config_twins_repro():
    """Every field of the port's schema equals repro's, full and smoke (the
    segments and encoder segments as (pattern, count) pairs: the two
    packages' ``Segment`` classes differ)."""
    for tcfg, jcfg in ((get_config(ARCH), j_get_config(ARCH)),
                       (get_smoke(ARCH), j_get_smoke(ARCH))):
        def fields(cfg):
            out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tcfg)}
            for key in ("segments", "encoder_segments"):
                out[key] = tuple((s.pattern, s.count) for s in getattr(cfg, key))
            return out
        assert fields(tcfg) == fields(jcfg)
    assert get_config(ARCH).encoder_seq == 1500 and get_config(ARCH).rope_theta is None


def test_encoder_layers_must_match_the_segments():
    """``encoder_layers`` is the encoder segments' depth; a config where
    the two disagree is refused rather than run at the segments' depth."""
    for cfg in (get_config(ARCH), get_smoke(ARCH)):
        T.check_kinds(cfg)
        with pytest.raises(ValueError, match="encoder_layers"):
            T.check_kinds(dataclasses.replace(cfg, encoder_layers=cfg.encoder_layers + 1))
    with pytest.raises(ValueError, match="encoder_layers"):
        api.init_params(dataclasses.replace(get_smoke(ARCH), encoder_layers=1),
                        torch.Generator().manual_seed(0), "cpu")


def test_converter_carries_the_encoder(jparams):
    """Encoder layer 2 is its period 1's attention, layer 3 its MLP; the
    positional tables, the encoder's final norm and the biases come
    across; the decoder's cross_attn sublayers sit at 1 and 4."""
    _, tcfg = _cfgs("float32")
    p = _port_params(jparams, tcfg)
    assert layer_kinds(tcfg) == ["attn", "cross_attn", "mlp"] * 2
    assert layer_kinds(tcfg, encoder=True) == ["attn", "mlp"] * 2
    assert len(p["layers"]) == 6 and len(p["enc_layers"]) == 4
    enc = jparams["enc_seg0"]
    np.testing.assert_array_equal(p["enc_layers"][2]["wq"]["w"].numpy(),
                                  np.asarray(enc["pos0"]["wq"]["w"][1]))
    np.testing.assert_array_equal(p["enc_layers"][3]["wo"]["b"].numpy(),
                                  np.asarray(enc["pos1"]["wo"]["b"][1]))
    np.testing.assert_array_equal(p["layers"][4]["wk"]["w"].numpy(),
                                  np.asarray(jparams["seg0"]["pos1"]["wk"]["w"][1]))
    for key in ("pos_embed", "enc_pos_embed"):
        np.testing.assert_array_equal(p[key]["table"].numpy(),
                                      np.asarray(jparams[key]["table"]))
    assert p["pos_embed"]["table"].shape == (32768, tcfg.d_model)
    assert p["enc_pos_embed"]["table"].shape == (tcfg.encoder_seq, tcfg.d_model)
    assert set(p) == {"embed", "final_norm", "layers", "pos_embed", "enc_layers",
                      "enc_final_norm", "enc_pos_embed"}


@pytest.mark.parametrize("policy,act", [("f32", "float32"), ("bf16", "bfloat16")])
@pytest.mark.parametrize("route", list(ROUTES))
def test_encoder_states_match_repro(jparams, repro_kv_tile, monkeypatch, route, policy, act):
    """The encoder's hidden states for two rows of frames, bidirectional;
    the same encoder run causal (the fault a dropped ``causal=False``
    would be) lands far outside the bound."""
    jcfg, tcfg = _cfgs(act)
    jpol, tpol = _policies(tcfg, policy, route)
    frames = _frames(tcfg, 2)
    jh = np.asarray(_exact(functools.partial(jencdec.encode, cfg=jcfg, policy=jpol),
                           jparams, jnp.asarray(frames))).astype(np.float32)
    tparams = _port_params(jparams, tcfg)
    th = encdec.encode(tparams, torch.from_numpy(frames), tcfg, policy=tpol).float().numpy()
    assert th.shape == (2, tcfg.encoder_seq, tcfg.d_model) and np.isfinite(th).all()
    tol = F32_ATOL if act == "float32" else BF16_ATOL
    assert np.abs(jh - th).max() <= tol
    real = T.attention
    monkeypatch.setattr(T, "attention", lambda *a, **kw: real(*a, **{**kw, "causal": True}))
    tc = encdec.encode(tparams, torch.from_numpy(frames), tcfg, policy=tpol).float().numpy()
    assert np.abs(jh - tc).max() > 10 * tol


def _prefill_decode(jparams, policy_name, activation_dtype, route):
    """(pairs of (jax, port) logits, pairs of cross caches) for a prefill of
    12 tokens (two rows, each with its own frames) and three decode steps
    at per-row positions, each package on its twin of ``route``."""
    jcfg, tcfg = _cfgs(activation_dtype)
    tparams = _port_params(jparams, tcfg)
    jpol, tpol = _policies(tcfg, policy_name, route)
    toks = np.random.default_rng(5).integers(2, tcfg.vocab_size, (2, 12)).astype(np.int32)
    frames = _frames(tcfg, 2)
    jl, jcache = _exact(jserve_step.make_prefill(jcfg, jpol, s_ctx=S_CTX), jparams,
                        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    tl, tcache = serve_step.make_prefill(tcfg, tpol, s_ctx=S_CTX)(
        tparams, {"tokens": torch.from_numpy(toks).long(),
                  "frames": torch.from_numpy(frames)})
    pairs = [(np.asarray(jl), tl.numpy())]
    # the port's flat cache list -> repro's (count, B, S, Kv, hd) stacks
    jcross = jcache["seg0"]["pos1"]
    cross = [(np.asarray(jcross.k[c]), tcache[3 * c + 1].k.float().numpy())
             for c in range(2)]
    cross += [(np.asarray(jcross.v[c]), tcache[3 * c + 1].v.float().numpy())
              for c in range(2)]
    jdecode = jserve_step.make_decode(jcfg, jpol)
    tdecode = serve_step.make_decode(tcfg, tpol)
    pos = np.array([12, 15], np.int32)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = _exact(jdecode, jparams, jcache, jnp.asarray(nxt)[:, None],
                            jnp.asarray(pos))
        tl, tcache = tdecode(tparams, tcache, torch.from_numpy(nxt).long()[:, None],
                             torch.from_numpy(pos))
        pairs.append((np.asarray(jl), tl.numpy()))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1
    return pairs, cross, tcache


@pytest.mark.parametrize("route", list(ROUTES))
def test_f32_prefill_cross_cache_and_decode_match_repro(jparams, repro_kv_tile, route):
    pairs, cross, tcache = _prefill_decode(jparams, "f32", "float32", route)
    for jl, tl in pairs:
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= F32_ATOL
    for jc, tc in cross:
        assert jc.shape == tc.shape == (2, 30, 4, 16)
        assert np.abs(jc - tc).max() <= F32_ATOL
    # the cross caches stay at the encoder's length, the self caches padded
    assert [tuple(c.k.shape) for c in tcache if isinstance(c, AttnCache)] == \
        [(2, S_CTX, 4, 16), (2, 30, 4, 16)] * 2


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_activation_logits_match_repro(jparams, repro_kv_tile, route, policy):
    pairs, cross, _ = _prefill_decode(jparams, policy, "bfloat16", route)
    for jl, tl in pairs:
        assert np.abs(jl - tl).max() <= BF16_ATOL
        np.testing.assert_array_equal(jl.argmax(-1), tl.argmax(-1))
    for jc, tc in cross:
        assert np.abs(jc.astype(np.float32) - tc).max() <= BF16_ATOL


def _requests(cls, vocab):
    """repro's ``tests/test_paged_kv.py`` request recipe: prompts of 4-6
    tokens, budgets of 4-6."""
    rng = np.random.default_rng(17)
    return [cls(rid=i, prompt=rng.integers(2, vocab, 4 + (i % 3)).astype(np.int32),
                max_new_tokens=4 + (i % 3)) for i in range(4)]


@pytest.fixture(scope="module")
def repro_tokens(jparams):
    """repro's dense engine: two slots, four staggered requests, f32."""
    jcfg, _ = _cfgs("float32")
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=S_CTX, policy=JPolicy.uniform("f32"))
    jeng.load(jparams)
    jreqs = _requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)
    return [r.out_tokens for r in jreqs], jeng.ticks


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_staggered_engine_is_token_exact_against_repro_at_f32(jparams, repro_tokens, layout):
    """Two slots, four requests admitted at different ticks: the port's
    engine on its kernel routes emits exactly repro's tokens under the f32
    policy, dense and from 4-row pages; the paged engine keeps each cross
    cache dense beside the self-attention pools and hands every page
    back."""
    _, tcfg = _cfgs("float32")
    kv = {"kv_layout": "paged", "kv_page_size": 4} if layout == "paged" else {}
    teng = ServeEngine(tcfg, batch_size=2, max_ctx=S_CTX, device="cpu",
                       policy=execution_policy_for(tcfg, default="f32",
                                                   backends=ROUTES["kernels"]), **kv)
    teng.load(_port_params(jparams, tcfg))
    treqs = _requests(Request, tcfg.vocab_size)
    stats = teng.run(treqs)
    tokens, ticks = repro_tokens
    assert [r.out_tokens for r in treqs] == tokens
    assert all(r.done for r in treqs) and teng.ticks == ticks
    assert stats["tokens"] == sum(len(r.out_tokens) for r in treqs)
    kinds = layer_kinds(tcfg)
    for kind, c in zip(kinds, teng.cache):
        if kind == "cross_attn":
            assert isinstance(c, AttnCache) and c.k.shape == (2, 30, 4, 16)
        elif kind == "attn":
            assert isinstance(c, PagedKVCache if layout == "paged" else AttnCache)
    assert teng.pages_outstanding() == 0


def test_paged_engine_matches_repros_paged_engine(jparams, repro_tokens):
    """repro's own paged engine (4-row pages) gives the dense tokens, as
    its ``test_paged_engine_token_exact[whisper-medium]`` holds, so the
    port's paged tokens above equal both."""
    jcfg, _ = _cfgs("float32")
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=S_CTX, policy=JPolicy.uniform("f32"),
                        kv_layout="paged", kv_page_size=4)
    jeng.load(jparams)
    jreqs = _requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)
    assert [r.out_tokens for r in jreqs] == repro_tokens[0]


def test_prefill_needs_frames_and_training_is_refused(jparams):
    """Prefill, and training on a batch, without frames are refused."""
    _, tcfg = _cfgs("float32")
    tparams = _port_params(jparams, tcfg)
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        encdec.forward(tparams, toks, None, tcfg, policy=execution_policy_for(tcfg),
                       mode="prefill")
    with pytest.raises(ValueError, match="frames"):
        api.loss_fn(tparams, {"tokens": toks, "labels": toks}, tcfg,
                    policy=execution_policy_for(tcfg))


def test_loss_fn_is_lm_loss_on_the_forward_with_frames(jparams):
    """With frames in the batch, ``api.loss_fn`` is the decoder's cross
    entropy on the forward's logits."""
    _, tcfg = _cfgs("float32")
    tparams = _port_params(jparams, tcfg)
    toks = torch.ones((1, 4), dtype=torch.long)
    frames = torch.from_numpy(_frames(tcfg, 1))
    total, metrics = api.loss_fn(tparams, {"tokens": toks, "labels": toks, "frames": frames},
                                 tcfg, policy=execution_policy_for(tcfg))
    logits, _, _ = encdec.forward(tparams, toks, frames, tcfg, policy=execution_policy_for(tcfg))
    assert float(total) == float(metrics["loss"]) == float(T.lm_loss(logits, toks))


def test_serve_cli_runs_whisper_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend", "gemm=cuda",
                     "--backend", "attention=cuda_fused", "--kv-layout", "paged",
                     "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert "arch=whisper-smoke layers=6 device=cpu" in text
    assert "served 3 requests" in text
