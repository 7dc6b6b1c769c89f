"""The port's VLM (internvl2-76b, the vlm family: embedded image patches
prepended to the text) against the JAX package, on the CPU.

The smoke config (8 image tokens); params from ``repro``'s
``api.init_params`` (numpy) through ``repro_torch.convert.from_jax_numpy``,
never re-initialised in torch.  The port runs its ``torch`` reference
routes and its kernel routes (``cuda`` / ``cuda_fused``: the kernels'
plain versions on CPU tensors); ``repro`` runs the twin of each, ``xla``
and ``pallas`` / ``pallas_fused`` in interpret mode.  Held: the prefill's
logits and its caches (image rows first), decode steps at per-row
positions counted past the image rows, the engine's tokens dense and
paged under staggered admission, the engine's refusal of a prompt that
does not fit beside the image rows, and the text-only loss.

Bounds, as ``test_torch_dense_archs.py`` sets them for the same routes:
F32_ATOL at f32 activations and the f32 policy; BF16_ATOL at bf16
activations (``repro``'s steps compiled with XLA's excess precision off,
its flash kernels on the port's 32-row KV tile), with the same greedy
tokens; tokens exact under the ``f32`` policy.
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
from repro.models import vlm as jvlm
from repro.runtime import serve_step as jserve_step
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api, vlm
from repro_torch.runtime import serve_step

ARCH = "internvl2-76b"
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


def test_config_twins_repro():
    """Every field of the port's schema equals repro's, full and smoke."""
    for tcfg, jcfg in ((get_config(ARCH), j_get_config(ARCH)),
                       (get_smoke(ARCH), j_get_smoke(ARCH))):
        def fields(cfg):
            out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tcfg)}
            for key in ("segments", "encoder_segments"):
                out[key] = tuple((s.pattern, s.count) for s in getattr(cfg, key))
            return out
        assert fields(tcfg) == fields(jcfg)
    assert get_config(ARCH).num_image_tokens == 256


def test_context_len_counts_the_image_rows():
    for cfg, jcfg in ((get_config(ARCH), j_get_config(ARCH)),
                      (get_smoke(ARCH), j_get_smoke(ARCH)),
                      (get_config("whisper-medium"), j_get_config("whisper-medium"))):
        assert api.context_len(cfg, 100) == japi.context_len(jcfg, 100)
    assert api.context_len(get_config(ARCH), 100) == 356


def _prefill_decode(jparams, policy_name, activation_dtype, route):
    """(jax, port) logits and caches for a prefill of 8 image rows and 12
    tokens (two rows, each with its own image) and three decode steps at
    per-row positions past both, each package on its twin of ``route``."""
    jcfg, tcfg = _cfgs(activation_dtype)
    tparams = _port_params(jparams, tcfg)
    jpol = JExecutionPolicy(default=policy_name, backends=J_ROUTES[route], interpret=True)
    tpol = execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route])
    rng = np.random.default_rng(5)
    toks = rng.integers(2, tcfg.vocab_size, (2, 12)).astype(np.int32)
    img = rng.standard_normal((2, tcfg.num_image_tokens, tcfg.d_model)).astype(np.float32)
    jl, jcache = _exact(jserve_step.make_prefill(jcfg, jpol, s_ctx=S_CTX), jparams,
                        {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)})
    tl, tcache = serve_step.make_prefill(tcfg, tpol, s_ctx=S_CTX)(
        tparams, {"tokens": torch.from_numpy(toks).long(),
                  "image_embeds": torch.from_numpy(img)})
    pairs = [(np.asarray(jl), tl.numpy())]
    # (the port's decode writes its caches in place: copy them now)
    caches = [(np.asarray(jcache["seg0"]["pos0"].k[c]), tcache[2 * c].k.float().numpy().copy())
              for c in range(2)]
    jdecode = jserve_step.make_decode(jcfg, jpol)
    tdecode = serve_step.make_decode(tcfg, tpol)
    pos = np.array([20, 23], np.int32)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = _exact(jdecode, jparams, jcache, jnp.asarray(nxt)[:, None],
                            jnp.asarray(pos))
        tl, tcache = tdecode(tparams, tcache, torch.from_numpy(nxt).long()[:, None],
                             torch.from_numpy(pos))
        pairs.append((np.asarray(jl), tl.numpy()))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1
    return pairs, caches


@pytest.mark.parametrize("route", list(ROUTES))
def test_f32_prefill_and_decode_logits_match_repro(jparams, repro_kv_tile, route):
    pairs, caches = _prefill_decode(jparams, "f32", "float32", route)
    for jl, tl in pairs:
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= F32_ATOL
    for jc, tc in caches:
        assert jc.shape == tc.shape == (2, S_CTX, 2, 16)
        assert np.abs(jc - tc).max() <= F32_ATOL


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_activation_logits_match_repro(jparams, repro_kv_tile, route, policy):
    pairs, _ = _prefill_decode(jparams, policy, "bfloat16", route)
    for jl, tl in pairs:
        assert np.abs(jl - tl).max() <= BF16_ATOL
        np.testing.assert_array_equal(jl.argmax(-1), tl.argmax(-1))


def test_image_rows_reach_the_logits(jparams):
    """The image rows are part of the context: rolling them by one
    position moves the prefill's last logits."""
    _, tcfg = _cfgs("float32")
    tparams = _port_params(jparams, tcfg)
    pol = execution_policy_for(tcfg, default="f32", backends=ROUTES["kernels"])
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(2, tcfg.vocab_size, (1, 6))).long()
    img = torch.from_numpy(
        rng.standard_normal((1, tcfg.num_image_tokens, tcfg.d_model)).astype(np.float32))
    la, _ = api.prefill(tparams, {"tokens": toks, "image_embeds": img}, tcfg, policy=pol)
    lb, _ = api.prefill(tparams, {"tokens": toks, "image_embeds": img.roll(1, 1)}, tcfg,
                        policy=pol)
    assert (la - lb).abs().max().item() > 100 * F32_ATOL


def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    lens, news = (18, 6, 18, 9), (7, 9, 5, 8)
    return [cls(rid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


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
    """Two slots, four requests admitted at different ticks, each after 8
    image rows: the port's engine on its kernel routes emits exactly
    repro's tokens under the f32 policy, dense and from 4-row pages (whose
    demand counts the image rows), and hands every page back."""
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
    assert teng.pages_outstanding() == 0
    if layout == "paged":
        # 8 image rows + 18 prompt + 7 new = 33 rows -> 9 pages of 4
        assert teng._pages_needed(treqs[0], S_CTX) == 9


def test_validate_refuses_a_prompt_beside_the_image_rows(jparams):
    """A prompt that fits the context alone but not after the image rows
    is refused at submit, as repro refuses it; one row shorter fits."""
    jcfg, tcfg = _cfgs("float32")
    n_img = tcfg.num_image_tokens
    prompt = np.arange(2, 2 + S_CTX - n_img, dtype=np.int32)
    jeng = JServeEngine(jcfg, batch_size=1, max_ctx=S_CTX, policy=JPolicy.uniform("f32"))
    teng = ServeEngine(tcfg, batch_size=1, max_ctx=S_CTX, device="cpu",
                       policy=execution_policy_for(tcfg, default="f32"))
    with pytest.raises(ValueError, match="image tokens") as theirs:
        jeng.submit(JRequest(rid=0, prompt=prompt))
    with pytest.raises(ValueError, match="image tokens") as ours:
        teng.submit(Request(rid=0, prompt=prompt))
    assert str(ours.value) == str(theirs.value)
    teng.submit(Request(rid=1, prompt=prompt[:-1]))
    jeng.submit(JRequest(rid=1, prompt=prompt[:-1]))


def test_vlm_loss_matches_repro_and_training_is_refused(jparams):
    """The text-only cross entropy on the same logits and labels; training
    on a batch without image rows is refused."""
    _, tcfg = _cfgs("float32")
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 8 + 5, tcfg.vocab_size)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    ours = vlm.vlm_loss(torch.from_numpy(logits), torch.from_numpy(labels), 8).item()
    theirs = float(jvlm.vlm_loss(jnp.asarray(logits), jnp.asarray(labels), 8))
    assert abs(ours - theirs) <= 1e-5
    tparams = _port_params(jparams, tcfg)
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="image rows"):
        api.loss_fn(tparams, {"tokens": toks, "labels": toks}, tcfg,
                    policy=execution_policy_for(tcfg))


def test_loss_fn_is_vlm_loss_on_the_forward_with_image_rows(jparams):
    """With image rows in the batch, ``api.loss_fn`` is the text-only cross
    entropy on the forward's logits."""
    _, tcfg = _cfgs("float32")
    rng = np.random.default_rng(2)
    tparams = _port_params(jparams, tcfg)
    toks = torch.ones((1, 4), dtype=torch.long)
    img = torch.from_numpy(rng.standard_normal((1, tcfg.num_image_tokens, tcfg.d_model))
                           .astype(np.float32))
    total, metrics = api.loss_fn(tparams, {"tokens": toks, "labels": toks, "image_embeds": img},
                                 tcfg, policy=execution_policy_for(tcfg))
    logits, _, _ = vlm.forward(tparams, toks, img, tcfg, policy=execution_policy_for(tcfg))
    assert logits.shape[1] == tcfg.num_image_tokens + 4
    assert float(total) == float(metrics["loss"]) == float(
        vlm.vlm_loss(logits, toks, tcfg.num_image_tokens))


def test_serve_cli_runs_internvl2_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend", "gemm=cuda",
                     "--backend", "attention=cuda_fused", "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert "arch=internvl2-smoke layers=4 device=cpu" in text
    assert "served 3 requests" in text
