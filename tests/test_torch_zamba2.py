"""The port's zamba2 hybrid (Mamba-2 mixers + one shared attention block)
against the JAX package, on the CPU.

zamba2's smoke config (7 mixers: two periods of [mamba2, mamba2,
shared_attn] and a trailing mamba2); params from ``repro``'s
``api.init_params`` (numpy) through ``repro_torch.convert.from_jax_numpy``,
so both packages compute the same function.  The port runs its ``torch``
reference routes and its kernel routes (``cuda`` / ``cuda_fused``: the
kernels' plain versions on CPU tensors); ``repro`` runs the twin of each,
``xla`` and ``pallas`` / ``pallas_fused`` in interpret mode.
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
from repro_torch.core.ops import paged as paged_kv
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.attention import AttnCache
from repro_torch.runtime import serve_step

ARCH = "zamba2-7b"
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
KINDS = ["mamba2", "mamba2", "shared_attn"] * 2 + ["mamba2"]


def _cfgs(activation_dtype, **over):
    return (dataclasses.replace(j_get_smoke(ARCH), activation_dtype=activation_dtype, **over),
            dataclasses.replace(get_smoke(ARCH), activation_dtype=activation_dtype, **over))


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
    """Every field of the port's schema equals its repro twin's (the
    segments as (pattern, count) pairs), full size and smoke."""
    for tcfg, jcfg in ((get_config(ARCH), j_get_config(ARCH)),
                       (get_smoke(ARCH), j_get_smoke(ARCH))):
        for f in dataclasses.fields(tcfg):
            if f.name == "segments":
                assert ([(s.pattern, s.count) for s in tcfg.segments]
                        == [(s.pattern, s.count) for s in jcfg.segments])
            else:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    full = get_config(ARCH)
    assert layer_kinds(full).count("mamba2") == 68
    assert layer_kinds(full).count("shared_attn") == 13
    # Mamba-2's in_proj at full width: z, x|B|C, dt = 7168 + 7296 + 112 columns
    d_inner, nheads, conv_dim = S._dims(full.d_model, full.ssm_head_dim, full.ssm_state)
    assert d_inner + conv_dim + nheads == 14576


def test_converter_keeps_scan_order_and_carries_the_shared_block_once(jparams, monkeypatch):
    """Flat order is segment -> period -> pattern; each shared_attn slot is
    an empty dict and both occurrences run the one shared block."""
    _, tcfg = _cfgs("float32")
    p = _port_params(jparams, tcfg)
    assert layer_kinds(tcfg) == KINDS and len(p["layers"]) == 7
    seg0, seg1 = jparams["seg0"], jparams["seg1"]
    np.testing.assert_array_equal(p["layers"][3]["in_proj"]["w"].numpy(),
                                  np.asarray(seg0["pos0"]["in_proj"]["w"][1]))
    np.testing.assert_array_equal(p["layers"][4]["conv_w"].numpy(),
                                  np.asarray(seg0["pos1"]["conv_w"][1]))
    np.testing.assert_array_equal(p["layers"][6]["a_log"].numpy(),
                                  np.asarray(seg1["pos0"]["a_log"][0]))
    assert p["layers"][2] == {} and p["layers"][5] == {}
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(p["shared"]["attn"][name]["w"].numpy(),
                                      np.asarray(jparams["shared"]["attn"][name]["w"]))
    np.testing.assert_array_equal(p["shared"]["mlp"]["wg"]["w"].numpy(),
                                  np.asarray(jparams["shared"]["mlp"]["wg"]["w"]))
    seen = []
    real = T.attention

    def recording(ap, *args, **kw):
        seen.append(ap["wq"]["w"])
        return real(ap, *args, **kw)

    monkeypatch.setattr(T, "attention", recording)
    toks = torch.arange(2, 12)[None]
    T.forward(p, toks, tcfg, policy=execution_policy_for(tcfg, default="f32"), mode="prefill")
    assert len(seen) == 2 and all(w is p["shared"]["attn"]["wq"]["w"] for w in seen)


def _prefill_decode_logits(jparams, policy_name, activation_dtype, route, prompt_len=20,
                           **over):
    """(jax logits, port logits) pairs for a prefill of ``prompt_len``
    tokens (two rows) and three decode steps, each package on its twin of
    ``route``; then the final decode states (every Mamba-2 conv and SSD
    state and every shared-block occurrence's KV cache) as more pairs."""
    jcfg, tcfg = _cfgs(activation_dtype, **over)
    tparams = _port_params(jparams, tcfg)
    jpol = JExecutionPolicy(default=policy_name, backends=J_ROUTES[route], interpret=True)
    tpol = execution_policy_for(tcfg, default=policy_name, backends=ROUTES[route])
    toks = np.random.default_rng(5).integers(2, tcfg.vocab_size,
                                             (2, prompt_len)).astype(np.int32)
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
    flat = [(f"seg{i}", f"pos{j}", c) for i, seg in enumerate(tcfg.segments)
            for c in range(seg.count) for j in range(len(seg.pattern))]
    for (seg, posk, c), st in zip(flat, tcache):
        jst = jcache[seg][posk]
        assert isinstance(st, S.MambaState | AttnCache)
        states += [(np.asarray(getattr(jst, f)[c], np.float32), getattr(st, f).float().numpy())
                   for f in st._fields]
    return pairs, states


@pytest.mark.parametrize("route", list(ROUTES))
def test_f32_prefill_and_decode_logits_match_repro(jparams, repro_kv_tile, route):
    """20 tokens: one SSD chunk of 20 (the layer runs ``min(chunk, S)``,
    the JAX package's rule); the decode states are compared too."""
    pairs, states = _prefill_decode_logits(jparams, "f32", "float32", route)
    assert len(states) == 2 * 7
    for jl, tl in pairs + states:
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        assert np.abs(jl - tl).max() <= F32_ATOL


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_activation_logits_match_repro(jparams, repro_kv_tile, policy, route):
    pairs, _ = _prefill_decode_logits(jparams, policy, "bfloat16", route)
    for jl, tl in pairs:
        assert np.abs(jl - tl).max() <= BF16_ATOL
        np.testing.assert_array_equal(jl.argmax(-1), tl.argmax(-1))


@pytest.mark.parametrize("route", list(ROUTES))
def test_f32_prompt_crossing_ssd_chunks_matches_repro(jparams, repro_kv_tile, route):
    """ssm_chunk = 8 on both sides: a 21-token prompt runs three chunks
    (the last ragged, padded with identity steps), so the carried SSD state
    crosses two chunk boundaries."""
    pairs, states = _prefill_decode_logits(jparams, "f32", "float32", route, prompt_len=21,
                                           ssm_chunk=8)
    for jl, tl in pairs + states:
        assert np.abs(jl - tl).max() <= F32_ATOL


@pytest.mark.parametrize("group_chunks", [1, 2, None])
def test_ssd_chunked_equals_the_sequential_recurrence(monkeypatch, group_chunks):
    """The chunked scan (chunks batched in groups of one, two or all five,
    the state carried in order) against the one-token recurrence the decode
    runs, step by step, at f32; the same scan with the state reset at every
    chunk boundary (a fault) lands far outside the tolerance."""
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n, chunk = 2, 37, 3, 4, 5, 8
    if group_chunks is not None:
        monkeypatch.setattr(S, "_GROUP_BYTES", group_chunks * 4 * b * chunk * chunk * h)
    x = torch.randn((b, s, h, p), generator=g)
    bmat, cmat = torch.randn((b, s, n), generator=g), torch.randn((b, s, n), generator=g)
    dt = torch.rand((b, s, h), generator=g) + 0.1
    rel = -dt * torch.rand((h,), generator=g)
    y, state = S._ssd_chunked(x, bmat, cmat, rel, dt, chunk, "f32")
    st = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        st = st * torch.exp(rel[:, t])[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", dt[:, t, :, None] * x[:, t], bmat[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cmat[:, t], st))
    y_ref = torch.stack(ys, 1)
    assert (y - y_ref).abs().max() <= 1e-4 * y_ref.abs().max()
    assert (state - st).abs().max() <= 1e-4 * st.abs().max()
    parts = [S._ssd_chunked(*(t[:, c:c + chunk] for t in (x, bmat, cmat, rel, dt)),
                            chunk, "f32")[0] for c in range(0, s, chunk)]
    assert (torch.cat(parts, 1) - y_ref).abs().max() > 0.1 * y_ref.abs().max()


def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    lens, news = (18, 6, 27, 9), (7, 9, 5, 8)
    return [cls(rid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_staggered_engine_is_token_exact_against_repro_at_f32(jparams):
    """Two slots, four requests admitted at different ticks (ssm_chunk 8
    on both sides, so prompts cross SSD chunks): the port's engine on its
    kernel routes emits exactly repro's tokens under the f32 policy, and
    the Mamba-2 state and shared-block KV spliced into a recycled slot
    carry nothing of its last request."""
    jcfg, tcfg = _cfgs("float32", ssm_chunk=8)
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


def test_paged_engine_equals_the_dense_engine(jparams):
    """The paged engine holds one page pool per shared-block occurrence
    (one capacity class: the context) and the Mamba-2 state dense; at bf16
    pages and f32 activations it emits token for token the dense engine's
    output on the kernel routes, and hands every page back."""
    _, tcfg = _cfgs("float32", ssm_chunk=8)
    params = _port_params(jparams, tcfg)
    pol = execution_policy_for(tcfg, default="f32", backends=ROUTES["kernels"])
    outs = {}
    for layout in ("paged", "dense"):
        eng = ServeEngine(tcfg, batch_size=2, max_ctx=S_CTX, device="cpu", policy=pol,
                          kv_layout=layout)
        eng.load(params)
        reqs = _requests(Request, tcfg.vocab_size)
        eng.run(reqs)
        assert all(r.done for r in reqs) and eng.pages_outstanding() == 0
        if layout == "paged":
            assert list(eng._allocators) == [S_CTX]
            assert all(not t.any() for t in eng._tables.values())
            pools = [i for i, c in enumerate(eng.cache) if isinstance(c, paged_kv.PagedKVCache)]
            assert pools == [2, 5]
            assert all(isinstance(eng.cache[i], S.MambaState) for i in (0, 1, 3, 4, 6))
        outs[layout] = [r.out_tokens for r in reqs]
    assert outs["paged"] == outs["dense"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_cli_runs_zamba2_on_the_cpu(layout):
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend", "gemm=cuda",
                     "--backend", "attention=cuda_fused", "--kv-layout", layout,
                     "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert "arch=zamba2-smoke layers=7 device=cpu" in text and f"kv={layout}" in text
    assert "served 3 requests" in text


def test_init_cache_holds_a_state_per_mamba_layer_and_a_kv_cache_per_occurrence():
    tcfg = get_smoke(ARCH)
    cache = api.init_cache(tcfg, 3, S_CTX, device="cpu")
    for kind, c in zip(KINDS, cache):
        if kind == "mamba2":
            assert c.conv.shape == (3, tcfg.conv_width - 1, 2 * tcfg.d_model + 2 * tcfg.ssm_state)
            assert c.ssd.shape == (3, 2 * tcfg.d_model // tcfg.ssm_head_dim, tcfg.ssm_head_dim,
                                   tcfg.ssm_state)
            assert c.conv.dtype == c.ssd.dtype == torch.float32
        else:
            assert c.k.shape == (3, S_CTX, tcfg.num_kv_heads, tcfg.head_dim)
    assert cache[2].k is not cache[5].k
