"""The port's paged KV cache against the JAX package's, on the CPU.

The paged layout is a storage change only: logical rows keep their dense
meaning (row ``pos`` on linear layers, ``pos % s_cache`` on ring layers),
so an unquantized paged engine is token-exact against the dense engine
across wrapped rings, recycled slots and staggered admission, and int8
pages stay inside ``PAGE_QUANT_BOUND``.  The writes and quantizer are held
bit for bit against ``repro``, the decodes to stated tolerances, and the
engines token for token against ``repro``'s at the f32 policy.  The
checklist is ``tests/test_paged_kv.py``.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.ops import paged as jpaged
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.kernels.attention_paged import flash_paged_decode as j_flash_paged_decode
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import api as japi
from repro.models.attention import reference_paged_decode as j_reference_paged_decode
from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.convert import from_jax_numpy
from repro_torch.core import ops
from repro_torch.core.ops import paged
from repro_torch.core.ops.route import Route
from repro_torch.kernels.attention_fused import flash_decode_plain
from repro_torch.kernels.attention_paged import flash_paged_decode, flash_paged_decode_plain
from repro_torch.launch.serve import Request, ServeEngine, _PageAllocator
from repro_torch.models import api
from repro_torch.models.attention import reference_decode, reference_paged_decode
from repro_torch.runtime import serve_step

MAX_CTX = 32
# paged decode's quantized rungs against repro's paged kernel (see
# test_flash_paged_decode_every_rung_matches_repro_kernel)
PAGED_REPRO_TOL = {"fp8": 0.02, "int8": 4e-3, "fp8x3": 1e-3, "int8x3": 1e-4}
KERNELS = {"gemm": "cuda", "attention": "cuda_fused"}
# Decodes of the same pools at f32: the two packages sum in other orders.
F32_ATOL = 1e-5
# bf16 passes, both walking 32-row KV tiles (pages of 32 rows on repro's
# side): the probabilities round to bf16 against the same running max; a
# value that rounds to the neighbouring bf16 in one package moves an output
# by ~2^-8 of one term.
BF16_ATOL = 1e-2


# ------------------------------------------------------------- the pools

def _history(b=3, kv=2, hd=32, s_cache=12, seed=0):
    """Per-position K/V rows (row 1 wraps a 12-row ring) and a query."""
    rng = np.random.default_rng(seed)
    pos = np.array([5, s_cache + 5, 2], np.int32)
    ks = rng.uniform(-1, 1, (int(pos.max()) + 1, b, kv, hd)).astype(np.float32)
    vs = rng.uniform(-1, 1, ks.shape).astype(np.float32)
    q = (rng.uniform(-1, 1, (b, 1, kv, 2, hd)) * hd ** -0.5).astype(np.float32)
    return q, ks, vs, pos


def _pools(quant, *, ps=4, s_cache=12, seed=0):
    """The same history written through both packages' ``write_kv`` into
    pools with a shuffled page table: (q, pos, port pool, repro pool,
    dense f32 k, dense f32 v)."""
    q, ks, vs, pos = _history(s_cache=s_cache, seed=seed)
    b, kv, hd = ks.shape[1:]
    n_log = paged.num_logical_pages(s_cache, ps)
    table = 1 + np.random.default_rng(seed + 1).permutation(b * n_log).reshape(b, n_log)
    table = table.astype(np.int32)
    tpool = paged.init_paged(b, s_cache, kv, hd, page_size=ps, num_pages=1 + b * n_log,
                             quant=quant, dtype=torch.float32, device="cpu")
    jpool = jpaged.init_paged(b, s_cache, kv, hd, page_size=ps, num_pages=1 + b * n_log,
                              quant=quant, dtype=jnp.float32)
    jpool = dataclasses.replace(jpool, page_table=jnp.asarray(table))
    dk = np.zeros((b, s_cache, kv, hd), np.float32)
    dv = np.zeros_like(dk)
    for p in range(int(pos.max()) + 1):
        # rows past their history write the trash page, as the engine's
        # repointed table rows do for inactive slots
        live = p <= pos
        tab = np.where(live[:, None], table, 0).astype(np.int32)
        slot = np.full(b, p % s_cache, np.int32)
        tpool.page_table = torch.from_numpy(tab)
        paged.write_kv(tpool, torch.from_numpy(ks[p]), torch.from_numpy(vs[p]),
                       torch.from_numpy(slot))
        jpool = dataclasses.replace(
            jpaged.write_kv(dataclasses.replace(jpool, page_table=jnp.asarray(tab)),
                            jnp.asarray(ks[p]), jnp.asarray(vs[p]), jnp.asarray(slot)),
            page_table=jnp.asarray(table))
        dk[live, p % s_cache], dv[live, p % s_cache] = ks[p][live], vs[p][live]
    tpool.page_table = torch.from_numpy(table)
    return q, pos, tpool, jpool, dk, dv


def _trash_free(x):
    """Pool payload without the trash page, whose rows several slots
    write at once (which write wins is not determined)."""
    return np.asarray(x)[1:]


# ============================================================ bit for bit

def test_quantize_rows_is_bit_equal_to_repro():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((500, 2, 64)) * rng.uniform(1e-3, 30, (500, 2, 1))).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero row: amax floor
    jq, js = jpaged.quantize_rows(jnp.asarray(x))
    tq, ts = paged.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


@pytest.mark.parametrize("quant", [None, "int8"])
def test_write_kv_is_bit_equal_to_repro(quant):
    _, _, tpool, jpool, _, _ = _pools(quant)
    for name in ("k_pages", "v_pages") + (("k_scale", "v_scale") if quant else ()):
        np.testing.assert_array_equal(_trash_free(getattr(tpool, name).numpy()),
                                      _trash_free(getattr(jpool, name)))
    k, v = paged.gather_dense(tpool)
    jk, jv = jpaged.gather_dense(jpool)
    assert k.shape == (3, 12, 2, 32)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ============================================================== decodes

@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("window", [8, None])
def test_reference_paged_decode_matches_repro(window, quant):
    q, pos, tpool, jpool, dk, dv = _pools(quant)
    out = reference_paged_decode(torch.from_numpy(q), tpool, torch.from_numpy(pos),
                                 window=window, softcap=None, policy="f32")
    ref = j_reference_paged_decode(jnp.asarray(q), jpool, jnp.asarray(pos), window=window,
                                   softcap=None, policy="f32")
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= F32_ATOL
    if quant is None:     # the gather reproduces the dense cache: same function, same bits
        dense = reference_decode(torch.from_numpy(q), torch.from_numpy(dk), torch.from_numpy(dv),
                                 torch.from_numpy(pos), window=window, softcap=None,
                                 policy="f32")
        np.testing.assert_array_equal(out.numpy(), dense.numpy())


@pytest.mark.parametrize("precision,ps,atol", [("f32", 4, F32_ATOL), ("bf16", 32, BF16_ATOL)])
@pytest.mark.parametrize("ring", [True, False])
def test_flash_paged_decode_plain_matches_repro_kernel(ring, precision, ps, atol):
    s_cache = 64 if ps == 32 else 12
    q, pos, tpool, jpool, _, _ = _pools(None, ps=ps, s_cache=s_cache)
    w = s_cache if ring else None
    out = flash_paged_decode_plain(torch.from_numpy(q), tpool, torch.from_numpy(pos),
                                   window=w, precision=precision)
    ref = j_flash_paged_decode(jnp.asarray(q), jpool, jnp.asarray(pos), window=w,
                               precision=precision, interpret=True)
    assert out.shape == q.shape
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= atol


@pytest.mark.parametrize("precision", ["bf16x6", "fp8", "int8", "fp8x3", "int8x3"])
def test_flash_paged_decode_every_rung_matches_repro_kernel(precision):
    """The rungs ``cuda_fused`` now fuses, on 32-row pages (one KV tile a
    page on both sides): bf16x6 multiplies the same terms as repro (the f32
    bound); the fp8 / int8 rungs scale per tile (the G heads' q rows, each
    32-row K and V tile, each G x 32 probability tile; repro per head) and
    are held to the rung's ladder bound of the f32 decode, and to
    PAGED_REPRO_TOL of repro: set between the readings here (fp8 0.0134,
    int8 1.35e-3, fp8x3 3.3e-4, int8x3 2.9e-5) and those of the port
    computing bf16 in place of a one-pass rung, or one pass in place of
    x3, or int8x3 under a scale twice too large (0.030, 8.6e-3, 0.029 and
    2.0e-3, 3.0e-4)."""
    q, pos, tpool, jpool, dk, dv = _pools(None, ps=32, s_cache=64)
    out = flash_paged_decode_plain(torch.from_numpy(q), tpool, torch.from_numpy(pos),
                                   window=64, precision=precision).numpy()
    ref = np.asarray(j_flash_paged_decode(jnp.asarray(q), jpool, jnp.asarray(pos), window=64,
                                          precision=precision, interpret=True))
    f32 = reference_decode(torch.from_numpy(q), torch.from_numpy(dk), torch.from_numpy(dv),
                           torch.from_numpy(pos), window=64, softcap=None, policy="f32").numpy()
    bound = F32_ATOL if precision == "bf16x6" else ops.get_family("attention").error_bound(
        precision)
    assert out.shape == q.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= PAGED_REPRO_TOL.get(precision, bound)
    assert np.abs(out - f32).max() <= max(bound, F32_ATOL)


@pytest.mark.parametrize("window", [8, None])
@pytest.mark.parametrize("impl", ["torch", "cuda_fused"])
def test_int8_pages_within_bound(window, impl):
    """int8 pages on both paged-decode impls stay inside the declared
    PAGE_QUANT_BOUND of the dense f32 cache's decode (and are quantized)."""
    q, pos, tpool, _, dk, dv = _pools("int8")
    qt, post = torch.from_numpy(q), torch.from_numpy(pos)
    ref = reference_decode(qt, torch.from_numpy(dk), torch.from_numpy(dv), post,
                           window=window, softcap=None, policy="f32")
    out = ops.attention_paged_decode(qt, tpool, post, window=window,
                                     policy=Route(precision="f32",
                                                  backends={"attention": impl}))
    err = (out - ref).abs().max().item()
    assert 0.0 < err <= paged.PAGE_QUANT_BOUND


def test_flash_paged_decode_on_cpu_is_the_plain_twin():
    q, pos, tpool, _, dk, dv = _pools(None)
    qt, post = torch.from_numpy(q), torch.from_numpy(pos)
    out = flash_paged_decode(qt, tpool, post, window=12)
    dense = flash_decode_plain(qt, torch.from_numpy(dk), torch.from_numpy(dv), post, window=12)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)


def test_paged_decode_capability_error_names_impl():
    from repro_torch.core.ops.attention import AttentionOps
    from repro_torch.core.ops.registry import register_impl
    name = "toy_nopaged_test"
    register_impl("attention", name, features=("decode",))(
        AttentionOps(forward=lambda *a, **k: None, decode=lambda *a, **k: None))
    q, pos, tpool, _, _, _ = _pools(None)
    with pytest.raises(ValueError, match=f"{name}.*paged_decode"):
        ops.attention_paged_decode(torch.from_numpy(q), tpool, torch.from_numpy(pos),
                                   policy=Route(backends={"attention": name}))


# ============================================================== engines

def _f32_cfgs():
    jcfg = dataclasses.replace(j_get_smoke("gemma3-1b"), activation_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("gemma3-1b"), activation_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jparams():
    return japi.init_params(jax.random.PRNGKey(3), j_get_smoke("gemma3-1b"))


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_numpy(jax.tree.map(np.asarray, jparams), _f32_cfgs()[1], "cpu")


def _requests(cls, vocab, n=4, budget=None, seed=17):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(2, vocab, 4 + (i % 3) * 7).astype(np.int32),
                max_new_tokens=budget or (4 + (i % 3))) for i in range(n)]


def _port(tparams, kv, *, batch_size=2, **req_kw):
    _, tcfg = _f32_cfgs()
    eng = ServeEngine(tcfg, batch_size=batch_size, max_ctx=MAX_CTX, device="cpu",
                      policy=execution_policy_for(tcfg, default="f32", backends=KERNELS), **kv)
    eng.load(tparams)
    reqs = _requests(Request, tcfg.vocab_size, **req_kw)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    return eng, [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_engine_token_exact_against_repro(jparams, tparams, quant):
    """Two slots, staggered admission, prompts past the 16-row window:
    the port's paged engine on its kernel routes emits repro's paged
    engine's tokens at the f32 policy, with f32 and with int8 pages."""
    jcfg, _ = _f32_cfgs()
    kv = dict(kv_layout="paged", kv_page_size=4, kv_quant=quant)
    jeng = JServeEngine(jcfg, batch_size=2, max_ctx=MAX_CTX, policy=JPolicy.uniform("f32"), **kv)
    jeng.load(jparams)
    jreqs = _requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)
    eng, toks = _port(tparams, kv)
    assert toks == [list(r.out_tokens) for r in jreqs]
    assert eng.ticks == jeng.ticks and eng.pages_outstanding() == 0


def test_paged_engine_equals_dense_and_frees_every_page(tparams):
    _, dense = _port(tparams, {})
    eng, pg = _port(tparams, dict(kv_layout="paged", kv_page_size=4))
    assert pg == dense
    for alloc in eng._allocators.values():
        assert alloc.available == alloc.num_pages - 1
    assert all(m is None for m in eng._slot_pages)
    assert all(not t.any() for t in eng._tables.values())


def test_paged_ring_wrap_long_decode(tparams):
    """Budgets push every slot far past the 16-row window: wrapped ring
    rows must land on the right pages."""
    budget = get_smoke("gemma3-1b").window + 6
    _, dense = _port(tparams, {}, n=2, budget=budget)
    _, pg = _port(tparams, dict(kv_layout="paged", kv_page_size=4), n=2, budget=budget)
    assert pg == dense


def test_paged_stale_slot_reuse(tparams):
    """One slot recycled for every request: freed pages and repointed
    table rows leave no trace of the previous tenant."""
    _, dense = _port(tparams, {}, batch_size=1)
    _, pg = _port(tparams, dict(kv_layout="paged", kv_page_size=4), batch_size=1)
    assert pg == dense


def test_paged_backpressure_tight_pool(tparams):
    """A pool of 1 + 6 pages per class fits one of the larger requests
    at a time: admission waits for frees and stays token-exact."""
    _, dense = _port(tparams, {})
    eng, pg = _port(tparams, dict(kv_layout="paged", kv_page_size=4, kv_pages=7))
    assert pg == dense and eng.pages_outstanding() == 0


def test_paged_lifecycle_cancel_expire_evacuate_resume(tparams):
    """Cancellation, expiry and evacuation free the slot's pages; the
    evacuated requests resume token-exactly on a fresh paged engine."""
    _, tcfg = _f32_cfgs()
    kv = dict(kv_layout="paged", kv_page_size=4, kv_quant="int8")
    _, ref = _port(tparams, kv)

    def engine():
        e = ServeEngine(tcfg, batch_size=2, max_ctx=MAX_CTX, device="cpu",
                        policy=execution_policy_for(tcfg, default="f32", backends=KERNELS), **kv)
        e.load(tparams)
        return e

    eng = engine()
    reqs = _requests(Request, tcfg.vocab_size)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.step()
    assert eng.pages_outstanding() > 0
    orphans = eng.evacuate()
    assert eng.idle and eng.pages_outstanding() == 0
    assert all(not t.any() for t in eng._tables.values())
    other = engine()
    other.run(orphans)
    assert [r.out_tokens for r in orphans] == ref[:2] and other.pages_outstanding() == 0
    late = _requests(Request, tcfg.vocab_size)
    late[2].deadline_ticks = 1
    eng.submit(late[2])
    eng.submit(late[3])
    eng.step()
    assert eng.pages_outstanding() > 0 and eng.cancel(3)
    eng.run([])
    assert late[2].expired and late[3].cancelled and eng.pages_outstanding() == 0


# ======================================================== infrastructure

def test_page_allocator_lifecycle():
    a = _PageAllocator(6)           # pages 1..5 allocatable, 0 = trash
    assert a.available == 5
    got = a.alloc(3)
    assert got is not None and 0 not in got and len(set(got)) == 3
    assert a.alloc(3) is None       # all-or-nothing: only 2 left
    assert a.available == 2
    a.free(got)
    assert a.available == 5


def test_init_paged_cache_structure_and_pad_cache():
    _, tcfg = _f32_cfgs()
    cache = serve_step.init_paged_cache(tcfg, 2, MAX_CTX, page_size=4, quant="int8",
                                        dtype=torch.float32, device="cpu")
    walked = list(serve_step.attn_cache_walk(tcfg, MAX_CTX))
    assert {cap for *_, cap in walked} == {MAX_CTX, tcfg.window}
    tables = {}
    for i, _, cap in walked:
        leaf = cache[i]
        assert isinstance(leaf, paged.PagedKVCache) and leaf.quantized
        assert leaf.s_cache == cap and leaf.k_pages.dtype == torch.int8
        assert leaf.page_table.shape == (2, paged.num_logical_pages(cap, 4))
        assert not leaf.page_table.any()
        # one table per capacity class, shared by its layers
        assert tables.setdefault(cap, leaf.page_table) is leaf.page_table
        assert leaf.k_pages.data_ptr() != leaf.v_pages.data_ptr()
    assert sum(c is None for c in cache) == len(cache) - len(walked)
    out = serve_step.pad_cache(cache, tcfg, MAX_CTX)
    assert all(o is c for o, c in zip(out, cache))


def test_api_init_cache_defaults_to_the_card():
    assert inspect.signature(api.init_cache).parameters["device"].default == "cuda"
    _, tcfg = _f32_cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            api.init_cache(tcfg, 1, 8)
    cache = api.init_cache(tcfg, 1, 8, device="cpu")
    assert next(c for c in cache if c is not None).k.device.type == "cpu"
