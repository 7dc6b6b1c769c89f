"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and the CUDA toolkit: it is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
Run it on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the GPU
machine does not need).  Shapes are small and ragged so the masked tile
edges, strided (NT, batched) operands and every precision rung are hit.
"""

import contextlib
import faulthandler

import numpy as np
import pytest
import torch

from repro_torch.core.ops import paged
from repro_torch.core.ops.registry import LADDER_BOUNDS
from repro_torch.kernels import attention_fused as af
from repro_torch.kernels import batched_gemm as bg
from repro_torch.kernels import attention_paged as ap
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import gemm_lowp as gl
from repro_torch.kernels import gemm_naive as gn
from repro_torch.kernels import gemm_refined as gr
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import wkv6 as wk

pytestmark = pytest.mark.cuda

# Kernel and plain version multiply the same bf16 terms exactly; only the
# order of the f32 sums differs (K <= 1152, |terms| <= 1).
GEMM_ATOL = 1e-3
# Same tiles and softmax steps; f32 sum order and expf ulps differ, and a
# probability can round to the neighbouring bf16 value.
ATTN_ATOL = 2e-3
# Quantized GEMM, relative to the output's largest value: int8 sums exact
# integers and dequantizes in the plain version's order of roundings (so it
# should agree to the last bit); e4m3 partial sums round in f32 in another
# order.
LOWP_REL = 1e-5
# Batched small GEMMs (n <= 64, |terms| <= 1): the same bf16 products,
# f32 sums in another order.
BATCHED_ATOL = 1e-4
# WKV6 against its chunked plain form and the sequential recurrence:
# f32 throughout, sums in other orders, exp ulps (TestWKV6Kernel's).
WKV_TOL = 1e-4
# The backward multiplies p and ds (rounded to bf16 in both versions) by
# |dO|, |q|, |k| <= 1 over up to 150 rows: a p or ds that rounds to the
# neighbouring bf16 value in one version moves a sum by ~2^-8 of one term.
BWD_ATOL = 1e-2


# The fp8 / int8 rungs, kernel against plain version: both quantize the
# same tiles with the same pow2 scales, so the quantized terms of the
# inputs are bit-equal; they differ only where an f32 sum in another order
# moves a derived value (a probability, ds) across a quantization step.  A
# GEMM has no derived operand: it keeps the sum-order tolerance.  In
# attention one flipped probability moves an output by the step times |v|
# over the row's sum of probabilities: for the x3 rungs the lo term makes
# up all but its own step; for one pass the whole step (2^-6 for int8, up
# to 2^-4 of p for e4m3; rare, since p moves by an ulp).  Bounds set from
# the H100's readings (PERF.md, PR 16), largest over the cases: out
# (forward, decode, paged, the backward's forward) fp8 1.8e-7, int8
# 1.4e-3, fp8x3 2.3e-5, int8x3 3.3e-5; dq/dk/dv fp8 1.2e-7, int8 4.9e-4,
# fp8x3 2.4e-4, int8x3 5.8e-5.  Each case also holds the plain version at
# a wrong rung (bf16 in place of one pass, one pass in place of x3) above
# its bound, so a kernel that computed that rung would fail: the smallest
# such readings were 2.7e-3 (out, int8 and int8x3) and 1.6e-3 (dk, int8
# and int8x3).
QUANT_RUNGS = ("fp8", "int8", "fp8x3", "int8x3")
WRONG_RUNG = {"fp8": "bf16", "int8": "bf16", "fp8x3": "fp8", "int8x3": "int8"}
QUANT_ATTN_TOL = {"fp8": 1e-3, "int8": 2e-3, "fp8x3": 2e-4, "int8x3": 2e-4}
QUANT_BWD_TOL = {"fp8": 1e-3, "int8": 1e-3, "fp8x3": 1e-3, "int8x3": 5e-4}


def _hold(record_property, name, got, ref, tol, wrong=None):
    """max |got - ref| <= tol, the reading recorded (``--junitxml``);
    ``wrong``: the plain version at a wrong rung, which must land above
    tol."""
    assert got.shape == ref.shape and torch.isfinite(got).all(), name
    err = (got.float() - ref.float()).abs().max().item()
    record_property(f"{name}_err", err)
    if wrong is not None:
        control = (got.float() - wrong.float()).abs().max().item()
        record_property(f"{name}_control", control)
    assert err <= tol, (name, err, tol)
    if wrong is not None:
        assert control > tol, (f"{name}: the wrong-rung control is within the bound", control, tol)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _u(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((scale * rng.uniform(-1, 1, shape)).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("m,n,k", [(48, 40, 132), (4, 1000, 1152), (200, 300, 70),
                                   (1, 17, 5)])
@pytest.mark.parametrize("layout", ["nn", "nt", "batched"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_tiled_matches_plain(dev, m, n, k, layout, dtype):
    rng = np.random.default_rng(m * 7 + n)
    if layout == "batched":
        a, b = _u(rng, (3, m, k), dev, dtype), _u(rng, (3, k, n), dev)
    elif layout == "nt":
        a, b = _u(rng, (m, k), dev, dtype), _u(rng, (n, k), dev).t()
    else:
        a, b = _u(rng, (m, k), dev, dtype), _u(rng, (k, n), dev)
    out = gt.gemm_tiled(a, b)
    torch.cuda.synchronize()
    ref = gt.gemm_tiled_plain(a, b)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= GEMM_ATOL


def _sm90_operands(rng, m, n, k, layout, a_dtype, b_dtype, dev):
    """A and B for the mainloop's cases; B scaled by k^-1/2 as the model's
    weights are, so |C| stays O(1) at K = 6912 (the tensor cores' f32
    accumulation and the plain version's then differ by ~1e-5)."""
    sb = k ** -0.5
    if layout == "tn":            # M-contiguous A (train dW's x^T)
        a = _u(rng, (k, m), dev, a_dtype).t()
    elif layout == "misaligned":  # a view 2 bytes off 16-byte alignment: path (b)
        a = _u(rng, (m, k + 1), dev, a_dtype)[:, 1:]
    elif layout.startswith("batched"):
        a = _u(rng, (3, m, k), dev, a_dtype)
    else:
        a = _u(rng, (m, k), dev, a_dtype)
    if layout == "nt":            # K-major B (the unembed, train dX's w^T)
        b = _u(rng, (n, k), dev, b_dtype, sb).t()
    elif layout == "batched":
        b = _u(rng, (3, k, n), dev, b_dtype, sb)
    elif layout == "batched_b0":  # one B for every batch (batch stride 0)
        b = _u(rng, (k, n), dev, b_dtype, sb).expand(3, k, n)
    else:
        b = _u(rng, (k, n), dev, b_dtype, sb)
    return a, b


# The Hopper mainloop, smallest first: one 64 x 128 x 64 tile, then the
# ragged tails (K = 70 > BK, K < BK, M = 17, N = 40), then the prefill MLP
# and a deep K.  A hang here is an mbarrier phase fault.
SM90_SHAPES = [(64, 128, 64), (17, 40, 70), (200, 300, 70), (130, 72, 40), (700, 1152, 6912),
               (256, 256, 4096)]


@pytest.mark.parametrize("m,n,k", SM90_SHAPES)
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "batched", "batched_b0", "misaligned"])
@pytest.mark.parametrize("a_dtype,b_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16)])
def test_gemm_tiled_sm90_matches_plain(dev, m, n, k, layout, a_dtype, b_dtype):
    """Every layout gemm_tiled takes, f32 or bf16 on each side, through the
    wgmma mainloop (M > 16): TMA where an operand is bf16 and aligned, the
    converting producer otherwise."""
    rng = np.random.default_rng(m + 3 * n + k)
    a, b = _sm90_operands(rng, m, n, k, layout, a_dtype, b_dtype, dev)
    before = dict(gt.LAUNCHES_BY_LOOP)
    out = gt.gemm_tiled(a, b)
    torch.cuda.synchronize()
    assert gt.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 1}
    ref = gt.gemm_tiled_plain(a, b)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= GEMM_ATOL


def test_gemm_tiled_decode_runs_the_splitk_loop(dev):
    rng = np.random.default_rng(4)
    a, b = _u(rng, (16, 300), dev), _u(rng, (300, 200), dev)
    before = dict(gt.LAUNCHES_BY_LOOP)
    out = gt.gemm_tiled(a, b)
    torch.cuda.synchronize()
    assert gt.LAUNCHES_BY_LOOP == {**before, "splitk": before["splitk"] + 1}
    assert (out - gt.gemm_tiled_plain(a, b)).abs().max().item() <= GEMM_ATOL


@pytest.mark.parametrize("policy", ["refine_a", "bf16x3", "refine_ab"])
@pytest.mark.parametrize("m,n,k", [(48, 40, 132), (4, 1000, 1152), (200, 300, 70)])
@pytest.mark.parametrize("layout", ["nn", "nt", "batched"])
def test_gemm_refined_matches_plain(dev, policy, m, n, k, layout):
    rng = np.random.default_rng(m + n * 3)
    if layout == "batched":
        a, b = _u(rng, (2, m, k), dev), _u(rng, (2, k, n), dev)
    elif layout == "nt":
        a, b = _u(rng, (m, k), dev), _u(rng, (n, k), dev).t()
    else:
        a, b = _u(rng, (m, k), dev), _u(rng, (k, n), dev)
    out = gr.gemm_refined(a, b, policy=policy)
    torch.cuda.synchronize()
    ref = gr.gemm_refined_plain(a, b, policy)
    oracle = a.double() @ b.double()
    assert (out - ref).abs().max().item() <= GEMM_ATOL
    assert (out.double() - oracle).abs().max().item() <= LADDER_BOUNDS[policy]


@pytest.mark.parametrize("policy", af.FUSED_POLICIES)
@pytest.mark.parametrize("mask", ["causal", "window", "full", "softcap"])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, record_property, policy, mask, hd, dtype):
    rng = np.random.default_rng(hd)
    b, sq, kv, g = 2, 150, 2, 2
    q = (_u(rng, (b, sq, kv, g, hd), dev) * hd ** -0.5).to(dtype)
    k, v = _u(rng, (b, sq, kv, hd), dev, dtype), _u(rng, (b, sq, kv, hd), dev, dtype)
    kw = dict(causal=mask != "full", window=40 if mask == "window" else None,
              softcap=5.0 if mask == "softcap" else None, precision=policy)
    out = af.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, _ = af.flash_attention_plain(q, k, v, **kw)
    assert out.shape == q.shape
    quant = policy in QUANT_RUNGS
    _hold(record_property, "out", out, ref, QUANT_ATTN_TOL[policy] if quant else ATTN_ATOL,
          af.flash_attention_plain(q, k, v, **{**kw, "precision": WRONG_RUNG[policy]})[0]
          if quant else None)


@pytest.mark.parametrize("policy", af.FUSED_POLICIES)
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(dev, record_property, policy, ring, dtype):
    rng = np.random.default_rng(3)
    b, s, kv, g, hd = 4, 80, 1, 4, 256
    q = (_u(rng, (b, 1, kv, g, hd), dev) * hd ** -0.5).to(dtype)
    k, v = _u(rng, (b, s, kv, hd), dev, dtype), _u(rng, (b, s, kv, hd), dev, dtype)
    # positions before and after the ring wraps (and past a linear cache)
    pos = torch.tensor([3, 79, 80, 200] if ring else [0, 31, 32, 79],
                       dtype=torch.int32, device=dev)
    kw = dict(window=s if ring else None, softcap=None, precision=policy)
    out = af.flash_decode(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    ref = af.flash_decode_plain(q, k, v, pos, **kw)
    quant = policy in QUANT_RUNGS
    _hold(record_property, "out", out, ref, QUANT_ATTN_TOL[policy] if quant else ATTN_ATOL,
          af.flash_decode_plain(q, k, v, pos, **{**kw, "precision": WRONG_RUNG[policy]})
          if quant else None)


@pytest.mark.parametrize("policy", af.FUSED_POLICIES)
@pytest.mark.parametrize("mask", ["causal", "window", "full", "softcap"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_bwd_matches_plain(dev, record_property, policy, mask, g, hd):
    """The dq and dk/dv kernels against their plain version, on the
    forward kernel's own out and lse (which are held against the plain
    forward's first), at ragged lengths and bf16 inputs."""
    rng = np.random.default_rng(hd + g)
    b, sq, kv = 2, 150, 2
    q = (_u(rng, (b, sq, kv, g, hd), dev) * hd ** -0.5).to(torch.bfloat16)
    k, v = (_u(rng, (b, sq, kv, hd), dev, torch.bfloat16) for _ in range(2))
    do = _u(rng, (b, sq, kv, g, hd), dev)
    kw = dict(causal=mask != "full", window=40 if mask == "window" else None,
              softcap=5.0 if mask == "softcap" else None, precision=policy)
    out, lse = af.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    out_p, lse_p = af.flash_attention_plain(q, k, v, **kw)
    # 2^-8: one probability (<= 1) rounding to the neighbouring bf16 value
    # in one version moves an output (|v| <= 1) by up to that much; with G
    # = 4 heads of 150 rows such a flip happens (2.09e-3 measured on the
    # H100 at hd 256).  lse sums unquantized probabilities at every rung.
    quant = policy in QUANT_RUNGS
    wrong = dict(kw, precision=WRONG_RUNG[policy]) if quant else None
    _hold(record_property, "out", out, out_p, QUANT_ATTN_TOL[policy] if quant else 2 ** -8,
          af.flash_attention_plain(q, k, v, **wrong)[0] if quant else None)
    assert lse.shape == (b, kv * g, sq)
    _hold(record_property, "lse", lse, lse_p, ATTN_ATOL)
    grads = af.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    refs = af.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    wrongs = af.flash_attention_bwd_plain(q, k, v, out, lse, do, **wrong) if quant else (None,) * 3
    for name, x, ref, w in zip(("dq", "dk", "dv"), grads, refs, wrongs):
        _hold(record_property, name, x, ref, QUANT_BWD_TOL[policy] if quant else BWD_ATOL, w)


def test_flash_attention_autograd_runs_the_backward_kernels(dev):
    rng = np.random.default_rng(5)
    q = (_u(rng, (1, 70, 1, 4, 64), dev) * 0.125).requires_grad_(True)
    k, v = (_u(rng, (1, 70, 1, 64), dev).requires_grad_(True) for _ in range(2))
    before = dict(af.LAUNCHES)
    out = af.flash_attention(q, k, v, causal=True, window=24)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    for key in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert af.LAUNCHES[key] == before[key] + 1, key
    out_p, lse_p = af.flash_attention_plain(q.detach(), k.detach(), v.detach(), causal=True,
                                            window=24)
    refs = af.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out_p, lse_p,
                                        2 * out_p, causal=True, window=24)
    for x, ref in zip(grads, refs):
        assert (x - ref).abs().max().item() <= BWD_ATOL


@pytest.mark.parametrize("layout", ["m_contig_a", "k_major_b"])
@pytest.mark.parametrize("policy", ["bf16", "refine_a", "bf16x3", "refine_ab"])
@pytest.mark.parametrize("m,n,k", [(72, 200, 130), (300, 48, 520)])
def test_gemm_backward_layouts_match_plain(dev, layout, policy, m, n, k):
    """The two operand layouts the routed-GEMM backward hands the kernels:
    dW = x^T.g reads an M-contiguous A (x is (k, m) row-major), dX =
    g.W^T a K-major B (W is (n, k) row-major)."""
    rng = np.random.default_rng(m + k)
    if layout == "m_contig_a":
        a, b = _u(rng, (k, m), dev, torch.bfloat16).t(), _u(rng, (k, n), dev)
    else:
        a, b = _u(rng, (m, k), dev), _u(rng, (n, k), dev).t()
    if policy == "bf16":
        out, ref = gt.gemm_tiled(a, b), gt.gemm_tiled_plain(a, b)
    else:
        out, ref = gr.gemm_refined(a, b, policy=policy), gr.gemm_refined_plain(a, b, policy)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= GEMM_ATOL


def test_cuda_tensors_never_take_the_plain_path(dev, monkeypatch):
    """A CUDA operand launches the kernel (the count moves) and never the
    plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")
    monkeypatch.setattr(gt, "gemm_tiled_plain", boom)
    before = gt.LAUNCHES
    gt.gemm_tiled(torch.ones(4, 8, device=dev), torch.ones(8, 4, device=dev))
    assert gt.LAUNCHES == before + 1
    monkeypatch.setattr(gg, "grouped_gemm_plain", boom)
    monkeypatch.setattr(gg, "grouped_gemm_dw_plain", boom)
    off = torch.tensor([0, 16, 32], dtype=torch.int32, device=dev)
    gg.grouped_gemm(torch.ones(32, 8, device=dev), torch.ones(2, 8, 4, device=dev), off, bm=16)
    gg.grouped_gemm_dw(torch.ones(32, 8, device=dev), torch.ones(32, 4, device=dev), off)


def _paged_pool(rng, dev, b, s_cache, kv, hd, ps, quant, dtype):
    """A pool of random rows behind a shuffled page table whose tail
    pages of slot 0 point at the trash page."""
    n_log = paged.num_logical_pages(s_cache, ps)
    cache = paged.init_paged(b, s_cache, kv, hd, page_size=ps, num_pages=1 + b * n_log,
                             quant=quant, dtype=dtype, device=dev)
    table = 1 + torch.from_numpy(rng.permutation(b * n_log).reshape(b, n_log).astype(np.int32))
    table[0, n_log // 2:] = 0
    cache.page_table = table.to(dev)
    rows = _u(rng, (1 + b * n_log, ps, kv, hd), dev)
    if quant:
        cache.k_pages, cache.k_scale = paged.quantize_rows(rows)
        cache.v_pages, cache.v_scale = paged.quantize_rows(rows.flip(-1))
    else:
        cache.k_pages, cache.v_pages = rows.to(dtype), rows.flip(-1).to(dtype)
    return cache


@pytest.mark.parametrize("policy", af.FUSED_POLICIES)
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("ps", [8, 5])
def test_flash_paged_decode_matches_plain(dev, record_property, policy, ring, pool, ps):
    rng = np.random.default_rng(ps)
    b, s, kv, g, hd = 4, 80, 1, 4, 256
    dtype = torch.float32 if pool == "f32" else torch.bfloat16
    cache = _paged_pool(rng, dev, b, s, kv, hd, ps, "int8" if pool == "int8" else None, dtype)
    q = (_u(rng, (b, 1, kv, g, hd), dev) * hd ** -0.5).to(torch.bfloat16)
    pos = torch.tensor([3, 79, 80, 200] if ring else [0, 31, 32, 79],
                       dtype=torch.int32, device=dev)
    kw = dict(window=s if ring else None, softcap=None, precision=policy)
    before = ap.LAUNCHES
    out = ap.flash_paged_decode(q, cache, pos, **kw)
    torch.cuda.synchronize()
    assert ap.LAUNCHES == before + 1
    ref = ap.flash_paged_decode_plain(q, cache, pos, **kw)
    assert out.shape == q.shape
    quant = policy in QUANT_RUNGS
    _hold(record_property, "out", out, ref, QUANT_ATTN_TOL[policy] if quant else ATTN_ATOL,
          ap.flash_paged_decode_plain(q, cache, pos, **{**kw, "precision": WRONG_RUNG[policy]})
          if quant else None)


def test_paged_decode_of_a_bf16_pool_is_the_dense_decode(dev):
    """Pages that divide the 32-row KV tile sum in the dense kernel's
    order: the paged kernel gives the dense kernel's bits."""
    rng = np.random.default_rng(7)
    b, s, kv, g, hd = 4, 512, 1, 4, 256
    cache = _paged_pool(rng, dev, b, s, kv, hd, 8, None, torch.bfloat16)
    cache.page_table[0] = 1 + torch.arange(cache.page_table.shape[1], device=dev)
    q = (_u(rng, (b, 1, kv, g, hd), dev) * hd ** -0.5).to(torch.bfloat16)
    pos = torch.tensor([40, 300, 611, 1000], dtype=torch.int32, device=dev)
    k, v = paged.gather_dense(cache)
    out = ap.flash_paged_decode(q, cache, pos, window=s)
    dense = af.flash_decode(q, k.to(torch.bfloat16), v.to(torch.bfloat16), pos, window=s)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)


@pytest.mark.parametrize("policy", gl.LOWP_POLICIES)
@pytest.mark.parametrize("m,n,k,grid", [(4, 1000, 1152, (8, 256, 256)),
                                        (300, 270, 520, (256, 256, 256)),
                                        (48, 40, 132, (48, 128, 256)),
                                        (700, 384, 300, (128, 128, 128))])
def test_gemm_lowp_matches_plain(dev, policy, m, n, k, grid):
    rng = np.random.default_rng(m + n)
    a, b = _u(rng, (m, k), dev, torch.bfloat16), _u(rng, (k, n), dev)
    before = gl.LAUNCHES
    out = gl.gemm_lowp(a, b, policy=policy, bm=grid[0], bn=grid[1], bk=grid[2])
    torch.cuda.synchronize()
    assert gl.LAUNCHES == before + 1
    ref = gl.gemm_lowp_plain(a, b, policy, *grid)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= LOWP_REL * ref.abs().max().item()


def test_gemm_lowp_batched_and_routed(dev):
    """A batched plan launches once with the batch in the grid, and the
    cuda gemm impl sends the quantized rungs to gemm_lowp."""
    from repro_torch.core.ops import Route, routed_einsum
    rng = np.random.default_rng(11)
    a, b = _u(rng, (3, 20, 300), dev), _u(rng, (3, 300, 40), dev)
    out = gl.gemm_lowp(a, b, policy="fp8x3", bm=24, bn=128, bk=256)
    torch.cuda.synchronize()
    ref = gl.gemm_lowp_plain(a, b, "fp8x3", 24, 128, 256)
    assert (out - ref).abs().max().item() <= LOWP_REL * ref.abs().max().item()
    before = gl.LAUNCHES
    x, w = _u(rng, (2, 150, 272), dev), _u(rng, (272, 300), dev)
    y = routed_einsum("...i,io->...o", x, w, Route(precision="int8x3", backends={"gemm": "cuda"}))
    torch.cuda.synchronize()
    assert gl.LAUNCHES == before + 1
    y_ref = gl.gemm_lowp_plain(x.reshape(300, 272), w, "int8x3", 256, 256, 256).reshape(2, 150, 300)
    assert (y - y_ref).abs().max().item() <= LOWP_REL * y_ref.abs().max().item()


def _grouped_layout(rng, sizes, bm, d, dev, dtype, noise=False):
    """x sorted by group, runs aligned to bm (at least one tile), padding
    rows zero (or noise, for the dead-tile check), plus 2 dead tiles."""
    aligned = np.maximum(-(-np.asarray(sizes) // bm) * bm, bm)
    offsets = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
    x = np.zeros((int(offsets[-1]) + 2 * bm, d), np.float32)
    if noise:
        x[:] = rng.uniform(-1, 1, x.shape)
    for g, sz in enumerate(sizes):
        x[offsets[g]:offsets[g] + sz] = rng.uniform(-1, 1, (sz, d))
    return (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(offsets).to(dev))


@pytest.mark.parametrize("policy", list(gg.POLICY_CODES))
@pytest.mark.parametrize("sizes,bm", [([17, 3, 0, 40], 16), ([70, 0, 5], 64),
                                      ([100, 130, 1], 128)])
@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_matches_plain(dev, record_property, policy, sizes, bm, trans_w, dtype):
    """Forward and dx (w^T through swapped strides), an empty group, ragged
    D and F, both CTA row tiles; dead tiles (past offsets[E]) store 0.  The
    quantized rungs' terms are bit-equal in both (the inputs' own tiles),
    so every rung keeps the sum-order tolerance."""
    rng = np.random.default_rng(len(sizes) + bm)
    d, f = 132, 200
    x, off = _grouped_layout(rng, sizes, bm, f if trans_w else d, dev, dtype)
    w = _u(rng, (len(sizes), d, f), dev)
    before = gg.LAUNCHES["grouped_gemm"]
    out = gg.grouped_gemm(x, w, off, bm=bm, policy=policy, trans_w=trans_w)
    torch.cuda.synchronize()
    assert gg.LAUNCHES["grouped_gemm"] == before + 1
    ref = gg.grouped_gemm_plain(x, w, off, policy=policy, trans_w=trans_w, bm=bm)
    _hold(record_property, "out", out, ref, GEMM_ATOL,
          gg.grouped_gemm_plain(x, w, off, policy=WRONG_RUNG[policy], trans_w=trans_w, bm=bm)
          if policy in QUANT_RUNGS else None)
    assert not out[int(off[-1]):].any()


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f", [(128, 256), (132, 200)])
def test_grouped_gemm_sm90_rows(dev, bm, trans_w, dtype, d, f):
    """The bf16 forward and dx on the wgmma mainloop at CTA row tiles 64 and
    128: a zero-row expert, ragged runs whose padding holds noise, dead
    tiles past offsets[E] (zeros); aligned widths take TMA for bf16 x and w,
    the others the converting producer."""
    rng = np.random.default_rng(bm + d)
    x, off = _grouped_layout(rng, [bm + 3, 0, 2 * bm, 1], bm, f if trans_w else d, dev, dtype,
                             noise=True)
    w = _u(rng, (4, d, f), dev, dtype)
    before = dict(gg.LAUNCHES_BY_LOOP)
    out = gg.grouped_gemm(x, w, off, bm=bm, trans_w=trans_w)
    torch.cuda.synchronize()
    assert gg.cta_rows(bm) == bm
    assert gg.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 1}
    ref = gg.grouped_gemm_plain(x, w, off, bm=bm, trans_w=trans_w)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= GEMM_ATOL
    assert not out[int(off[-1]):].any()


def test_grouped_gemm_dead_tiles_skip_their_rows(dev):
    """Rows past offsets[E] come back zero whatever they hold."""
    rng = np.random.default_rng(3)
    x, off = _grouped_layout(rng, [20, 9], 16, 64, dev, torch.float32, noise=True)
    w = _u(rng, (2, 64, 48), dev)
    out = gg.grouped_gemm(x, w, off, bm=16)
    torch.cuda.synchronize()
    assert not out[int(off[-1]):].any()
    ref = gg.grouped_gemm_plain(x, w, off, bm=16)
    assert (out - ref).abs().max().item() <= GEMM_ATOL


@pytest.mark.parametrize("policy", list(gg.POLICY_CODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_dw_matches_plain(dev, record_property, policy, dtype):
    """dw[g] over each group's run; an empty run's block is exactly 0."""
    rng = np.random.default_rng(5)
    sizes, bm = [37, 0, 64, 5], 16
    x, off = _grouped_layout(rng, sizes, bm, 130, dev, dtype)
    dy = _u(rng, (x.shape[0], 72), dev)
    before = gg.LAUNCHES["grouped_gemm_dw"]
    dw = gg.grouped_gemm_dw(x, dy, off, policy=policy)
    torch.cuda.synchronize()
    assert gg.LAUNCHES["grouped_gemm_dw"] == before + 1
    ref = gg.grouped_gemm_dw_plain(x, dy, off, policy=policy)
    assert dw.shape == ref.shape == (4, 130, 72)
    # |terms| <= 1, runs of up to 64 rows: f32 sums in another order (the
    # quantized rungs' terms bit-equal, as in the forward)
    _hold(record_property, "dw", dw, ref, GEMM_ATOL,
          gg.grouped_gemm_dw_plain(x, dy, off, policy=WRONG_RUNG[policy])
          if policy in QUANT_RUNGS else None)
    assert not dw[1].any()


def test_grouped_autograd_runs_the_kernels(dev):
    """The routed grouped matmul's backward is the dx and dW kernels."""
    from repro_torch.core import ops
    rng = np.random.default_rng(9)
    x, off = _grouped_layout(rng, [30, 2, 0], 16, 96, dev, torch.float32)
    w = _u(rng, (3, 96, 80), dev).requires_grad_(True)
    x.requires_grad_(True)
    route = ops.Route("bf16", {"grouped": "cuda_grouped"})
    before = dict(gg.LAUNCHES)
    out = ops.grouped_matmul(x, w, off, policy=route, bm=16)
    dx, dw = torch.autograd.grad(out.square().sum(), (x, w))
    torch.cuda.synchronize()
    assert gg.LAUNCHES["grouped_gemm"] == before["grouped_gemm"] + 2
    assert gg.LAUNCHES["grouped_gemm_dw"] == before["grouped_gemm_dw"] + 1
    g = 2 * out.detach()
    dx_ref = gg.grouped_gemm_plain(g, w.detach(), off, bm=16, trans_w=True)
    assert (dx - dx_ref).abs().max() <= 1e-2
    assert (dw - gg.grouped_gemm_dw_plain(x.detach(), g, off)).abs().max() <= 1e-2
    assert not dw[2].any()


@pytest.mark.parametrize("m,n,k", [(48, 40, 132), (4, 1000, 1152), (200, 300, 70), (1, 17, 5)])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "batched"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_naive_matches_plain(dev, m, n, k, layout, dtype):
    """The unstaged kernel at ragged shapes (the wrapper pads to 16), with
    a transposed A or B read in place as a column-major fragment."""
    rng = np.random.default_rng(m + 5 * n)
    if layout == "batched":
        a, b = _u(rng, (3, m, k), dev, dtype), _u(rng, (3, k, n), dev, dtype)
    elif layout == "nt":
        a, b = _u(rng, (m, k), dev, dtype), _u(rng, (n, k), dev, dtype).t()
    elif layout == "tn":
        a, b = _u(rng, (k, m), dev, dtype).t(), _u(rng, (k, n), dev, dtype)
    else:
        a, b = _u(rng, (m, k), dev, dtype), _u(rng, (k, n), dev, dtype)
    before = gn.LAUNCHES
    out = gn.gemm_naive(a, b)
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before + 1
    ref = gn.gemm_naive_plain(a, b)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= GEMM_ATOL


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
def test_cuda_naive_route_matches_the_oracle(dev, policy):
    from repro_torch.core import ops
    rng = np.random.default_rng(1)
    a, b = _u(rng, (100, 130), dev), _u(rng, (50, 130), dev).t()
    before = gn.LAUNCHES
    out = ops.gemm(a, b, policy=policy, backend="cuda_naive")
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before + (1 if policy == "bf16" else 4)
    assert (out.double() - a.double() @ b.double()).abs().max().item() <= LADDER_BOUNDS[policy]


@pytest.mark.parametrize("n", bg.PACKED_N)
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_matches_plain(dev, n, groups, dtype):
    """One ragged chunk of the packed stream; a zero matrix stays exactly
    zero and leaves its neighbour (its fragment partner at n = 8) as it
    was: no crosstalk between the diagonal blocks."""
    rng = np.random.default_rng(n + groups)
    g = groups * 128 // n
    a, b = _u(rng, (g, n, n), dev, dtype), _u(rng, (g, n, n), dev, dtype)
    with _within(120, "batched_gemm"):
        out = bg.batched_gemm(a, b)
        torch.cuda.synchronize()
    ref = bg.batched_gemm_plain(a, b)
    assert out.shape == (g, n, n) and (out - ref).abs().max().item() <= BATCHED_ATOL
    a2 = a.clone()
    a2[1] = 0
    with _within(120, "batched_gemm"):
        out2 = bg.batched_gemm(a2, b)
        torch.cuda.synchronize()
    assert not out2[1].any() and (out2[0] - out[0]).abs().max().item() <= BATCHED_ATOL


@pytest.mark.parametrize("n", bg.PACKED_N)
@pytest.mark.parametrize("a_dtype,b_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32)])
def test_batched_gemm_stream_wraps_the_ring(dev, n, a_dtype, b_dtype):
    """G large enough that every persistent CTA takes its ring's stages
    three times over, plus a ragged last chunk; f32 operands rounded in the
    fragment load, bf16 ones by TMA as stored."""
    sms = gt.sm_count(dev.index or 0)
    plan = bg.packed_schedule(1, n, a_dtype == torch.bfloat16, b_dtype == torch.bfloat16, sms)
    per_chunk, pack = bg.CHUNK // (n * n), bg.PACK_TILE // n
    g = (plan["per_sm"] * sms * plan["stages"] * 3 + 1) * per_chunk - pack
    rng = np.random.default_rng(n)
    a, b = _u(rng, (g, n, n), dev, a_dtype), _u(rng, (g, n, n), dev, b_dtype)
    before = bg.LAUNCHES["batched_gemm"]
    with _within(120, "batched_gemm"):
        out = bg.batched_gemm(a, b)
        torch.cuda.synchronize()
    assert bg.LAUNCHES["batched_gemm"] == before + 1
    assert (out - bg.batched_gemm_plain(a, b)).abs().max().item() <= BATCHED_ATOL


def test_batched_gemm_stream_many_calls_finish(dev):
    """2000 calls of the packed stream (G = 4096, n = 64, bf16) under the
    watchdog, each bit-equal to the first: a ring or store-buffer phase
    fault would hang or leave a stale chunk."""
    rng = np.random.default_rng(64)
    a, b = (_u(rng, (4096, 64, 64), dev, torch.bfloat16) for _ in range(2))
    with _within(240, "batched_gemm"):
        first = bg.batched_gemm(a, b)
        for i in range(2000):
            out = bg.batched_gemm(a, b)
            if i % 100 == 99:
                torch.cuda.synchronize()
                assert torch.equal(out, first), i
        torch.cuda.synchronize()
    assert (first - bg.batched_gemm_plain(a, b)).abs().max().item() <= BATCHED_ATOL


@pytest.mark.parametrize("n", [8, 16, 24, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_naive_matches_plain(dev, n, dtype):
    """One warp per matrix at any n: ragged fragments zero-filled."""
    rng = np.random.default_rng(n)
    a, b = _u(rng, (13, n, n), dev, dtype), _u(rng, (13, n, n), dev, dtype)
    out = bg.batched_gemm_naive(a, b)
    torch.cuda.synchronize()
    assert (out - bg.batched_gemm_naive_plain(a, b)).abs().max().item() <= BATCHED_ATOL


def test_gemm_batched_dispatch_on_the_card(dev):
    rng = np.random.default_rng(2)
    a, b = _u(rng, (37, 16, 16), dev), _u(rng, (37, 16, 16), dev)
    ref = kref.batched_gemm_ref(a, b)
    before = dict(bg.LAUNCHES)
    for backend in ("cuda", "cuda_naive", "torch"):
        out = kops.gemm_batched(a, b, backend=backend)
        assert out.shape == (37, 16, 16) and (out - ref).abs().max().item() <= BATCHED_ATOL
    assert bg.LAUNCHES == {k: v + 1 for k, v in before.items()}
    with pytest.raises(ValueError, match="takes n in"):
        bg.batched_gemm(torch.zeros(32, 4, 4, device=dev), torch.zeros(32, 4, 4, device=dev))


@pytest.mark.parametrize("n", [1, 4, 128])
def test_gemm_batched_cuda_runs_a_kernel_for_every_divisor(dev, n):
    """n that divides the packing tile but has no packed kernel runs the
    naive kernel through ``gemm_batched(backend="cuda")``."""
    rng = np.random.default_rng(n)
    g = 3 if n == 128 else 40
    a, b = _u(rng, (g, n, n), dev), _u(rng, (g, n, n), dev, torch.bfloat16)
    before = dict(bg.LAUNCHES)
    out = kops.gemm_batched(a, b, backend="cuda")
    torch.cuda.synchronize()
    assert bg.LAUNCHES == {**before, "batched_gemm_naive": before["batched_gemm_naive"] + 1}
    assert out.shape == (g, n, n)
    assert (out - kref.batched_gemm_ref(a, b)).abs().max().item() <= BATCHED_ATOL


def _wkv_inputs(rng, b, s, h, kd, dev, decay_scale=0.7):
    r, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, kd)).astype(np.float32) * 0.5).to(dev)
               for _ in range(3))
    logw = -torch.exp(torch.from_numpy(rng.normal(size=(b, s, h, kd)).astype(np.float32)).to(dev)
                      * 0.5 - decay_scale)
    u = torch.from_numpy(rng.normal(size=(h, kd)).astype(np.float32) * 0.1).to(dev)
    return r, k, v, logw, u


@pytest.mark.parametrize("s,chunk", [(64, 64), (128, 64), (256, 32), (128, 128), (96, 16),
                                     (192, 96), (160, 80), (80, 40)])
@pytest.mark.parametrize("kd", wk.HEAD_DIMS)
def test_wkv6_matches_plain_and_the_recurrence(dev, s, chunk, kd):
    """The two launches against the chunked plain form, the sequential
    recurrence and the model of their own arithmetic (3xTF32); chunk 40
    ends in a ragged sub-block."""
    rng = np.random.default_rng(s + kd)
    xs = _wkv_inputs(rng, 2, s, 3, kd, dev)
    before = wk.LAUNCHES
    with _within(120, "wkv6"):
        out, st = wk.wkv6(*xs, chunk=chunk)
        torch.cuda.synchronize()
    assert wk.LAUNCHES == before + 1
    for ro, rs in (wk.wkv6_plain(*xs, chunk=chunk), kref.wkv6_ref(*xs),
                   wk.wkv6_scan_plain(*xs, chunk=chunk)):
        assert out.shape == ro.shape and st.shape == rs.shape == (2, 3, kd, kd)
        torch.testing.assert_close(out, ro, rtol=WKV_TOL, atol=WKV_TOL)
        torch.testing.assert_close(st, rs, rtol=WKV_TOL, atol=WKV_TOL)


def test_wkv6_strong_decay_and_its_limits(dev):
    rng = np.random.default_rng(9)
    xs = _wkv_inputs(rng, 2, 128, 2, 64, dev, decay_scale=-1.5)
    with _within(120, "wkv6"):
        out, _ = wk.wkv6(*xs, chunk=64)
        torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, kref.wkv6_ref(*xs)[0], rtol=WKV_TOL, atol=WKV_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wk.wkv6(*xs, chunk=96)
    with pytest.raises(ValueError, match="shared memory"):
        wk.wkv6(*_wkv_inputs(rng, 1, 256, 1, 64, dev), chunk=256)


# ---- the Hopper redesigns of the grouped dW (gemm_sm90.cuh's group-K mode)
# and the bf16 flash forward (flash_sm90.cuh), smallest shapes first.  An
# mbarrier phase fault hangs the card rather than failing, so each call
# runs under a watchdog that ends the process with a traceback.

@contextlib.contextmanager
def _within(seconds, *libraries):
    """Build (or load) the ``libraries`` first, then allow the block
    ``seconds``."""
    from repro_torch.kernels import _build
    for library in libraries:
        _build.load(library)
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _runs(sizes, bm):
    """Offsets of runs of ``sizes`` rows, each rounded up to ``bm`` (1:
    ragged, a run ending anywhere); a size of 0 is a zero-width group."""
    aligned = [-(-n // bm) * bm for n in sizes]
    return np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)


SM90_DW_CASES = [   # (sizes, bm, d, f): one 128 x 128 tile and one run first
    ([128], 1, 128, 128),
    ([37, 0, 64, 5], 16, 130, 72),
    ([37, 0, 65, 5], 1, 130, 72),
    ([300, 1, 0, 129], 1, 256, 200),
    ([513, 0, 64], 16, 264, 392),
]


@pytest.mark.parametrize("sizes,bm,d,f", SM90_DW_CASES)
@pytest.mark.parametrize("x_dtype,dy_dtype", [(torch.bfloat16, torch.float32),
                                              (torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16)])
def test_grouped_gemm_dw_sm90_matches_plain(dev, record_property, sizes, bm, d, f, x_dtype,
                                            dy_dtype):
    """The bf16 dW on the wgmma mainloop's group-K mode: runs aligned to 16
    and ragged (TMA loads past a run's end zeroed), zero-width groups
    exactly 0, ragged D and F (the converting producer), padding rows past
    offsets[E] holding noise that no run reads."""
    rng = np.random.default_rng(len(sizes) + d)
    off = _runs(sizes, bm)
    n = int(off[-1]) + 9
    x = _u(rng, (n, d), dev, x_dtype)
    dy = _u(rng, (n, f), dev, dy_dtype, n ** -0.5)
    toff = torch.from_numpy(off).to(dev)
    before = dict(gg.LAUNCHES_BY_LOOP_DW)
    with _within(120, "gemm_grouped_dw"):
        dw = gg.grouped_gemm_dw(x, dy, toff)
        torch.cuda.synchronize()
    assert gg.LAUNCHES_BY_LOOP_DW == {**before, "sm90": before["sm90"] + 1}
    ref = gg.grouped_gemm_dw_plain(x, dy, toff)
    _hold(record_property, "dw", dw, ref, GEMM_ATOL)
    for g, size in enumerate(sizes):
        if size == 0:
            assert not dw[g].any(), g


@pytest.mark.parametrize("policy", QUANT_RUNGS)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_grouped_dw_scale_pass_matches_plain(dev, policy, x_dtype):
    """The quantized dW rungs' quantize pass gives its plain twin's scales bit
    for bit (zeros at the slots no tile owns), for runs that 32 does not
    divide; the dW kernel reading them matches its plain version."""
    rng = np.random.default_rng(7)
    sizes = [37, 0, 64, 5, 31]
    off = torch.from_numpy(_runs(sizes, 1)).to(dev)
    n = int(off[-1]) + 5
    x = _u(rng, (n, 130), dev, x_dtype)
    dy = _u(rng, (n, 200), dev, scale=1e-2)
    with _within(120, "gemm_grouped_dw"):
        got = gg.grouped_dw_scales(x, dy, off, policy=policy)
        torch.cuda.synchronize()
    assert torch.equal(got, gg.grouped_dw_scales_plain(x, dy, off, policy=policy))
    before = gg.SCALE_PASS_LAUNCHES
    dw = gg.grouped_gemm_dw(x, dy, off, policy=policy)
    torch.cuda.synchronize()
    assert gg.SCALE_PASS_LAUNCHES == before + 1
    assert (dw - gg.grouped_gemm_dw_plain(x, dy, off, policy=policy)).abs().max() <= GEMM_ATOL


def _sm90_flash(rng, dev, b, sq, skv, kv, g, hd, dtype):
    q = (_u(rng, (b, sq, kv, g, hd), dev) * hd ** -0.5).to(dtype)
    k, v = _u(rng, (b, skv, kv, hd), dev, dtype), _u(rng, (b, skv, kv, hd), dev, dtype)
    return q, k, v


def _hold_sm90_flash(record_property, q, k, v, tol, **kw):
    before = dict(af.LAUNCHES_BY_LOOP)
    with _within(120, "attention_fused"):
        out, lse = af.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
    assert af.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 1}
    out_p, lse_p = af.flash_attention_plain(q, k, v, **kw)
    _hold(record_property, "out", out, out_p, tol)
    _hold(record_property, "lse", lse, lse_p, ATTN_ATOL)


def test_flash_attention_sm90_one_tile(dev, record_property):
    """One 64-row q block of one head against one 64-row KV stage."""
    q, k, v = _sm90_flash(np.random.default_rng(1), dev, 1, 64, 64, 1, 1, 64, torch.bfloat16)
    _hold_sm90_flash(record_property, q, k, v, ATTN_ATOL, causal=False)


# out within ATTN_ATOL at G = 1, 2^-8 at G = 4 (the bound the backward test
# holds the forward to there: a probability rounding to the neighbouring
# bf16 value moves an output by up to that much); lse within ATTN_ATOL.
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("mask", ["causal", "window", "full", "softcap"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_sm90_matches_plain(dev, record_property, hd, mask, g, dtype):
    """The bf16 forward on wgmma at Sq = Skv = 150 (64 divides neither),
    every mask, GQA, f32 inputs (converting producer) and bf16 (TMA)."""
    rng = np.random.default_rng(hd + g)
    q, k, v = _sm90_flash(rng, dev, 2, 150, 150, 2, g, hd, dtype)
    _hold_sm90_flash(record_property, q, k, v, ATTN_ATOL if g == 1 else 2 ** -8,
                     causal=mask != "full", window=40 if mask == "window" else None,
                     softcap=5.0 if mask == "softcap" else None)


@pytest.mark.parametrize("hd", [16, 80, 208])
@pytest.mark.parametrize("sq,skv,causal", [(70, 70, True), (33, 200, False), (129, 1, False)])
def test_flash_attention_sm90_odd_head_dims(dev, record_property, hd, sq, skv, causal):
    """Head dims that 64 does not divide (the last column block partly
    zeros), Skv apart from Sq, one key."""
    q, k, v = _sm90_flash(np.random.default_rng(hd + sq), dev, 1, sq, skv, 2, 2, hd,
                          torch.bfloat16)
    _hold_sm90_flash(record_property, q, k, v, ATTN_ATOL, causal=causal, window=None)


def test_flash_attention_other_rungs_keep_the_wmma_kernel(dev):
    """Only the bf16 forward runs the wgmma kernel; the other rungs, and
    the quantized dW rungs, count their launches as the WMMA kernel's."""
    q, k, v = _sm90_flash(np.random.default_rng(3), dev, 1, 100, 100, 1, 2, 64, torch.bfloat16)
    before = dict(af.LAUNCHES_BY_LOOP)
    for policy in ("refine_ab", "bf16x6", "fp8x3"):
        af.flash_attention_fwd(q, k, v, precision=policy)
    torch.cuda.synchronize()
    assert af.LAUNCHES_BY_LOOP == {**before, "wmma": before["wmma"] + 3}
    x, dy = _u(np.random.default_rng(4), (64, 72), dev), _u(np.random.default_rng(5), (64, 40), dev)
    off = torch.tensor([0, 30, 64], dtype=torch.int32, device=dev)
    before = dict(gg.LAUNCHES_BY_LOOP_DW)
    gg.grouped_gemm_dw(x, dy, off, policy="int8x3")
    gg.grouped_gemm_dw(x, dy, off, policy="refine_ab")
    torch.cuda.synchronize()
    assert gg.LAUNCHES_BY_LOOP_DW == {**before, "wmma": before["wmma"] + 2}


# The bf16 flash backward on wgmma (flash_bwd_sm90.cuh): dq and dk/dv held
# to their plain twins at BWD_ATOL on the plain forward's out and lse,
# smallest shape first, each launch under the watchdog.

def _sm90_bwd_inputs(rng, dev, b, sq, skv, kv, g, hd, dtype):
    q, k, v = _sm90_flash(rng, dev, b, sq, skv, kv, g, hd, dtype)
    return q, k, v, _u(rng, (b, sq, kv, g, hd), dev)


def _hold_sm90_bwd(record_property, q, k, v, do, **kw):
    out, lse = af.flash_attention_plain(q, k, v, **kw)
    di = af.bwd_delta(out, do)
    before_dq, before_dkv = dict(af.LAUNCHES_BY_LOOP_DQ), dict(af.LAUNCHES_BY_LOOP_DKV)
    before_fwd = dict(af.LAUNCHES_BY_LOOP)
    with _within(120, "attention_bwd"):
        dq = af.flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
        torch.cuda.synchronize()
        dk, dv = af.flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
        torch.cuda.synchronize()
    assert af.LAUNCHES_BY_LOOP_DQ == {**before_dq, "sm90": before_dq["sm90"] + 1}
    assert af.LAUNCHES_BY_LOOP_DKV == {**before_dkv, "sm90": before_dkv["sm90"] + 1}
    assert af.LAUNCHES_BY_LOOP == before_fwd
    _hold(record_property, "dq", dq, af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw),
          BWD_ATOL)
    dk_p, dv_p = af.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
    _hold(record_property, "dk", dk, dk_p, BWD_ATOL)
    _hold(record_property, "dv", dv, dv_p, BWD_ATOL)


def test_flash_attention_bwd_sm90_one_tile(dev, record_property):
    """One 64-row KV block, one q tile, hd 64, one head."""
    q, k, v, do = _sm90_bwd_inputs(np.random.default_rng(1), dev, 1, 64, 64, 1, 1, 64,
                                   torch.bfloat16)
    _hold_sm90_bwd(record_property, q, k, v, do, causal=False)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("mask", ["causal", "window", "full", "softcap"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_sm90_matches_plain(dev, record_property, hd, mask, g, dtype):
    """The bf16 dq and dk/dv on wgmma at Sq = Skv = 150 (64 divides
    neither), every mask, GQA (G > 1 here takes the per-head partials),
    f32 inputs (rounded once by the wrapper) and bf16."""
    q, k, v, do = _sm90_bwd_inputs(np.random.default_rng(hd + g), dev, 2, 150, 150, 2, g, hd,
                                   dtype)
    _hold_sm90_bwd(record_property, q, k, v, do, causal=mask != "full",
                   window=40 if mask == "window" else None,
                   softcap=5.0 if mask == "softcap" else None)


@pytest.mark.parametrize("b,s,kv,g,per_head", [(1, 256, 1, 4, True), (2, 1024, 8, 2, False)])
def test_flash_attention_bwd_sm90_grid_rules(dev, record_property, b, s, kv, g, per_head):
    """dk/dv with the group split over per-head CTAs (their partials summed
    by the wrapper) and with the group walked inside each CTA."""
    assert af._dkv_per_head(b, s, kv, g, torch.cuda.current_device()) is per_head
    q, k, v, do = _sm90_bwd_inputs(np.random.default_rng(s + g), dev, b, s, s, kv, g, 64,
                                   torch.bfloat16)
    _hold_sm90_bwd(record_property, q, k, v, do, causal=True, window=100)


@pytest.mark.parametrize("hd", [16, 208])
@pytest.mark.parametrize("sq,skv,causal", [(70, 70, True), (33, 200, False), (129, 1, False),
                                           (200, 70, True)])
def test_flash_attention_bwd_sm90_odd_shapes(dev, record_property, hd, sq, skv, causal):
    """Head dims that 64 does not divide, Skv apart from Sq (KV blocks that
    no causal row reaches write zeros), one key."""
    q, k, v, do = _sm90_bwd_inputs(np.random.default_rng(hd + sq), dev, 1, sq, skv, 2, 2, hd,
                                   torch.bfloat16)
    _hold_sm90_bwd(record_property, q, k, v, do, causal=causal)


def test_flash_attention_bwd_other_rungs_keep_the_wmma_kernels(dev):
    """Only the bf16 backward runs the wgmma kernels."""
    q, k, v, do = _sm90_bwd_inputs(np.random.default_rng(3), dev, 1, 100, 100, 1, 2, 64,
                                   torch.bfloat16)
    out, lse = af.flash_attention_plain(q, k, v)
    di = af.bwd_delta(out, do)
    before_dq, before_dkv = dict(af.LAUNCHES_BY_LOOP_DQ), dict(af.LAUNCHES_BY_LOOP_DKV)
    for policy in ("refine_a", "bf16x6", "fp8x3"):
        af.flash_attention_bwd_dq(q, k, v, do, lse, di, precision=policy)
        af.flash_attention_bwd_dkv(q, k, v, do, lse, di, precision=policy)
    torch.cuda.synchronize()
    assert af.LAUNCHES_BY_LOOP_DQ == {**before_dq, "wmma": before_dq["wmma"] + 3}
    assert af.LAUNCHES_BY_LOOP_DKV == {**before_dkv, "wmma": before_dkv["wmma"] + 3}


def test_grouped_gemm_dw_sm90_many_calls_finish(dev):
    """The bf16 dW at Mixtral's train widths (8 x 4096 x 14336 over 2048
    aligned rows), 2000 calls in a row, under the watchdog: its producer
    once let idle warps wait on ring barriers they did not gate, and one
    call in a few thousand never finished."""
    rng = np.random.default_rng(3)
    counts = rng.multinomial(2048, rng.dirichlet(np.full(8, 0.6)))
    aligned = -(-counts // 128) * 128
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)).to(dev)
    n = int(aligned.sum()) + 8 * 128
    x = torch.randn((n, 4096), device=dev).to(torch.bfloat16)
    dy = torch.randn((n, 14336), device=dev) * 2048 ** -0.5
    before = dict(gg.LAUNCHES_BY_LOOP_DW)
    with _within(240, "gemm_grouped_dw"):
        for i in range(2000):
            dw = gg.grouped_gemm_dw(x, dy, off)
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    assert gg.LAUNCHES_BY_LOOP_DW == {**before, "sm90": before["sm90"] + 2000}
    assert (dw - gg.grouped_gemm_dw_plain(x, dy, off)).abs().max().item() <= GEMM_ATOL


# ---- decode at M <= 16 and split-KV decode (gemm_splitk.cuh, the split
# walk of flash_common.cuh): each split's partial goes to a workspace and
# the last CTA of a tile, by an atomic ticket, sums them in split order.
# A ticket left set would leave later results wrong, so the repeated calls
# are held to the first one bit for bit.

def _splitk_operands(rng, m, n, k, layout, dtype, dev):
    """A and B for the split-K loop; B scaled by k^-1/2 as the model's
    weights are.  ``misaligned``: A off 16-byte alignment and B with an
    odd row stride, so both take the plain-load staging."""
    sb = k ** -0.5
    if layout == "nt":
        return _u(rng, (m, k), dev, dtype), _u(rng, (n, k), dev, dtype, sb).t()
    if layout == "batched":
        return _u(rng, (3, m, k), dev, dtype), _u(rng, (3, k, n), dev, dtype, sb)
    if layout == "misaligned":
        return (_u(rng, (m, k + 1), dev, dtype)[:, 1:],
                _u(rng, (k, n + 1), dev, dtype, sb)[:, 1:])
    return _u(rng, (m, k), dev, dtype), _u(rng, (k, n), dev, dtype, sb)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [200, 256, 1152, 6912])
@pytest.mark.parametrize("k", [300, 1152, 6912])
@pytest.mark.parametrize("layout", ["nn", "nt", "batched", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_tiled_splitk_matches_plain(dev, record_property, m, n, k, layout, dtype):
    """Every M <= 16 launch runs the split-K loop (its split count from
    ``splitk_splits``), within GEMM_ATOL of the plain version and of the
    split sum's own plain model."""
    rng = np.random.default_rng(m + 7 * n + k)
    a, b = _splitk_operands(rng, m, n, k, layout, dtype, dev)
    before = dict(gt.LAUNCHES_BY_LOOP)
    with _within(120, "gemm_tiled"):
        out = gt.gemm_tiled(a, b)
        torch.cuda.synchronize()
    assert gt.LAUNCHES_BY_LOOP == {**before, "splitk": before["splitk"] + 1}
    batch = a.shape[0] if a.dim() == 3 else 1
    splits = gt.splitk_splits(batch, m, n, k, gt.sm_count(dev.index or 0))
    record_property("splits", splits)
    _hold(record_property, "out", out, gt.gemm_tiled_plain(a, b), GEMM_ATOL)
    _hold(record_property, "model", out, gt.gemm_tiled_splitk_plain(a, b, splits), GEMM_ATOL)


def _decode_inputs(rng, b, s, kv, hd, dev):
    q = (_u(rng, (b, 1, kv, 4, hd), dev) * hd ** -0.5).to(torch.bfloat16)
    return q, _u(rng, (b, s, kv, hd), dev, torch.bfloat16), _u(rng, (b, s, kv, hd), dev,
                                                               torch.bfloat16)


@pytest.mark.parametrize("s", [100, 1024])
@pytest.mark.parametrize("kv,hd", [(1, 256), (8, 128)])
@pytest.mark.parametrize("ring", [True, False])
def test_flash_decode_split_matches_plain(dev, record_property, s, kv, hd, ring):
    """The bf16 decode split over CTAs at positions 0, 5, 31, 32, S - 1 and
    past S (splits with no live tile among them), against the plain twin
    and the split walk's own plain model; the launch counts as split."""
    rng = np.random.default_rng(s + kv)
    q, k, v = _decode_inputs(rng, 6, s, kv, hd, dev)
    pos = torch.tensor([0, 5, 31, 32, s - 1, s + 7], dtype=torch.int32, device=dev)
    window = s if ring else None
    splits = af.decode_splits(6, kv, s, gt.sm_count(dev.index or 0))
    assert splits > 1
    before = af.SPLIT_LAUNCHES["flash_decode"]
    with _within(120, "attention_fused"):
        out = af.flash_decode(q, k, v, pos, window=window)
        torch.cuda.synchronize()
    assert af.SPLIT_LAUNCHES["flash_decode"] == before + 1
    record_property("splits", splits)
    _hold(record_property, "out", out, af.flash_decode_plain(q, k, v, pos, window=window),
          ATTN_ATOL)
    _hold(record_property, "model", out,
          af.flash_decode_split_plain(q, k, v, pos, splits, window=window), ATTN_ATOL)


def test_splitk_and_split_decode_are_deterministic(dev):
    """Two calls give the same bits: the last CTA sums in split order."""
    rng = np.random.default_rng(11)
    a, b = _u(rng, (4, 6912), dev, torch.bfloat16), _u(rng, (6912, 1152), dev, scale=6912 ** -0.5)
    q, k, v = _decode_inputs(rng, 4, 1024, 1, 256, dev)
    pos = torch.tensor([40, 300, 611, 1000], dtype=torch.int32, device=dev)
    with _within(120, "gemm_tiled", "attention_fused"):
        g1, g2 = gt.gemm_tiled(a, b), gt.gemm_tiled(a, b)
        d1, d2 = af.flash_decode(q, k, v, pos), af.flash_decode(q, k, v, pos)
        torch.cuda.synchronize()
    assert torch.equal(g1, g2) and torch.equal(d1, d2)


def test_splitk_and_split_decode_many_calls_finish(dev):
    """2000 calls of each at gemma3's decode shapes (MLP down 4 x 6912 x
    1152 in 16 splits; a 1024-row linear cache in 32), under the watchdog,
    each call's result equal to the first's bit for bit."""
    rng = np.random.default_rng(12)
    a, b = _u(rng, (4, 6912), dev, torch.bfloat16), _u(rng, (6912, 1152), dev, scale=6912 ** -0.5)
    q, k, v = _decode_inputs(rng, 4, 1024, 1, 256, dev)
    pos = torch.tensor([40, 300, 611, 1000], dtype=torch.int32, device=dev)
    with _within(240, "gemm_tiled", "attention_fused"):
        g0, d0 = gt.gemm_tiled(a, b), af.flash_decode(q, k, v, pos)
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(2000):
            differ += (gt.gemm_tiled(a, b) != g0).sum()
            differ += (af.flash_decode(q, k, v, pos) != d0).sum()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    assert differ.item() == 0


# ---- the refined GEMM (refine_a / bf16x3 / refine_ab): M > 16 on the
# refined wgmma mainloop (gemm_refined_sm90.cuh, K split into whole waves
# by sm90_splits where the tiles are few), M <= 16 on the split-K weight
# stream (gemm_splitk.cuh); both skip the terms that read a bf16 operand's
# lo.  Smallest first, each call under the watchdog.

REFINED_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                  (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("policy", ["refine_a", "bf16x3", "refine_ab"])
@pytest.mark.parametrize("a_dtype,b_dtype", REFINED_DTYPES)
def test_gemm_refined_sm90_one_tile(dev, policy, a_dtype, b_dtype):
    rng = np.random.default_rng(3)
    a, b = _u(rng, (128, 64), dev, a_dtype), _u(rng, (64, 128), dev, b_dtype, 0.125)
    before = dict(gr.LAUNCHES_BY_LOOP)
    with _within(120, "gemm_refined"):
        out = gr.gemm_refined(a, b, policy=policy)
        torch.cuda.synchronize()
    assert gr.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 1}
    assert (out - gr.gemm_refined_plain(a, b, policy)).abs().max().item() <= GEMM_ATOL


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 200])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "batched", "misaligned"])
@pytest.mark.parametrize("a_dtype,b_dtype", REFINED_DTYPES)
@pytest.mark.parametrize("policy", ["refine_a", "bf16x3", "refine_ab"])
def test_gemm_refined_matches_plain_on_both_mainloops(dev, record_property, m, layout, a_dtype,
                                                      b_dtype, policy):
    """Every rung at NN, NT, M-contiguous A (``tn``), a batch of two and an
    A off 16-byte alignment, f32 or bf16 on each side, ragged N = 300 and K
    = 1000: the mainloop by M (``splitk`` up to 16 rows, ``sm90`` above),
    the split count by its chooser (more than one at these shapes), within
    GEMM_ATOL of the plain twin and of the split sum's plain model."""
    rng = np.random.default_rng(m + len(layout) + len(policy))
    n, k = 300, 1000
    sb = k ** -0.5
    if layout == "tn":
        a = _u(rng, (k, m), dev, a_dtype).t()
    elif layout == "misaligned":
        a = _u(rng, (m, k + 1), dev, a_dtype)[:, 1:]
    elif layout == "batched":
        a = _u(rng, (2, m, k), dev, a_dtype)
    else:
        a = _u(rng, (m, k), dev, a_dtype)
    if layout == "nt":
        b = _u(rng, (n, k), dev, b_dtype, sb).t()
    elif layout == "batched":
        b = _u(rng, (2, k, n), dev, b_dtype, sb)
    else:
        b = _u(rng, (k, n), dev, b_dtype, sb)
    loop = "splitk" if m <= 16 else "sm90"
    before = dict(gr.LAUNCHES_BY_LOOP)
    with _within(120, "gemm_refined"):
        out = gr.gemm_refined(a, b, policy=policy)
        torch.cuda.synchronize()
    assert gr.LAUNCHES_BY_LOOP == {**before, loop: before[loop] + 1}
    batch = a.shape[0] if a.dim() == 3 else 1
    splits = gr.refined_splits(batch, m, n, k, gt.sm_count(dev.index or 0))
    record_property("splits", splits)
    assert splits > 1
    _hold(record_property, "out", out, gr.gemm_refined_plain(a, b, policy), GEMM_ATOL)
    _hold(record_property, "model", out, gr.gemm_refined_splitk_plain(a, b, policy, splits),
          GEMM_ATOL)


def test_gemm_refined_split_calls_are_deterministic(dev):
    """2000 calls of each regime with K split, under the watchdog, each
    result equal to the first call's bit for bit (a ticket left set would
    show as a wrong result): refine_ab at 256 x 256 x 16384 (f32 x f32, 4
    terms, sm90, 32 splits) and at the decode's 4 x 6912 x 1152 (bf16 A,
    2 terms, splitk)."""
    rng = np.random.default_rng(13)
    a, b = _u(rng, (256, 16384), dev), _u(rng, (16384, 256), dev, scale=16384 ** -0.5)
    x, w = _u(rng, (4, 6912), dev, torch.bfloat16), _u(rng, (6912, 1152), dev,
                                                      scale=6912 ** -0.5)
    sms = gt.sm_count(dev.index or 0)
    assert gr.refined_splits(1, 256, 256, 16384, sms) > 1
    assert gr.refined_splits(1, 4, 1152, 6912, sms) > 1
    before = dict(gr.LAUNCHES_BY_LOOP)
    with _within(240, "gemm_refined"):
        c0, d0 = gr.gemm_refined(a, b), gr.gemm_refined(x, w)
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(2000):
            differ += (gr.gemm_refined(a, b) != c0).sum()
            differ += (gr.gemm_refined(x, w) != d0).sum()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    assert differ.item() == 0
    assert gr.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 2001,
                                   "splitk": before["splitk"] + 2001}
    assert (c0 - gr.gemm_refined_plain(a, b)).abs().max().item() <= GEMM_ATOL
    assert (d0 - gr.gemm_refined_plain(x, w)).abs().max().item() <= GEMM_ATOL


# ---- the quantized GEMM (fp8 / int8, one pass and x3): M <= 16 on the
# fused decode kernel (one launch, a thread-block cluster a B tile, counted
# as splitk), M > 16 on the quantize pass and the wgmma mainloop (sm90).
# Smallest first, each call under the watchdog.  The int8 rungs must equal
# the plain version bit for bit; e4m3 within LOWP_REL.

LOWP_LOOP_CASES = [   # (m, n, k, grid, A dtype, B layout)
    (4, 64, 64, (4, 64, 64), torch.float32, "nn"),          # one decode CTA
    (20, 128, 64, (64, 128, 64), torch.float32, "nn"),      # one mainloop tile
    (4, 1000, 1152, (8, 256, 256), torch.bfloat16, "nn"),   # test_gemm_lowp_matches_plain's
    (300, 270, 520, (256, 256, 256), torch.bfloat16, "nn"),
    (48, 40, 132, (48, 128, 256), torch.float32, "nn"),
    (700, 384, 300, (128, 128, 128), torch.bfloat16, "nn"),
    (4, 1152, 6912, (4, 256, 256), torch.bfloat16, "nn"),   # the decode MLP's wo
    (16, 777, 520, (8, 128, 256), torch.float32, "nn"),     # ragged N, two row tiles
    (20, 10, 30, (8, 128, 128), torch.float32, "nn"),       # bm 8 above M = 16
    (100, 200, 300, (16, 64, 64), torch.bfloat16, "nn"),    # a fold every stage, bm 16
    (4, 300, 200, (4, 128, 64), torch.float32, "nt"),       # element-staged B
    (96, 300, 200, (64, 128, 64), torch.float32, "nt"),
    (20, 40, 300, (24, 128, 256), torch.float32, "batched"),
    (4, 200, 100, (4, 128, 128), torch.bfloat16, "bf16"),   # a bf16 B
]


@pytest.mark.parametrize("m,n,k,grid,a_dtype,layout", LOWP_LOOP_CASES)
@pytest.mark.parametrize("policy", gl.LOWP_POLICIES)
def test_gemm_lowp_loops_match_plain(dev, record_property, policy, m, n, k, grid, a_dtype,
                                     layout):
    rng = np.random.default_rng(m + n + k)
    if layout == "batched":
        a, b = _u(rng, (3, m, k), dev, a_dtype), _u(rng, (3, k, n), dev)
    elif layout == "nt":
        a, b = _u(rng, (m, k), dev, a_dtype), _u(rng, (n, k), dev).t()
    else:
        a = _u(rng, (m, k), dev, a_dtype)
        b = _u(rng, (k, n), dev, torch.bfloat16 if layout == "bf16" else torch.float32)
    loop = "splitk" if m <= 16 else "sm90"
    before, launches = dict(gl.LAUNCHES_BY_LOOP), gl.LAUNCHES
    with _within(120, "gemm_lowp"):
        out = gl.gemm_lowp(a, b, policy=policy, bm=grid[0], bn=grid[1], bk=grid[2])
        torch.cuda.synchronize()
    assert gl.LAUNCHES == launches + 1
    assert gl.LAUNCHES_BY_LOOP == {**before, loop: before[loop] + 1}
    ref = gl.gemm_lowp_plain(a, b, policy, *grid)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    record_property("err", err)
    if policy.startswith("int8"):
        assert torch.equal(out, ref), err
    else:
        assert err <= LOWP_REL * ref.abs().max().item()


def test_gemm_lowp_decode_calls_are_deterministic(dev):
    """2000 calls at each decode MLP shape (wi 4 x 1152 x 6912, wo 4 x 6912
    x 1152; fp8x3 and int8x3 in turns), under the watchdog, each result
    equal to the first call's bit for bit (a ticket left set would show as
    a wrong result)."""
    rng = np.random.default_rng(14)
    x, h = _u(rng, (4, 1152), dev, torch.bfloat16), _u(rng, (4, 6912), dev, torch.bfloat16)
    wi, wo = _u(rng, (1152, 6912), dev, scale=1152 ** -0.5), _u(rng, (6912, 1152), dev,
                                                                  scale=6912 ** -0.5)
    calls = [lambda: gl.gemm_lowp(x, wi, policy="fp8x3", bm=4),
             lambda: gl.gemm_lowp(h, wo, policy="int8x3", bm=4)]
    before = dict(gl.LAUNCHES_BY_LOOP)
    with _within(240, "gemm_lowp"):
        first = [c() for c in calls]
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(2000):
            for c, f in zip(calls, first):
                differ += (c() != f).sum()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    assert differ.item() == 0
    assert gl.LAUNCHES_BY_LOOP == {**before, "splitk": before["splitk"] + 4002}
    assert torch.equal(first[1], gl.gemm_lowp_plain(h, wo, "int8x3", 4, 256, 256))
    ref = gl.gemm_lowp_plain(x, wi, "fp8x3", 4, 256, 256)
    assert (first[0] - ref).abs().max().item() <= LOWP_REL * ref.abs().max().item()


# ---- the grouped forward and dx at a 16-row CTA tile (every decode call
# of the MoE FFN): bf16 and the refined rungs on the split-K weight
# stream's group-rows mode (gemm_splitk.cuh, counted as splitk), only the
# tiles with live rows (group_counts) reading their expert's weights.
# Smallest first, each call under the watchdog.

def _grouped_decode(rng, sizes, k, dev, dtype, noise=False):
    """A buffer sorted by group, runs aligned to 16 (at least one tile) and
    one dead tile after them, padding rows zero (or noise); offsets and the
    real counts on the card."""
    aligned = np.maximum(-(-np.asarray(sizes) // 16) * 16, 16)
    off = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
    x = np.zeros((int(off[-1]) + 16, k), np.float32)
    if noise:
        x[:] = rng.uniform(-1, 1, x.shape)
    for g, n in enumerate(sizes):
        x[off[g]:off[g] + n] = rng.uniform(-1, 1, (n, k))
    return (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(off).to(dev),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


GROUPED_SPLITK_CASES = [   # (sizes, d, f, trans_w, x dtype, w dtype)
    ([3, 0, 1], 64, 64, False, torch.bfloat16, torch.float32),       # one tile of one expert
    ([5, 0, 20, 16], 1152, 256, False, torch.bfloat16, torch.float32),   # splits > 1
    ([5, 0, 20, 16], 1152, 256, True, torch.float32, torch.float32),     # dx: K-major B
    ([9, 1, 0, 2], 200, 300, False, torch.float32, torch.bfloat16),  # ragged, element-staged
    ([2, 0, 1, 0, 3, 0, 2, 0], 4096, 14336, False, torch.bfloat16, torch.float32),  # wi
    ([2, 0, 1, 0, 3, 0, 2, 0], 14336, 4096, False, torch.bfloat16, torch.float32),  # wo
]


@pytest.mark.parametrize("policy,sizes,d,f,trans_w,x_dtype,w_dtype", [
    (policy, *case) for case in GROUPED_SPLITK_CASES for policy in gg.SPLITK_POLICIES
    if case[1] * case[2] < 1 << 20 or policy in ("bf16", "refine_ab")])   # Mixtral: 2 rungs
def test_grouped_gemm_splitk_matches_plain(dev, record_property, policy, sizes, d, f, trans_w,
                                           x_dtype, w_dtype):
    """Each call adds one splitk launch; the result is within GEMM_ATOL of
    the split sum's plain model at the host's split count and of the plain
    twin, and its padding and dead rows are exactly 0."""
    rng = np.random.default_rng(len(sizes) + d + f)
    k = f if trans_w else d
    x, off, counts = _grouped_decode(rng, sizes, k, dev, x_dtype)
    w = _u(rng, (len(sizes), d, f), dev, w_dtype, k ** -0.5)
    before = dict(gg.LAUNCHES_BY_LOOP)
    with _within(120, "gemm_grouped"):
        out = gg.grouped_gemm(x, w, off, bm=16, policy=policy, trans_w=trans_w,
                              group_counts=counts)
        torch.cuda.synchronize()
    assert gg.LAUNCHES_BY_LOOP == {**before, "splitk": before["splitk"] + 1}
    splits = gg.grouped_splits(x.shape[0], d if trans_w else f, k, gt.sm_count(dev.index or 0))
    record_property("splits", splits)
    _hold(record_property, "model", out,
          gg.grouped_gemm_splitk_plain(x, w, off, policy=policy, splits=splits, trans_w=trans_w,
                                       group_counts=counts), GEMM_ATOL)
    _hold(record_property, "plain", out,
          gg.grouped_gemm_plain(x, w, off, bm=16, policy=policy, trans_w=trans_w), GEMM_ATOL)
    live = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    for g, n in enumerate(sizes):
        live[int(off[g]):int(off[g]) + n] = True
    assert not out[~live].any()


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("f", [256, 4096])
def test_grouped_gemm_splitk_skips_padding_and_dead_tiles(dev, policy, f):
    """Noise in the padding and dead rows: with the counts those rows come
    back exactly 0 and the live rows equal the zero-padded buffer's; without
    them every aligned row is computed (the noise rows too), dead tiles
    still 0."""
    rng = np.random.default_rng(f)
    x, off, counts = _grouped_decode(rng, [5, 0, 20, 16], 1152, dev, torch.bfloat16, noise=True)
    w = _u(rng, (4, 1152, f), dev, scale=1152 ** -0.5)
    live = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    for g, n in enumerate(counts.tolist()):
        live[int(off[g]):int(off[g]) + n] = True
    with _within(120, "gemm_grouped"):
        out = gg.grouped_gemm(x, w, off, bm=16, policy=policy, group_counts=counts)
        clean = gg.grouped_gemm(x * live[:, None], w, off, bm=16, policy=policy)
        every = gg.grouped_gemm(x, w, off, bm=16, policy=policy)
        torch.cuda.synchronize()
    assert not out[~live].any()
    assert torch.equal(out, clean)
    assert not every[int(off[-1]):].any()
    ref = gg.grouped_gemm_plain(x, w, off, bm=16, policy=policy)
    assert (every - ref).abs().max().item() <= GEMM_ATOL


def test_grouped_gemm_splitk_many_calls_finish(dev):
    """2000 calls each of bf16 and refine_ab at a split shape (3 row tiles x
    8 N tiles, K = 4096 in 11 splits) and of bf16 at Mixtral's decode wi,
    under the watchdog, each result equal to the first call's bit for bit
    (a ticket left set would show as a wrong result)."""
    rng = np.random.default_rng(15)
    x, off, counts = _grouped_decode(rng, [7, 12], 4096, dev, torch.bfloat16)
    w = _u(rng, (2, 4096, 512), dev, scale=4096 ** -0.5)
    xm, offm, cm = _grouped_decode(rng, [2, 0, 1, 0, 3, 0, 2, 0], 4096, dev, torch.bfloat16)
    wm = _u(rng, (8, 4096, 14336), dev, scale=4096 ** -0.5)
    assert gg.grouped_splits(x.shape[0], 512, 4096, gt.sm_count(dev.index or 0)) > 1
    calls = [lambda: gg.grouped_gemm(x, w, off, bm=16, group_counts=counts),
             lambda: gg.grouped_gemm(x, w, off, bm=16, policy="refine_ab", group_counts=counts),
             lambda: gg.grouped_gemm(xm, wm, offm, bm=16, group_counts=cm)]
    before = dict(gg.LAUNCHES_BY_LOOP)
    with _within(240, "gemm_grouped"):
        first = [c() for c in calls]
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(2000):
            for c, f in zip(calls, first):
                differ += (c() != f).sum()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    assert differ.item() == 0
    assert gg.LAUNCHES_BY_LOOP == {**before, "splitk": before["splitk"] + 6003}


# ---- whisper-medium's and internvl2-76b's shapes: the flash forward
# without a mask at hd 64 with Sq != Skv (the encoder's 1500 frames; cross-
# attention from a prompt and from one decode row; Skv = 1500 leaves a
# 28-row tail in the last 64-row stage), the decode at hd 64 G = 1 and at
# hd 128 G = 8, and the GEMMs onto whisper's 51865 = 64 * 810 + 25 vocab
# columns, whose logits rows end off a 16-byte boundary.  Smallest first,
# each call under the watchdog.

@pytest.mark.parametrize("sq", [1, 37, 1500])
def test_flash_attention_noncausal_hd64_against_1500_keys(dev, record_property, sq):
    rng = np.random.default_rng(sq)
    b = 4 if sq == 1 else 1
    q = (_u(rng, (b, sq, 4, 1, 64), dev) * 64 ** -0.5).to(torch.bfloat16)
    k, v = (_u(rng, (b, 1500, 4, 64), dev, torch.bfloat16) for _ in range(2))
    _hold_sm90_flash(record_property, q, k, v, ATTN_ATOL, causal=False)
    # the 28-row tail past the last whole 64-row stage reaches every row:
    # the plain version without it lands outside the bound
    out = af.flash_attention(q, k, v, causal=False)
    short = af.flash_attention_plain(q, k[:, :1472], v[:, :1472], causal=False)[0]
    assert (out - short).abs().max().item() > ATTN_ATOL


@pytest.mark.parametrize("kv,g,hd,paged_kv", [(16, 1, 64, False), (16, 1, 64, True),
                                               (8, 8, 128, False)])
def test_flash_decode_whisper_and_internvl2_heads(dev, record_property, kv, g, hd, paged_kv):
    """The dense and paged decode at whisper's heads and the dense one at
    internvl2's, B = 4 over a 1024-row linear cache at positions 0, 37, 611
    and 1023, split over CTAs, against the plain twin; one key short lands
    outside the bound."""
    rng = np.random.default_rng(kv * g + hd)
    s, ps = 1024, 8
    q = (_u(rng, (4, 1, kv, g, hd), dev) * hd ** -0.5).to(torch.bfloat16)
    pos = torch.tensor([0, 37, 611, 1023], dtype=torch.int32, device=dev)
    if paged_kv:
        n_log = paged.num_logical_pages(s, ps)
        cache = paged.init_paged(4, s, kv, hd, page_size=ps, num_pages=1 + 4 * n_log,
                                 device=dev)
        cache.page_table = (1 + torch.randperm(4 * n_log, device=dev)).reshape(
            4, n_log).to(torch.int32)
        cache.k_pages, cache.v_pages = (_u(rng, (1 + 4 * n_log, ps, kv, hd), dev, torch.bfloat16)
                                        for _ in range(2))
        kernel = lambda: ap.flash_paged_decode(q, cache, pos)  # noqa: E731
        plain = lambda p: ap.flash_paged_decode_plain(q, cache, p)  # noqa: E731
        lib = "attention_paged"
    else:
        k, v = (_u(rng, (4, s, kv, hd), dev, torch.bfloat16) for _ in range(2))
        kernel = lambda: af.flash_decode(q, k, v, pos)  # noqa: E731
        plain = lambda p: af.flash_decode_plain(q, k, v, p)  # noqa: E731
        lib = "attention_fused"
    with _within(120, lib):
        out = kernel()
        torch.cuda.synchronize()
    _hold(record_property, "out", out, plain(pos), ATTN_ATOL)
    assert (out - plain(pos - 1))[1:].abs().max().item() > ATTN_ATOL


@pytest.mark.parametrize("m", [4, 37])
@pytest.mark.parametrize("kernel", ["gemm_tiled", "gemm_refined"])
def test_gemm_onto_51865_vocab_columns(dev, record_property, kernel, m):
    """The unembed onto whisper's tied 51865 x 1024 table (NT, f32) from bf16
    rows, on both mainloops (``splitk`` at M = 4, ``sm90`` at M = 37): the
    whole product and the last 25 columns (the partial 64-column tile)
    within GEMM_ATOL of the plain twin."""
    rng = np.random.default_rng(m)
    n, k = 51865, 1024
    a = _u(rng, (m, k), dev, torch.bfloat16)
    table = _u(rng, (n, k), dev, scale=k ** -0.5)
    mod = gt if kernel == "gemm_tiled" else gr
    loop = "splitk" if m <= 16 else "sm90"
    before = dict(mod.LAUNCHES_BY_LOOP)
    with _within(120, kernel):
        if kernel == "gemm_tiled":
            out = gt.gemm_tiled(a, table.t())
        else:
            out = gr.gemm_refined(a, table.t(), policy="refine_ab")
        torch.cuda.synchronize()
    assert mod.LAUNCHES_BY_LOOP == {**before, loop: before[loop] + 1}
    ref = (gt.gemm_tiled_plain(a, table.t()) if kernel == "gemm_tiled"
           else gr.gemm_refined_plain(a, table.t(), "refine_ab"))
    assert out.shape == (m, n)
    _hold(record_property, "out", out, ref, GEMM_ATOL)
    _hold(record_property, "tail", out[:, -25:], ref[:, -25:], GEMM_ATOL)


# ---- the backward at the shapes the recurrent, audio and VLM trainings
# give it: whisper's cross-attention (Sq 448 against 1500 keys: dk/dv
# summed over seven 64-row query tiles) and encoder (1500 frames, no mask,
# hd 64), zamba2's shared block (hd 112: a 48-column tail past one 64-column
# block, G = 1) and internvl2's 64 heads on 8 kv (G = 8, hd 128), smallest
# first, each launch under the watchdog.  Control: the plain version with
# the mask flipped (causal for the unmasked shapes) lands outside the bound.

TRAIN_BWD_SHAPES = [   # (b, sq, skv, kv, g, hd, causal)
    (1, 448, 1500, 4, 1, 64, False),
    (1, 1024, 1024, 4, 1, 112, True),
    (1, 512, 512, 8, 8, 128, True),
    (2, 1500, 1500, 16, 1, 64, False),
]


@pytest.mark.parametrize("b,sq,skv,kv,g,hd,causal", TRAIN_BWD_SHAPES)
def test_flash_attention_bwd_sm90_train_shapes(dev, record_property, b, sq, skv, kv, g, hd,
                                               causal):
    q, k, v, do = _sm90_bwd_inputs(np.random.default_rng(sq + hd), dev, b, sq, skv, kv, g, hd,
                                   torch.bfloat16)
    _hold_sm90_bwd(record_property, q, k, v, do, causal=causal)
    out, lse = af.flash_attention_plain(q, k, v, causal=causal)
    di = af.bwd_delta(out, do)
    dq = af.flash_attention_bwd_dq(q, k, v, do, lse, di, causal=causal)
    wrong = af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal=not causal)
    assert (dq - wrong).abs().max().item() > BWD_ATOL


@pytest.mark.parametrize("what", ["forward", "dX", "dTable"])
def test_gemm_refined_train_unembed_at_51865(dev, record_property, what):
    """whisper's train unembed at refine_ab on the wgmma mainloop (448 rows,
    d 1024, vocab 51865 = 64 * 810 + 25: f32 rows of 207460 bytes): the
    forward (bf16 x NT table), dX (the logits' gradient against the table,
    K = 51865) and dTable (x^T against the logits' gradient, N = 51865)."""
    rng = np.random.default_rng(len(what))
    m, d, n = 448, 1024, 51865
    table = _u(rng, (n, d), dev, scale=d ** -0.5)
    x = _u(rng, (m, d), dev, torch.bfloat16)
    g_log = _u(rng, (m, n), dev, scale=n ** -0.5)
    a, b = {"forward": (x, table.t()), "dX": (g_log, table), "dTable": (x.t(), g_log)}[what]
    before = dict(gr.LAUNCHES_BY_LOOP)
    with _within(120, "gemm_refined"):
        out = gr.gemm_refined(a, b, policy="refine_ab")
        torch.cuda.synchronize()
    assert gr.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 1}
    ref = gr.gemm_refined_plain(a, b, "refine_ab")
    _hold(record_property, "out", out, ref, GEMM_ATOL)
    if what != "dX":
        _hold(record_property, "tail", out[:, -25:], ref[:, -25:], GEMM_ATOL)


def test_loss_scale_and_dual_half_on_the_card_equal_the_cpu(dev):
    """Loss scaling over a pattern of finite and non-finite steps, and a
    walk of 20 dual-half updates, bit-equal on the card and the CPU."""
    from repro_torch.optim import dual_half, loss_scale
    states = {d: loss_scale.init(initial=2.0 ** 10, growth_interval=2, device=d)
              for d in ("cpu", dev)}
    rng = np.random.default_rng(0)
    g = rng.standard_normal((5, 7)).astype(np.float32) * 100
    for flag in [1, 1, 1, 0, 1, 0, 0, 1, 1, 1]:
        gg_ = g if flag else np.full_like(g, np.inf)
        outs = {}
        for d, st in states.items():
            un, fin = loss_scale.unscale_and_check(st, {"g": torch.from_numpy(gg_).to(d)})
            states[d] = loss_scale.update(st, fin)
            outs[d] = (un["g"].cpu(), bool(fin))
        assert torch.equal(outs["cpu"][0], outs[dev][0]) and outs["cpu"][1] == outs[dev][1]
        assert float(states["cpu"].scale) == float(states[dev].scale)
        assert int(states["cpu"].good_steps) == int(states[dev].good_steps)
    w = torch.from_numpy(rng.uniform(-1, 1, (64, 33)).astype(np.float32))
    duals = {d: dual_half.to_dual({"w": w.to(d)}) for d in ("cpu", dev)}
    for _ in range(20):
        u = torch.from_numpy((rng.standard_normal((64, 33)) * 1e-3).astype(np.float32))
        duals = {d: dual_half.apply_update(x, {"w": u.to(d)}) for d, x in duals.items()}
        for half in ("hi", "lo"):
            assert torch.equal(getattr(duals["cpu"], half)["w"],
                               getattr(duals[dev], half)["w"].cpu())


def test_error_report_on_the_card_equals_the_cpus(dev):
    """core/error.py on card tensors (the f64 product formed and the
    metrics taken on the card) against the same report on the host: the
    max-norm of the same two arrays is the same number, and the report's
    errors against the f64 product agree to its rounding."""
    from repro_torch.core import error as err
    from repro_torch.core.ops import gemm
    a, b = err.random_operands(512, seed=1, device="cpu")
    results = {p: gemm(a, b, policy=p, backend="torch") for p in ("bf16", "refine_ab")}
    host = err.error_report(a, b, results)
    card = err.error_report(a.to(dev), b.to(dev), {k: v.to(dev) for k, v in results.items()})
    for p in results:
        for key in ("max_vs_f64", "rel_fro_vs_f64"):
            assert card[p][key] == pytest.approx(host[p][key], rel=1e-9), (p, key)
    c, ref = results["bf16"], a.double() @ b.double()
    assert err.max_norm_error(c.to(dev), ref.to(dev)) == err.max_norm_error(c, ref)


# ---- the wgmma mainloops' accumulation over a long K.  Operands whose
# products the tensor cores form exactly (bf16 values; for refine_ab f32
# values that are exactly bf16 hi + lo), so the only error left is the
# sum's.  The tensor cores' own f32 accumulation loses precision with the K
# it spans: a whole-K accumulator read 8-30x SGEMM's max error here on an
# H100 80GB HBM3 (tools/probe_accumulation.py), so each mainloop adds its
# accumulator into an f32 total every 256 of K (16 wgmma).  Held, as Fig. 8
# holds a rung against the torch route: the max error against the f64
# product within 2x the plain version's (SGEMM, TF32 off, on the same
# exact bf16 parts).  M = N = 2048 for the refined case: 256 output tiles,
# so the host does not split K (a split sum would promote by itself).

PROMOTION_CASES = [   # (kernel, m, k, A as f32 or bf16)
    ("gemm_tiled", 512, 16384, torch.bfloat16),
    ("gemm_refined", 2048, 16384, torch.bfloat16),
    ("gemm_refined", 2048, 16384, torch.float32),
]


@pytest.mark.parametrize("kernel,m,k,a_dtype", PROMOTION_CASES)
def test_wgmma_mainloops_promote_their_accumulator(dev, record_property, kernel, m, k, a_dtype):
    gen = torch.Generator(device=dev).manual_seed(k + m)

    def exact(shape, dtype):
        x = (2 * torch.rand(shape, generator=gen, device=dev) - 1).to(torch.bfloat16)
        if kernel == "gemm_tiled" or dtype == torch.bfloat16:
            return x if dtype == torch.bfloat16 else x.float()
        # lo under half an ulp of hi: split2 gives back exactly hi and lo
        u = 0.99 * (2 * torch.rand(shape, generator=gen, device=dev) - 1)
        return x.float() + (x.float() * u * 2.0 ** -9).to(torch.bfloat16).float()

    a = exact((m, k), a_dtype)
    b = exact((k, m), torch.bfloat16 if kernel == "gemm_tiled" else torch.float32)
    if kernel == "gemm_refined":
        assert gt.sm90_splits(1, m, m, k, gt.sm_count(dev.index or 0)) == 1
    mod = gt if kernel == "gemm_tiled" else gr
    before = dict(mod.LAUNCHES_BY_LOOP)
    with _within(120, kernel):
        out = (gt.gemm_tiled(a, b) if kernel == "gemm_tiled"
               else gr.gemm_refined(a, b, policy="refine_ab"))
        torch.cuda.synchronize()
    assert mod.LAUNCHES_BY_LOOP == {**before, "sm90": before["sm90"] + 1}
    plain = (gt.gemm_tiled_plain(a, b) if kernel == "gemm_tiled"
             else gr.gemm_refined_plain(a, b, "refine_ab"))
    ref = a.double() @ b.double()
    err = (out.double() - ref).abs().max().item()
    plain_err = (plain.double() - ref).abs().max().item()
    record_property("err", err)
    record_property("plain_err", plain_err)
    assert err <= 2 * plain_err, (err, plain_err)


def test_pool_at_two_replicas_equals_one_engine_on_the_kernel_routes(dev):
    """The serve stack's replica pool on the card: two engines sharing one
    params tree (smoke gemma3-1b, the serve policy on the kernel routes)
    give every request the tokens one engine gives it, and hand back every
    KV page."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import ops
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import api
    from repro_torch.serve.pool import ReplicaPool

    cfg = get_smoke("gemma3-1b")
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for layout in ("dense", "paged"):
        policy = ops.ExecutionPolicy(
            default="bf16", logits="refine_ab",
            backends={"gemm": "cuda", "attention": "cuda_fused"},
            require={"attention": ("decode", "paged_decode") if layout == "paged"
                     else ("decode",)})
        rng = np.random.default_rng(7)
        prompts = [rng.integers(2, cfg.vocab_size, 4 + 5 * i).astype(np.int32)
                   for i in range(6)]

        def stream():
            return [Request(rid=i, prompt=p, max_new_tokens=3 + i) for i, p in enumerate(prompts)]

        def factory(idx, pol):
            e = ServeEngine(cfg, batch_size=2, max_ctx=64, policy=pol, device=dev,
                            replica=str(idx), kv_layout=layout)
            e.load(params)
            return e

        one = stream()
        factory(0, policy).run(one)
        two = stream()
        pool = ReplicaPool(cfg, params, replicas=2, batch_size=2, max_ctx=64, policy=policy,
                           engine_factory=factory)
        with _within(300, "gemm_tiled", "gemm_refined", "attention_fused", "attention_paged"):
            pool.run(two)
            torch.cuda.synchronize()
        assert all(r.engine.tokens_generated > 0 for r in pool.replicas)
        assert [r.out_tokens for r in two] == [r.out_tokens for r in one], layout
        assert pool.pages_outstanding() == 0


def test_mesh_parity_on_two_ranks_sharing_the_card(dev):
    """Two gloo ranks on this card (``runtime.world.spawn`` with
    ``share_card``) run decode-size sharded routes, every rank's result
    bit-equal to one device's: a block cut on whole tiles plans its splits
    as the whole problem does (``kernels.gemm_tiled.SM_SHARE``).  The
    world has its own timeout, so a hung collective fails the test."""
    from repro_torch.kernels import _build
    from repro_torch.runtime import mesh_checks, world
    _build.build_all()
    cases = [dict(c, mesh=c["mesh"].replace("dp=2,tp=2", "tp=2").replace("ep=2,tp=2", "ep=2"))
             for c in mesh_checks.parity_cases("card")
             if c["name"] in ("gemm_col_decode_bf16", "attn_decode_bf16",
                              "grouped_decode_ep2_tp2_bf16")]
    want = {c["name"]: mesh_checks.run_case(c, dev)["out"].float().cpu().numpy() for c in cases}
    ranks = world.spawn(mesh_checks.parity_worker, 2, args=(cases, "cuda"), device="cuda",
                        share_card=True, timeout=300)
    for c in cases:
        held = [r["results"][c["name"]]["out"] for r in ranks]
        assert held[0][0] == held[1][0], c["name"]
        np.testing.assert_array_equal(held[0][1], want[c["name"]], err_msg=c["name"])
    assert all(r["launches"]["grouped_gemm"] and r["launches"]["flash_decode"] for r in ranks)
