"""The host side of the port's split decode kernels, and the plain models
of their arithmetic against ``repro``, on the CPU.

``gemm_tiled`` at M <= 16 splits K over CTAs (``csrc/gemm_splitk.cuh``)
and the bf16 decode splits its KV walk (``csrc/flash_common.cuh``); the
host picks the split counts (``splitk_splits``, ``decode_splits``) and the
last CTA of each output tile sums the partials in split order.  Here: every
split is whole K or KV tiles, the splits cover the range exactly and none
is empty; one split when the N tiles fill the card; the dense and paged
decode pick the same count.  The plain models of the two sums
(``gemm_tiled_splitk_plain``, ``flash_decode_split_plain``) are held
against ``repro``'s kernels in interpret mode and against the port's plain
twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_fused as jaf
from repro.kernels import gemm_tiled as jgt
from repro_torch.core.ops import paged
from repro_torch.kernels import attention_fused as taf
from repro_torch.kernels import attention_paged as tap
from repro_torch.kernels import gemm_tiled as tgt

# Kernel and plain sums: the same bf16 products, f32 sums in another order
# (the card tests' GEMM_ATOL).
GEMM_ATOL = 1e-3
# The split decode's combine at f32 (no rounding of probabilities): sums in
# another order and exp ulps only (tests/test_torch_attention.py's ATOL).
ATOL = 1e-4
# At bf16 a split rounds each probability against its own running max, the
# one-walk kernels against the walk's: each p is within 2^-9 of itself in
# both, so out = sum(p v) / l moves by at most 2 * 2^-9 * max |v| (|v| <= 1
# here).
SPLIT_BF16_ATOL = 2.0 ** -8
SMS = (132, 114, 16)

# (batch, m, n, k): gemma3-1b's decode linears and unembed, rwkv6-7b's,
# ragged and batched shapes
GEMM_SHAPES = [(1, 4, 1024, 1152), (1, 4, 256, 1152), (1, 4, 1152, 1024), (1, 4, 6912, 1152),
               (1, 4, 1152, 6912), (1, 4, 262144, 1152), (1, 4, 4096, 4096),
               (1, 4, 14336, 4096), (1, 4, 4096, 14336), (1, 1, 17, 5), (1, 16, 200, 300),
               (3, 4, 200, 1152), (1, 16, 6912, 6912)]


def _check_ranges(ranges, total, allow_empty=False):
    """Whole tiles, contiguous, covering [0, total) exactly."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(hi > lo for lo, hi in ranges) or allow_empty


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("batch,m,n,k", GEMM_SHAPES)
def test_splitk_splits_are_whole_k_tiles(batch, m, n, k, sms):
    splits = tgt.splitk_splits(batch, m, n, k, sms)
    k_tiles = -(-k // tgt.SPLITK_BK)
    tiles = batch * -(-n // tgt.SPLITK_BN)
    ranges = tgt.split_ranges(k_tiles, splits)
    _check_ranges(ranges, k_tiles)
    if splits > 1:
        assert all(hi - lo >= tgt.SPLITK_MIN_TILES for lo, hi in ranges[:-1])
        # the workspace holds every CTA's partial, the tickets every tile
        assert tiles * splits * tgt.SPLITK_PART <= tgt.WS_SLOTS_PER_SM * sms * tgt.WS_SLOT_FLOATS
        assert tiles <= tgt.TICKETS_PER_SM * sms
    # the grid reaches twice the SM count wherever K allows it
    if tiles < 2 * sms and k_tiles // tgt.SPLITK_MIN_TILES * tiles >= 2 * sms:
        assert tiles * splits >= 2 * sms
    if tiles >= 2 * sms:
        assert splits == 1


@pytest.mark.parametrize("sms", SMS)
def test_one_split_when_the_n_tiles_fill_the_card(sms):
    vocab = 262144
    assert tgt.splitk_splits(1, 4, vocab, 1152, sms) == 1
    assert tgt.splitk_splits(2 * sms, 4, 64, 6912, sms) == 1
    assert tgt.splitk_splits(1, 17, 1152, 6912, sms) == 1     # M > 16: the wgmma mainloop
    assert tgt.splitk_splits(1, 4, 1152, 6912, sms) > 1


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,kv,s_cache", [(4, 1, 512), (4, 1, 1024), (4, 8, 1024), (1, 1, 40),
                                          (6, 2, 100), (64, 8, 4096), (4, 1, 32)])
def test_decode_splits_are_whole_kv_tiles(b, kv, s_cache, sms):
    splits = taf.decode_splits(b, kv, s_cache, sms)
    tiles = -(-s_cache // taf.BKV)
    _check_ranges(tgt.split_ranges(tiles, splits), tiles)
    assert 1 <= splits <= taf.DECODE_MAX_SPLITS
    if splits > 1:
        assert b * kv * splits <= tgt.WS_SLOTS_PER_SM * sms
    if b * kv >= 2 * sms:
        assert splits == 1
    elif tiles >= -(-2 * sms // (b * kv)) and tiles <= taf.DECODE_MAX_SPLITS:
        assert b * kv * splits >= 2 * sms
    # only the bf16 rung splits
    for rung in taf.FUSED_POLICIES[1:]:
        assert taf.decode_splits(b, kv, s_cache, sms, rung) == 1
    # on the card each row splits its live tiles (up to pos); splits past
    # them walk none
    for pos in (0, 5, 31, 32, s_cache - 1, s_cache + 7):
        live = -(-min(s_cache, pos + 1) // taf.BKV)
        _check_ranges(tgt.split_ranges(live, splits), live, allow_empty=True)


@pytest.mark.parametrize("b,kv,s_cache,ps", [(4, 1, 512, 8), (4, 8, 1024, 8), (2, 1, 100, 5),
                                             (3, 2, 72, 16)])
def test_dense_and_paged_decode_pick_the_same_splits(b, kv, s_cache, ps):
    """Both wrappers call one rule on (B, Kv, the cache's logical rows, SM
    count); a paged cache's rows are the dense cache's."""
    assert tap.decode_splits is taf.decode_splits
    cache = paged.init_paged(b, s_cache, kv, 16, page_size=ps, num_pages=8, device="cpu")
    k_dense, _ = paged.gather_dense(cache)
    assert cache.s_cache == k_dense.shape[1] == s_cache
    for sms in SMS:
        assert (taf.decode_splits(b, kv, cache.s_cache, sms)
                == taf.decode_splits(b, kv, k_dense.shape[1], sms))


# (m, n, k, bk): repro's blocks must divide its operands
GEMM_CASES = [(4, 200, 1152, 64), (16, 256, 2048, 64), (1, 128, 300, 300)]


@pytest.mark.parametrize("m,n,k,bk", GEMM_CASES)
def test_splitk_model_matches_repro(m, n, k, bk):
    rng = np.random.default_rng(m + n + k)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = (rng.uniform(-1, 1, (k, n)) * k ** -0.5).astype(np.float32)
    ref = np.asarray(jgt.gemm_tiled(jnp.asarray(a), jnp.asarray(b), bm=m, bn=n, bk=bk,
                                    interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    k_tiles = -(-k // tgt.SPLITK_BK)
    for splits in sorted({1, 2, 3, tgt.splitk_splits(1, m, n, k, 132)}):
        if splits > k_tiles:
            continue
        out = tgt.gemm_tiled_splitk_plain(ta, tb, splits)
        assert out.dtype == torch.float32 and out.shape == (m, n)
        assert np.abs(out.numpy() - ref).max() <= GEMM_ATOL
        assert (out - tgt.gemm_tiled_plain(ta, tb)).abs().max().item() <= GEMM_ATOL
    assert torch.equal(tgt.gemm_tiled_splitk_plain(ta, tb, 1), tgt.gemm_tiled_plain(ta, tb))


def test_splitk_model_batched_and_nt():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 1152)).astype(np.float32))
    b = torch.from_numpy((rng.uniform(-1, 1, (3, 200, 1152)) / 34).astype(np.float32))
    bt = b.transpose(1, 2)
    ref = tgt.gemm_tiled_plain(a, bt)
    for splits in (2, 5, 18):
        assert (tgt.gemm_tiled_splitk_plain(a, bt, splits) - ref).abs().max().item() <= GEMM_ATOL


S_CACHE, B, KV, G, HD = 100, 6, 2, 2, 16
POS = np.array([0, 5, 31, 32, S_CACHE - 1, S_CACHE + 7], np.int32)


def _decode_qkv(seed):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-1, 1, (B, 1, KV, G, HD)) * HD ** -0.5).astype(np.float32)
    k = rng.uniform(-1, 1, (B, S_CACHE, KV, HD)).astype(np.float32)
    v = rng.uniform(-1, 1, (B, S_CACHE, KV, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("ring", [True, False])
def test_split_decode_model_matches_repro(ring, precision):
    """Splits 1..8 over the 4 tiles of a 100-row cache, at positions 0, 5,
    31, 32, S - 1 and past S: with 8 splits every row has splits that walk
    no live tile (l = 0, m = NEG_INF), and at pos 0 all but one."""
    q, k, v = _decode_qkv(3)
    window = S_CACHE if ring else None
    kw = dict(window=window, softcap=2.0, precision=precision)
    ref = np.asarray(jaf.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(POS), block_kv=32, interpret=True, **kw))
    tq, tk, tv, tpos = (torch.from_numpy(x) for x in (q, k, v, POS))
    plain = taf.flash_decode_plain(tq, tk, tv, tpos, **kw)
    assert torch.equal(taf.flash_decode_split_plain(tq, tk, tv, tpos, 1, **kw), plain)
    tol = ATOL if precision == "f32" else SPLIT_BF16_ATOL
    for splits in (2, 3, 4, 8):
        out = taf.flash_decode_split_plain(tq, tk, tv, tpos, splits, **kw)
        assert out.shape == q.shape and torch.isfinite(out).all()
        assert np.abs(out.numpy() - ref).max() <= tol, splits
        assert (out - plain).abs().max().item() <= tol, splits


def test_split_decode_model_is_one_walk_where_later_maxima_rise():
    """Where every later split's running max is the walk's (keys that grow
    with the slot), the split sum is the one walk's but for f32 order: the
    same probabilities round to the same bf16 values."""
    q, k, v = _decode_qkv(4)
    ramp = np.linspace(0.1, 1.0, S_CACHE, dtype=np.float32)[None, :, None, None]
    k = np.abs(k[:, :1]) * ramp                 # scores rise with the slot
    q = np.abs(q)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    pos = torch.full((B,), S_CACHE - 1, dtype=torch.int32)
    plain = taf.flash_decode_plain(tq, tk, tv, pos)
    for splits in (2, 4):
        assert (taf.flash_decode_split_plain(tq, tk, tv, pos, splits) - plain).abs().max() <= 1e-6
