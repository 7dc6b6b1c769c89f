"""The host side of the port's refined GEMM kernels, and the plain models of
their arithmetic against ``repro``, on the CPU.

``gemm_refined`` runs the refined wgmma mainloop above M = 16
(``csrc/gemm_refined_sm90.cuh``) and the split-K weight stream at or below
(``csrc/gemm_splitk.cuh``).  Both skip the terms that read a bf16
operand's lo (identically zero: ``kept_terms``), and both may split K over
CTAs, the last CTA of a tile summing the partials in split order.  Here:
the wgmma mainloop's split chooser (``sm90_splits``) gives whole K tiles
that cover K exactly, none empty, whole waves where a last partial wave
would idle the card (train dX: 144 tiles on 132 SMs) and one split where
the tiles fill it; the kept terms sum to the plain product bit for bit; and
the split sum's plain model (``gemm_refined_splitk_plain``) agrees with
``repro``'s kernel in interpret mode and, at one split, is the plain twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm_refined as jgr
from repro_torch.core import precision as prec
from repro_torch.kernels import gemm_refined as tgr
from repro_torch.kernels import gemm_tiled as tgt

# Kernel and plain sums: the same bf16 terms, f32 sums in another order
# (the card tests' GEMM_ATOL).
GEMM_ATOL = 1e-3
SMS = (132, 114, 16)
POLICIES = ("refine_a", "bf16x3", "refine_ab")

# (batch, m, n, k): gemma3-1b's train unembed (dX, dTable, the forward), its
# prefill unembed and MLP shapes, rwkv6-7b's prefill unembed, small, ragged
# and batched shapes
SM90_SHAPES = [(1, 2048, 1152, 262144), (1, 1152, 262144, 2048), (1, 2048, 262144, 1152),
               (1, 665, 262144, 1152), (1, 700, 6912, 1152), (1, 2048, 1152, 6912),
               (1, 704, 65536, 4096), (1, 17, 40, 70), (1, 200, 300, 6912),
               (2, 130, 72, 40), (3, 64, 128, 64), (1, 256, 256, 4096)]


def _check_ranges(ranges, total):
    """Whole tiles, contiguous, covering [0, total) exactly, none empty."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(hi > lo for lo, hi in ranges)


def _tiles(batch, m, n):
    return batch * -(-m // tgt.SM90_BM) * -(-n // tgt.SM90_BN)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("batch,m,n,k", SM90_SHAPES)
def test_sm90_splits_are_whole_k_tiles(batch, m, n, k, sms):
    splits = tgt.sm90_splits(batch, m, n, k, sms)
    k_tiles = -(-k // tgt.SM90_BK)
    tiles = _tiles(batch, m, n)
    ranges = tgt.split_ranges(k_tiles, splits)
    _check_ranges(ranges, k_tiles)
    if splits > 1:
        assert all(hi - lo >= tgt.SM90_MIN_TILES for lo, hi in ranges[:-1])
        # the workspace holds every CTA's partial, the tickets every tile
        assert tiles * splits <= tgt.SM90_SLOTS_PER_SM * sms
    # never more work on the busiest SM than one split puts there
    waves = lambda s: -(-tiles * s // sms) * -(-k_tiles // s)  # noqa: E731
    assert waves(splits) <= waves(1)


def test_sm90_splits_give_the_train_dx_whole_waves():
    """gemma3-1b's dX (2048 x 262144 x 1152: 16 x 9 = 144 output tiles) on
    132 SMs: one split runs a second wave of 12 CTAs (two waves for 1.09 of
    work); the chooser picks whole waves, 11 splits of 144 tiles = 12."""
    batch, m, n, k, sms = 1, 2048, 1152, 262144, 132
    tiles = _tiles(batch, m, n)
    assert tiles == 144
    splits = tgt.sm90_splits(batch, m, n, k, sms)
    assert splits > 1 and tiles * splits % sms == 0
    assert splits == 11
    _check_ranges(tgt.split_ranges(k // tgt.SM90_BK, splits), k // tgt.SM90_BK)


@pytest.mark.parametrize("sms", SMS)
def test_sm90_one_split_when_the_tiles_fill_the_card(sms):
    assert tgt.sm90_splits(1, 128, 128 * sms, 262144, sms) == 1         # one whole wave
    assert tgt.sm90_splits(2, 128 * sms, 128, 65536, sms) == 1          # two, batched
    assert tgt.sm90_splits(1, 1152, 262144, 2048, sms) == 1             # train dTable
    assert tgt.sm90_splits(1, 2048, 262144, 1152, sms) == 1             # train forward
    assert tgt.sm90_splits(1, 16, 1152, 262144, sms) == 1               # M <= 16: split-K
    assert tgt.sm90_splits(1, 64, 128, 4 * 64 * tgt.SM90_MIN_TILES, sms) > 1


@pytest.mark.parametrize("batch,m,n,k", [(1, 4, 262144, 1152), (1, 4, 65536, 4096),
                                         (1, 16, 200, 300), (1, 17, 200, 300),
                                         (1, 2048, 1152, 262144)])
def test_refined_splits_follow_the_mainloop(batch, m, n, k):
    for sms in SMS:
        want = (tgt.splitk_splits if m <= 16 else tgt.sm90_splits)(batch, m, n, k, sms)
        assert tgr.refined_splits(batch, m, n, k, sms) == want


def _u(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.uniform(-1, 1, shape)).astype(np.float32))


# the terms each rung multiplies: refine_ab f32 x f32 4, on a bf16 A or B 2;
# bf16x3 on a bf16 A 2; refine_a on a bf16 A 1
TERM_COUNTS = {("refine_ab", False, False): 4, ("refine_ab", True, False): 2,
               ("refine_ab", False, True): 2, ("refine_ab", True, True): 1,
               ("bf16x3", False, False): 3, ("bf16x3", True, False): 2,
               ("bf16x3", False, True): 2, ("bf16x3", True, True): 1,
               ("refine_a", False, False): 2, ("refine_a", True, False): 1,
               ("refine_a", False, True): 2, ("refine_a", True, True): 1}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("a_bf16,b_bf16", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_kept_terms_sum_to_the_plain_product(policy, a_bf16, b_bf16):
    """Dropping the terms that read a bf16 operand's lo (exact zeros) leaves
    the plain twin's sum unchanged, bit for bit, in policy_terms order."""
    rng = np.random.default_rng(len(policy) + 2 * a_bf16 + b_bf16)
    a, b = _u(rng, (37, 300)), _u(rng, (300, 70), 300 ** -0.5)
    a = a.to(torch.bfloat16) if a_bf16 else a
    b = b.to(torch.bfloat16) if b_bf16 else b
    kept = tgr.kept_terms(policy, a_bf16, b_bf16)
    assert len(kept) == TERM_COUNTS[(policy, a_bf16, b_bf16)]
    assert list(kept) == [t for t in prec.policy_terms(policy) if t in kept]
    assert kept[-1] == (0, 0)
    a_terms, b_terms = prec.operand_terms(a, b, policy)
    out = None
    for ta, tb in kept:
        part = torch.matmul(a_terms[ta].float(), b_terms[tb].float())
        out = part if out is None else out + part
    assert torch.equal(out, tgr.gemm_refined_plain(a, b, policy))


# (m, n, k, bk, a_bf16): repro's blocks must divide its operands; K spans
# 1-18 of the kernels' 64-deep tiles
REPRO_CASES = [(4, 200, 1152, 64, True), (4, 200, 1152, 64, False), (48, 256, 640, 64, False),
               (130, 72, 300, 300, False), (16, 128, 2048, 128, True), (1, 96, 192, 64, False)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("m,n,k,bk,a_bf16", REPRO_CASES)
def test_refined_split_model_matches_repro(policy, m, n, k, bk, a_bf16):
    rng = np.random.default_rng(m + n + k)
    a, b = _u(rng, (m, k)), _u(rng, (k, n), k ** -0.5)
    if a_bf16:
        a = a.to(torch.bfloat16)
    ref = np.asarray(jgr.gemm_refined(jnp.asarray(a.float().numpy()), jnp.asarray(b.numpy()),
                                      policy=policy, bm=m, bn=n, bk=bk, interpret=True))
    plain = tgr.gemm_refined_plain(a, b, policy)
    k_tiles = -(-k // tgt.SPLITK_BK)
    chosen = {tgr.refined_splits(1, m, n, k, sms) for sms in SMS}
    for splits in sorted({1, 2, 3} | chosen):
        if splits > k_tiles:
            continue
        out = tgr.gemm_refined_splitk_plain(a, b, policy, splits)
        assert out.dtype == torch.float32 and out.shape == (m, n)
        assert np.abs(out.numpy() - ref).max() <= GEMM_ATOL
        assert (out - plain).abs().max().item() <= GEMM_ATOL
    assert torch.equal(tgr.gemm_refined_splitk_plain(a, b, policy, 1), plain)


@pytest.mark.parametrize("policy", POLICIES)
def test_refined_split_model_batched_and_nt(policy):
    """A batch of two with an NT (K-contiguous) B view and a bf16 A, as the
    decode unembed hands them."""
    rng = np.random.default_rng(7)
    a = _u(rng, (2, 4, 1152)).to(torch.bfloat16)
    b = _u(rng, (2, 200, 1152), 1152 ** -0.5).transpose(1, 2)
    plain = tgr.gemm_refined_plain(a, b, policy)
    assert torch.equal(tgr.gemm_refined_splitk_plain(a, b, policy, 1), plain)
    for splits in (2, 3, 18):
        out = tgr.gemm_refined_splitk_plain(a, b, policy, splits)
        assert out.shape == (2, 4, 200)
        assert (out - plain).abs().max().item() <= GEMM_ATOL
