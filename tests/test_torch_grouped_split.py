"""The host side of the grouped GEMM's decode regime on the split-K weight
stream, and the plain model of its arithmetic against ``repro``, on the
CPU.

At a 16-row CTA tile (every decode call of the MoE FFN) the grouped
forward and dx at bf16 and the refined rungs run ``csrc/gemm_splitk.cuh``
in its group-rows mode: grid (64-column N tiles, K splits, 16-row tiles of
the sorted buffer), each tile against its group's expert, and a tile with
no live row -- dead, or only its run's alignment padding by
``group_counts`` -- loads nothing and stores zeros.  Here: the host's split
count (``grouped_splits``) is whole K tiles that cover K exactly, none
empty, within the workspace, one split where the tiles fill the card; the
liveness rule (``tile_live_rows``) on dead tiles, padding-only tiles of
empty experts, a zero-width group and a run over two tiles; the split sum's
plain model (``grouped_gemm_splitk_plain``) against ``repro``'s kernel in
interpret mode and the port's plain twin; padding rows exactly zero; and
the MoE FFN bit-equal with and without the counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm_grouped as jgg
from repro_torch.core import ops
from repro_torch.kernels import gemm_grouped as tgg
from repro_torch.kernels import gemm_tiled as tgt
from repro_torch.models import moe

# Kernel and plain sums: the same bf16 terms, f32 sums in another order
# (the card tests' GEMM_ATOL).
GEMM_ATOL = 1e-3
SMS = (132, 114, 16)
ROWS = tgg.ROW_TILE

# (n_rows, n, k): Mixtral's decode wi / wg, wo and dx (4 tokens x top-2:
# 144 rows, 9 tiles), DBRX's decode (16 experts, top-4: 272 rows), a
# 44-token Mixtral prefill at bm 96 (1008 rows), small and ragged shapes
SPLIT_SHAPES = [(144, 14336, 4096), (144, 4096, 14336), (272, 10752, 6144),
                (272, 6144, 10752), (1008, 14336, 4096), (48, 200, 300), (64, 96, 1152),
                (16, 64, 6912), (40, 80, 192), (33, 17, 5)]


def _check_ranges(ranges, total):
    """Whole tiles, contiguous, covering [0, total) exactly, none empty."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n_rows,n,k", SPLIT_SHAPES)
def test_grouped_splits_are_whole_k_tiles(n_rows, n, k, sms):
    splits = tgg.grouped_splits(n_rows, n, k, sms)
    k_tiles = -(-k // tgt.SPLITK_BK)
    row_tiles = -(-n_rows // ROWS)
    tiles = row_tiles * -(-n // tgt.SPLITK_BN)
    _check_ranges(tgt.split_ranges(k_tiles, splits), k_tiles)
    assert splits == tgt.splitk_splits(row_tiles, ROWS, n, k, sms)
    if splits > 1:
        assert all(hi - lo >= tgt.SPLITK_MIN_TILES
                   for lo, hi in tgt.split_ranges(k_tiles, splits)[:-1])
        # the workspace holds a partial for every tile of the grid, live or
        # not, and the tickets every tile
        assert tiles * splits * tgt.SPLITK_PART <= tgt.WS_SLOTS_PER_SM * sms * tgt.WS_SLOT_FLOATS
        assert tiles <= tgt.TICKETS_PER_SM * sms
    if tiles >= 2 * sms:
        assert splits == 1


@pytest.mark.parametrize("sms", SMS)
def test_one_split_when_the_tiles_fill_the_card(sms):
    for n, k in ((14336, 4096), (4096, 14336)):       # Mixtral's decode wi / wg and wo
        assert tgg.grouped_splits(144, n, k, sms) == 1
    assert tgg.grouped_splits(32, 128, 4096, sms) > 1      # 2 x 2 tiles: K splits fill it


def _off(aligned):
    return torch.tensor(np.concatenate([[0], np.cumsum(aligned)]), dtype=torch.int32)


def _live_by_rows(off, n_rows, counts):
    """The rule row by row: row r is live when it lies before offsets[E]
    and before its group's offsets[g] + counts[g]."""
    off, live = off.tolist(), []
    for r in range(n_rows):
        g = max(i for i in range(len(off) - 1) if off[i] <= r) if r < off[-1] else None
        end = None if g is None else (off[g + 1] if counts is None
                                      else min(off[g + 1], off[g] + counts[g]))
        live.append(g is not None and r < end)
    return live


# (aligned run sizes, real counts or None, buffer rows)
LIVENESS = {
    "dead tiles past offsets[E]": ([16, 16], [3, 9], 64),
    "padding-only tiles of empty experts": ([16, 16, 16, 16], [3, 0, 5, 0], 80),
    "a zero-width group": ([16, 0, 32], [10, 0, 20], 64),
    "a run over two tiles": ([32, 16], [20, 16], 48),
    "no counts: every aligned row": ([32, 16, 16], None, 80),
    "a ragged buffer end": ([16, 24], [16, 24], 40),
}


@pytest.mark.parametrize("case", list(LIVENESS))
def test_tile_live_rows(case):
    aligned, counts, n_rows = LIVENESS[case]
    off = _off(aligned)
    cnt = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    live = tgg.tile_live_rows(off, n_rows, cnt)
    rows = _live_by_rows(off, n_rows, counts)
    assert len(live) == -(-n_rows // ROWS)
    for z, m in enumerate(live):
        tile = rows[z * ROWS:(z + 1) * ROWS]
        assert sum(tile) == m and all(tile[:m])       # the live rows lead the tile
    if case == "padding-only tiles of empty experts":
        assert live == [3, 0, 5, 0, 0]
    if case == "a zero-width group":
        assert live == [10, 16, 4, 0]
    if case == "a run over two tiles":
        assert live == [16, 4, 16]


def _layout(rng, sizes, width, dtype, noise=False):
    """A buffer sorted by group, each run aligned to 16 rows (at least one
    tile, as the dispatcher does), two dead tiles after them; padding rows
    zero (or noise).  Returns x, offsets and the real counts."""
    aligned = np.maximum(-(-np.asarray(sizes) // ROWS) * ROWS, ROWS)
    off = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
    x = np.zeros((int(off[-1]) + 2 * ROWS, width), np.float32)
    if noise:
        x[:] = rng.uniform(-1, 1, x.shape)
    for g, n in enumerate(sizes):
        x[off[g]:off[g] + n] = rng.uniform(-1, 1, (n, width))
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(off),
            torch.tensor(sizes, dtype=torch.int32))


SIZES = [5, 0, 20, 16]      # an empty expert, a run over two tiles, a full tile
D, F = 192, 320             # 3 and 5 K tiles of 64


@pytest.mark.parametrize("policy", ["bf16", "refine_ab"])
@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_splitk_model_matches_repro(policy, trans_w, dtype):
    """The split sum's model at every split count the host could pick here
    (and 1-3) against ``repro``'s ``grouped_gemm`` at bm 16 in interpret
    mode (dx: the forward against w[g]^T) and against the port's plain
    twin."""
    rng = np.random.default_rng(len(policy) + 2 * trans_w)
    k = F if trans_w else D
    x, off, counts = _layout(rng, SIZES, k, dtype)
    w = torch.from_numpy(rng.uniform(-1, 1, (len(SIZES), D, F)).astype(np.float32) * k ** -0.5)
    jw = w.transpose(1, 2) if trans_w else w
    ref = np.asarray(jgg.grouped_gemm(
        jnp.asarray(x.float().numpy()), jnp.asarray(jw.contiguous().numpy()),
        jnp.asarray(off.numpy()), precision=policy, bm=ROWS, interpret=True))
    plain = tgg.grouped_gemm_plain(x, w, off, bm=ROWS, policy=policy, trans_w=trans_w)
    n = D if trans_w else F
    chosen = {tgg.grouped_splits(x.shape[0], n, k, sms) for sms in SMS}
    for splits in sorted({1, 2, 3} | chosen):
        for cnt in (counts, None):
            out = tgg.grouped_gemm_splitk_plain(x, w, off, policy=policy, splits=splits,
                                                trans_w=trans_w, group_counts=cnt)
            assert out.dtype == torch.float32 and out.shape == (x.shape[0], n)
            assert np.abs(out.numpy() - ref).max() <= GEMM_ATOL, (splits, cnt is None)
            assert (out - plain).abs().max().item() <= GEMM_ATOL


@pytest.mark.parametrize("policy", tgg.SPLITK_POLICIES)
def test_padding_rows_are_exact_zeros(policy):
    """With the counts, every row past a run's real rows and every dead
    row comes back exactly 0 whatever x holds there (the kernel loads
    nothing for them), in the model and in the plain twin; the real rows
    agree with the rows computed without the counts on a zero-padded
    buffer."""
    rng = np.random.default_rng(7)
    x, off, counts = _layout(rng, SIZES, D, torch.float32, noise=True)
    w = torch.from_numpy(rng.uniform(-1, 1, (len(SIZES), D, F)).astype(np.float32) * D ** -0.5)
    live = torch.tensor(_live_by_rows(off, x.shape[0], counts.tolist()))
    for out in (tgg.grouped_gemm_splitk_plain(x, w, off, policy=policy, splits=2,
                                              group_counts=counts),
                tgg.grouped_gemm_plain(x, w, off, bm=ROWS, policy=policy, group_counts=counts),
                tgg.grouped_gemm(x, w, off, bm=ROWS, policy=policy, group_counts=counts)):
        assert not out[~live].any()
        assert out[live].abs().min() > 0
    clean = x * live[:, None]
    assert torch.equal(
        tgg.grouped_gemm_splitk_plain(clean, w, off, policy=policy, splits=2),
        tgg.grouped_gemm_splitk_plain(x, w, off, policy=policy, splits=2, group_counts=counts))


def test_the_other_rungs_have_no_split_model():
    x, off, _ = _layout(np.random.default_rng(1), [3], 64, torch.float32)
    for policy in ("f32", "bf16x6", "fp8x3", "int8"):
        assert policy not in tgg.SPLITK_POLICIES
        with pytest.raises(ValueError, match="split-K"):
            tgg.grouped_gemm_splitk_plain(x, torch.zeros(1, 64, 8), off, policy=policy, splits=1)


@pytest.mark.parametrize("policy", ["bf16", "refine_ab", "f32"])
@pytest.mark.parametrize("tokens", [4, 13])
def test_sorted_ffn_is_bit_equal_with_and_without_the_counts(policy, tokens, monkeypatch):
    """The MoE FFN's sorted dispatch hands the grouped family the real
    counts; dropping them changes no bit of its output (bm 16 at 4 tokens
    x top-2; 32 at 13)."""
    gen = torch.Generator().manual_seed(tokens)
    e, d, ff, top_k = 8, 64, 96, 2
    p = {k: {"w": torch.randn(shape, generator=gen) * shape[1] ** -0.5}
         for k, shape in (("wi", (e, d, ff)), ("wg", (e, d, ff)), ("wo", (e, ff, d)))}
    xf = torch.randn((tokens, d), generator=gen).to(torch.bfloat16)
    probs = torch.softmax(torch.randn((tokens, e), generator=gen), -1)
    gate_vals, expert_idx = moe._top_k(probs, top_k)
    route = ops.ExecutionPolicy(default=policy,
                                backends={"grouped": "cuda_grouped"}).for_("moe")
    kw = dict(num_experts=e, top_k=top_k, mlp_kind="swiglu", route=route, dtype=torch.bfloat16)
    seen = []
    grouped_matmul = ops.grouped_matmul

    def spy(*a, **k):
        seen.append(k.get("group_counts"))
        return grouped_matmul(*a, **k)

    monkeypatch.setattr(ops, "grouped_matmul", spy)
    with_counts = moe._sorted_ffn(p, xf, gate_vals, expert_idx, **kw)
    assert len(seen) == 3 and all(c is not None for c in seen)
    assert seen[0].dtype == torch.int32
    assert torch.equal(seen[0], torch.bincount(expert_idx.flatten(), minlength=e).int())
    monkeypatch.setattr(ops, "grouped_matmul",
                        lambda *a, group_counts=None, **k: grouped_matmul(*a, **k))
    without = moe._sorted_ffn(p, xf, gate_vals, expert_idx, **kw)
    assert torch.equal(with_counts, without)
