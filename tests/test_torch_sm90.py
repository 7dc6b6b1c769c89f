"""The quantized grouped dW rungs' quantize pass on the CPU
(``gemm_grouped.grouped_dw_scales``, its plain twin), against the JAX
package on the same numpy inputs: the pow2 scales of every 64 x 32 tile of
x^T and 32 x 128 tile of dy, each run tiled from its first row and ending
at its own end.  Held bit for bit against the scales ``repro``'s quantizer
takes over each tile alone (``_pow2_scale``, and ``qdq`` for the x3 rungs'
residual) and against the terms ``prec.tile_terms`` makes for the dW twin;
rows past a run's end never reach its scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro_torch.core import precision as prec
from repro_torch.kernels import gemm_grouped as gg

QUANT = ("fp8", "int8", "fp8x3", "int8x3")
# runs of 37, 0, 64 and 5 rows (32 divides one of them), D and F ragged
SIZES, D, F = (37, 0, 64, 5), 130, 200


def _dw_inputs(seed, sizes=SIZES, d=D, f=F, pad=7):
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(offsets[-1]) + pad
    x = rng.standard_normal((n, d)).astype(np.float32)
    dy = (rng.standard_normal((n, f)) * 1e-3).astype(np.float32)
    return x, dy, offsets


def _qdq_at(v, s, policy):
    """Quantize-dequantize v under a given scale, as ``prec.tile_terms``."""
    dtype, qmax = prec.QUANT_FORMATS[prec.quant_format(policy)]
    y = v / s
    q = torch.clamp(torch.round(y), -qmax, qmax).to(dtype) if dtype == torch.int8 else y.to(dtype)
    return (q.float() * s).to(torch.bfloat16)


@pytest.mark.parametrize("policy", QUANT)
def test_dw_scale_pass_matches_repro_per_tile(policy):
    """Each tile's (hi, lo) scales are those repro's per-tensor quantizer
    takes over that tile alone (the short last tile of a run padded with
    zeros, which move no amax)."""
    x, dy, offsets = _dw_inputs(1)
    got = gg.grouped_dw_scales(torch.from_numpy(x), torch.from_numpy(dy),
                               torch.from_numpy(offsets), policy=policy).numpy()
    _, first = gg.dw_scale_slots(x.shape[0], offsets.tolist())
    fmt = jprec.quant_format(policy)
    qmax = jprec.QUANT_FORMATS[fmt][1]
    nd = -(-D // 64)
    owned = np.zeros(got.shape[0], bool)
    for g, n in enumerate(SIZES):
        o0 = int(offsets[g])
        for t in range(-(-n // 32)):
            owned[first[g] + t] = True
            rows = slice(o0 + 32 * t, min(o0 + 32 * t + 32, o0 + n))
            tiles = [x[rows, c:c + 64] for c in range(0, D, 64)]
            tiles += [dy[rows, c:c + 128] for c in range(0, F, 128)]
            for ct, tile in enumerate(tiles):
                jt = jnp.asarray(tile)
                s_hi = float(jprec._pow2_scale(jt, qmax))
                s_lo = 1.0
                if policy.endswith("x3"):
                    hi = jprec.qdq(jt, fmt).astype(jnp.float32)
                    s_lo = float(jprec._pow2_scale(jt - hi, qmax))
                assert got[first[g] + t, ct].tolist() == [s_hi, s_lo], (g, t, ct, nd)
    assert not got[~owned].any()


@pytest.mark.parametrize("policy", QUANT)
def test_dw_scale_pass_gives_the_dw_twins_terms(policy):
    """Quantizing each run under the pass's scales gives, bit for bit, the
    terms ``prec.tile_terms`` makes for ``grouped_gemm_dw_plain`` at the
    tiles ((64, 32), (32, 128)) of x^T and dy."""
    x, dy, offsets = (torch.from_numpy(a) for a in _dw_inputs(2))
    scales = gg.grouped_dw_scales_plain(x, dy, offsets, policy=policy)
    _, first = gg.dw_scale_slots(x.shape[0], offsets.tolist())
    nd = -(-D // 64)
    off = offsets.tolist()
    for g in range(len(SIZES)):
        n = off[g + 1] - off[g]
        if n == 0:
            continue
        kt = -(-n // 32)
        for mat, tile, c0 in ((x[off[g]:off[g + 1]].t(), gg.DW_SCALE_TILES[0], 0),
                              (dy[off[g]:off[g + 1]], gg.DW_SCALE_TILES[1], nd)):
            want = prec.tile_terms(mat, policy, tile)
            # each element's scale pair, broadcast from its tile
            s = scales[first[g]:first[g] + kt, c0:]
            if c0 == 0:   # x^T: rows are x's columns (64 a tile), columns the run (32)
                s = s[:, :nd].permute(1, 0, 2).repeat_interleave(64, 0).repeat_interleave(32, 1)
            else:         # dy: rows the run (32 a tile), columns dy's (128)
                s = s.repeat_interleave(32, 0).repeat_interleave(128, 1)
            s = s[:mat.shape[0], :mat.shape[1]]
            hi = _qdq_at(mat.float(), s[..., 0], policy)
            assert torch.equal(hi, want[0])
            if policy.endswith("x3"):
                assert torch.equal(_qdq_at(mat.float() - hi.float(), s[..., 1], policy), want[1])


def test_dw_scale_tiles_end_at_each_run():
    """The run-boundary tiling: a group's slots start at offsets[g] // 32 + g
    and number ceil(n / 32); slots of different groups never meet, even for
    runs that 32 does not divide; rows outside a run (the next group's, or
    the padding past offsets[E]) never move its scales."""
    sizes = (5, 27, 33, 0, 31, 64, 1)
    x, dy, offsets = _dw_inputs(3, sizes=sizes, d=64, f=128, pad=40)
    n_slots, first = gg.dw_scale_slots(x.shape[0], offsets.tolist())
    spans = [set(range(first[g], first[g] + -(-n // 32))) for g, n in enumerate(sizes)]
    assert all(not (a & b) for i, a in enumerate(spans) for b in spans[i + 1:])
    assert max(max(s) for s in spans if s) < n_slots
    base = gg.grouped_dw_scales(torch.from_numpy(x), torch.from_numpy(dy),
                                torch.from_numpy(offsets), policy="int8x3")
    for g, n in enumerate(sizes):
        end = int(offsets[g + 1])
        x2, dy2 = x.copy(), dy.copy()
        x2[end:] *= 1e4          # everything past run g's end
        dy2[end:] *= 1e4
        moved = gg.grouped_dw_scales(torch.from_numpy(x2), torch.from_numpy(dy2),
                                     torch.from_numpy(offsets), policy="int8x3")
        keep = sorted(set().union(*spans[:g + 1]))
        assert torch.equal(moved[keep], base[keep]), g
        later = sorted(set().union(*spans[g + 1:]))
        assert all(not torch.equal(moved[s], base[s]) for s in later), g


def test_dw_scale_pass_serves_the_quantized_rungs_only():
    x, dy, offsets = (torch.from_numpy(a) for a in _dw_inputs(4))
    for policy in ("bf16", "refine_ab", "bf16x6"):
        with pytest.raises(ValueError):
            gg.grouped_dw_scales(x, dy, offsets, policy=policy)
