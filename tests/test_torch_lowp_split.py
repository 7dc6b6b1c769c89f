"""The host side of the quantized GEMM's two kernels, on the CPU.

``csrc/gemm_lowp.cu`` sums C as ``((0 + u_0) + u_1) + ...`` over the
quantization K-tiles' terms, each computed on its own (the decode kernel's
CTAs, the mainloop's folds): ``gemm_lowp_split_plain`` models that order
and must equal ``gemm_lowp_plain`` bit for bit, and both stay within
``tests/test_torch_lowp.py``'s bounds of ``repro``'s interpret-mode
``gemm_lowp``.  ``lowp_planes_plain`` models the quantize pass (M > 16):
its scales and carrier planes are ``gemm_lowp_plain``'s quantization tile
for tile, and ``repro``'s ``_quant_tile`` on each tile.  ``decode_plan``
is the decode kernel's launch (M <= 16): every B quantization tile
covered once, the workspace large enough.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm_lowp import _quant_tile as jquant_tile
from repro.kernels.gemm_lowp import gemm_lowp as jgemm_lowp
from repro_torch.kernels import gemm_lowp as gl
from repro_torch.kernels import gemm_tiled as gt

QUANT_RUNGS = ("fp8", "int8", "fp8x3", "int8x3")
# max |port - repro| / max |repro| per rung: tests/test_torch_lowp.py's
# REPRO_REL (XLA's CPU compiler, which runs repro's kernel in interpret
# mode, multiplies by 1/127 where the port divides and contracts the
# residual and the accumulate into FMAs).
REPRO_REL = {"fp8": 5e-3, "int8": 1e-3, "fp8x3": 3e-4, "int8x3": 2e-5}
# the path's shapes at small widths: ragged K and N tails on a (bm, bn, bk)
# grid, M from one decode row to two 64-row mainloop tiles
GRID = (16, 32, 32)
CASES = [(1, 72, 40), (4, 72, 40), (16, 100, 70), (17, 100, 70), (64, 72, 40)]
H100_SMS = 132


def _problem(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _repro(a, b, rung, bm, bn, bk):
    """repro's kernel on the grid-padded operands (its caller pads)."""
    m, k = a.shape
    n = b.shape[1]
    ap = np.pad(a, ((0, -m % bm), (0, -k % bk)))
    bp = np.pad(b, ((0, -k % bk), (0, -n % bn)))
    return np.asarray(jgemm_lowp(jnp.asarray(ap), jnp.asarray(bp), policy=rung, bm=bm, bn=bn,
                                 bk=bk, interpret=True))[:m, :n]


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("rung", QUANT_RUNGS)
@pytest.mark.parametrize("m,k,n", CASES)
def test_split_plain_is_plain_and_repro(rung, m, k, n):
    rng = np.random.default_rng(m * 7 + k)
    a, b = _problem(rng, m, k), _problem(rng, k, n)
    split = gl.gemm_lowp_split_plain(torch.from_numpy(a), torch.from_numpy(b), rung, *GRID)
    plain = gl.gemm_lowp_plain(torch.from_numpy(a), torch.from_numpy(b), rung, *GRID)
    assert split.shape == (m, n) and torch.equal(split, plain)
    assert _rel(split.numpy(), _repro(a, b, rung, *GRID)) <= REPRO_REL[rung]


@pytest.mark.parametrize("rung", QUANT_RUNGS)
def test_split_plain_batched(rung):
    """Batch 2 at a decode shape: each matrix on its own."""
    rng = np.random.default_rng(5)
    a, b = _problem(rng, 2, 4, 72), _problem(rng, 2, 72, 40)
    split = gl.gemm_lowp_split_plain(torch.from_numpy(a), torch.from_numpy(b), rung, *GRID)
    assert torch.equal(split, gl.gemm_lowp_plain(torch.from_numpy(a), torch.from_numpy(b), rung,
                                                 *GRID))
    for i in range(2):
        assert _rel(split[i].numpy(), _repro(a[i], b[i], rung, *GRID)) <= REPRO_REL[rung]


@pytest.mark.parametrize("rung", QUANT_RUNGS)
@pytest.mark.parametrize("rows,cols,tr,tc", [(70, 100, 32, 64), (64, 40, 16, 32),
                                             (5, 9, 256, 256)])
def test_planes_plain_are_the_tiles(rung, rows, cols, tr, tc):
    """Scales and planes equal gemm_lowp_plain's quantization (_quantize
    on the padded operand) and repro's _quant_tile on every tile."""
    rng = np.random.default_rng(rows + cols)
    x = _problem(rng, rows, cols) * np.float32(3.0)
    x[: min(rows, tr), : min(cols, tc)] *= np.float32(40.0)   # one tile far larger
    hi, lo, s, sr = gl.lowp_planes_plain(torch.from_numpy(x), tr, tc, rung)
    x3 = rung.endswith("x3")
    assert hi.shape == (rows, cols) and (lo is None) == (not x3)
    (qa, sa, _, _), (qra, sra, _, _) = gl._operands(torch.from_numpy(x), torch.zeros(cols, 1),
                                                    rung, tr, 1, tc)
    assert torch.equal(hi, qa[:rows, :cols]) and torch.equal(s, sa)
    if x3:
        assert torch.equal(lo, qra[:rows, :cols]) and torch.equal(sr, sra)
    fmt = rung[:-2] if x3 else rung
    xp = np.pad(x, ((0, -rows % tr), (0, -cols % tc)))
    for i in range(s.shape[0]):
        for j in range(s.shape[1]):
            tile = jnp.asarray(xp[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc])
            q, js = jquant_tile(tile, fmt)
            r1, c1 = min(rows, (i + 1) * tr) - i * tr, min(cols, (j + 1) * tc) - j * tc
            assert np.float32(js) == s[i, j].item()
            np.testing.assert_array_equal(
                np.asarray(q)[:r1, :c1], hi[i * tr:i * tr + r1, j * tc:j * tc + c1].numpy())
            if x3:
                ql, jsr = jquant_tile(tile - q * js, fmt)
                assert np.float32(jsr) == sr[i, j].item()
                np.testing.assert_array_equal(
                    np.asarray(ql)[:r1, :c1], lo[i * tr:i * tr + r1, j * tc:j * tc + c1].numpy())


@pytest.mark.parametrize("m,n,k,bn,bk", [(4, 6912, 1152, 256, 256),     # wi / wg
                                         (4, 1152, 6912, 256, 256),     # wo
                                         (4, 1000, 1152, 256, 256),     # ragged N
                                         (16, 777, 520, 128, 256),      # ragged N and K
                                         (3, 300, 200, 300, 512)])      # one tile
@pytest.mark.parametrize("batch", [1, 2])
def test_decode_plan_covers_every_tile_once(m, n, k, bn, bk, batch):
    gl.check_grid(m, n, k, m, bn, bk)
    plan = gl.decode_plan(batch, m, n, k, bn, bk, H100_SMS)
    assert plan.grid == (plan.nt * plan.cluster, plan.kt, batch)
    assert plan.cluster == -(-min(bn, n) // gl.DEC_SLICE) <= gl.MAX_CLUSTER
    seen = np.zeros((batch, k, n), np.int32)
    tiles = set()
    for bz, k0, k1, c0, c1 in gl.decode_slices(plan, n, k, bn, bk):
        assert k1 - k0 <= plan.depth
        if c1 > c0:
            seen[bz, k0:k1, c0:c1] += 1
            assert c0 // bn == (c1 - 1) // bn       # inside one B tile
            tiles.add((bz, k0 // bk, c0 // bn))
    assert (seen == 1).all()
    assert tiles == {(z, i, j) for z in range(batch) for i in range(plan.kt)
                     for j in range(plan.nt)}
    # the workspace: split_workspace's slots and tickets at 132 SMs
    if plan.kt > 1:
        assert plan.slots == batch * plan.nt * plan.cluster * plan.kt
        assert plan.slots * gl.DEC_PART <= gt.WS_SLOTS_PER_SM * H100_SMS * gt.WS_SLOT_FLOATS
        assert plan.tickets <= gt.TICKETS_PER_SM * H100_SMS
    else:
        assert plan.slots == plan.tickets == 0


def test_decode_plan_at_gemma3_decode_mlp():
    """The source note's numbers: 4 CTAs of 64 columns a 256 x 256 tile,
    3 an SM, 540 CTAs (wi: 5 K x 27 N tiles; wo: 27 x 5) in 1.36 waves."""
    for n, k, grid in ((6912, 1152, (108, 5, 1)), (1152, 6912, (20, 27, 1))):
        plan = gl.decode_plan(1, 4, n, k, 256, 256, H100_SMS)
        assert (plan.cluster, plan.grid, plan.depth) == (4, grid, 256)
        assert plan.smem == 256 * 64 * 4 + 8 * 264 * 4
        assert plan.ctas_per_sm == 3
        assert plan.grid[0] * plan.grid[1] == 540
        assert abs(plan.waves - 540 / 396) < 1e-9
    # 9..16 rows stage 16 rows of A: two CTAs an SM
    assert gl.decode_plan(1, 16, 6912, 1152, 256, 256, H100_SMS).ctas_per_sm == 2


@pytest.mark.parametrize("m,n,k,grid", [(4, 1000, 1152, (8, 256, 256)),
                                        (300, 270, 520, (256, 256, 256)),
                                        (48, 40, 132, (48, 128, 256)),
                                        (700, 384, 300, (128, 128, 128)),
                                        (20, 40, 300, (24, 128, 256)),
                                        (20, 10, 30, (8, 128, 128)),
                                        (4, 6912, 1152, (4, 256, 256)),
                                        (700, 6912, 1152, (256, 256, 256))])
def test_check_grid_takes_the_parents_grids(m, n, k, grid):
    gl.check_grid(m, n, k, *grid)


@pytest.mark.parametrize("m,n,k,grid,what", [(4, 1000, 1152, (8, 1024, 256), "decode"),
                                             (4, 100, 2000, (8, 64, 1024), "decode"),
                                             (300, 270, 520, (256, 256, 100), "bk=100"),
                                             (300, 270, 520, (256, 256, 48), "bk=48"),
                                             (300, 270, 520, (256, 96, 256), "bn=96"),
                                             (300, 900, 520, (256, 1024, 256), "B's")])
def test_check_grid_refuses_what_no_tile_nests_in(m, n, k, grid, what):
    with pytest.raises(ValueError, match=what):
        gl.check_grid(m, n, k, *grid)
