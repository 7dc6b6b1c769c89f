"""The host side of the port's packed batched GEMM stream on the CPU
(``kernels/batched_gemm.py``: ``packed_schedule``, ``packed_chunks``).

The kernel's persistent CTAs walk chunks of ``CHUNK`` elements of each
operand with a grid stride; the schedule the wrapper launches must take
every group of ``PACK_TILE // n`` matrices (the JAX kernel's grid step)
exactly once, hold at least 16 KB of each operand a stage, and fit the
H100's shared memory at the CTAs an SM it plans.  A walk of that schedule
in torch ops, each chunk's products on its own, is held against
``repro``'s Pallas packed kernel in interpret mode (1e-5, the same bf16
terms summed in f32 in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_gemm import batched_gemm as j_batched_gemm
from repro_torch.kernels import batched_gemm as bg
from repro_torch.kernels.ref import batched_gemm_ref

SM_BYTES = 233472          # the H100 SM's shared memory
CTA_RESERVED = 1024        # bytes the hardware keeps for each resident CTA
DTYPES = [(True, True), (False, True), (True, False), (False, False)]


def _walk(plan, g, n):
    """Group ids of every chunk each CTA takes, in the kernel's order."""
    per_chunk = bg.CHUNK // (n * n)
    pack = bg.PACK_TILE // n
    return [[m // pack for ch in bg.packed_chunks(cta, plan["grid"], plan["chunks"])
             for m in range(ch * per_chunk, min((ch + 1) * per_chunk, g))]
            for cta in range(plan["grid"])]


@pytest.mark.parametrize("a_bf16,b_bf16", DTYPES)
@pytest.mark.parametrize("groups", [1, 3, 1000])
@pytest.mark.parametrize("n", bg.PACKED_N)
def test_schedule_takes_every_group_once(n, groups, a_bf16, b_bf16):
    pack = bg.PACK_TILE // n
    g = pack * groups
    for sms in (132, 7):
        plan = bg.packed_schedule(g, n, a_bf16, b_bf16, sms)
        walk = _walk(plan, g, n)
        # a group's matrices lie in one chunk, and the chunks cover G once
        assert bg.CHUNK % (n * n) == 0 and (bg.CHUNK // (n * n)) % pack == 0
        taken = [grp for cta in walk for grp in cta]
        assert sorted(taken) == sorted(grp for grp in range(groups) for _ in range(pack))
        assert 1 <= plan["grid"] <= min(plan["chunks"], plan["per_sm"] * sms)
        assert all(walk)                                # no CTA without a chunk
        # a stage holds >= 16 KB of each operand; the ring fits
        for is_bf16 in (a_bf16, b_bf16):
            assert bg.CHUNK * (2 if is_bf16 else 4) >= 16 * 1024
        assert 2 <= plan["stages"] <= bg.MAX_STAGES
        assert plan["smem"] <= bg.SMEM_LIMIT
        assert plan["per_sm"] * (plan["smem"] + CTA_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("n,groups", [(8, 3), (16, 9), (32, 5), (64, 7)])
def test_schedule_walk_matches_repro_packed_kernel(n, groups):
    """Each chunk's matrices multiplied on their own, in the schedule's
    order over a few CTAs (the last chunk ragged), give repro's packed
    kernel's output."""
    g = bg.PACK_TILE // n * groups
    rng = np.random.default_rng(n)
    a, b = (rng.uniform(-1, 1, (g, n, n)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_batched_gemm(jnp.asarray(a), jnp.asarray(b), interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plan = bg.packed_schedule(g, n, False, True, 3)
    per_chunk = bg.CHUNK // (n * n)
    got = torch.full((g, n, n), float("nan"))
    for cta in range(plan["grid"]):
        for ch in bg.packed_chunks(cta, plan["grid"], plan["chunks"]):
            ms = slice(ch * per_chunk, min((ch + 1) * per_chunk, g))
            got[ms] = batched_gemm_ref(ta[ms], tb[ms].to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bg.batched_gemm(ta, tb).numpy(), want, rtol=1e-5, atol=1e-5)
