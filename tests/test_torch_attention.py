"""The port's flash-attention plain versions (what ``flash_attention`` /
``flash_decode`` run on CPU tensors, and what the CUDA kernels are held
against on the card) against ``repro.kernels.attention_fused`` in
interpret mode, on the same numpy inputs.

Cases: causal, sliding window, GQA (2 kv heads x 2 query heads each)
and softcap for the forward; ring and linear decode at per-row
positions before and after a wrap.  The JAX kernels run with
``block_kv=32``, the port's KV tile, so both round the probabilities
to bf16 against the same running maxima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_fused as jaf
from repro.models.attention import reference_decode as j_reference_decode
from repro_torch.core import ops as tops
from repro_torch.core.ops.registry import LADDER_BOUNDS
from repro_torch.kernels import attention_fused as taf
from repro_torch.models.attention import reference_decode, reference_forward

ATOL = 1e-4
POLICIES = ("bf16", "refine_a", "bf16x3", "refine_ab", "f32", "bf16x6")
# The fp8 / int8 rungs: the port scales per kernel tile (a 64-row q block,
# 32-row KV tiles, 64 x 32 probability tiles), repro per BlockSpec block;
# each is held to the rung's ladder bound (``LADDER_BOUNDS``, the family's
# ``error_bound``) of the f64 oracle.  Run with the same blocks, port and
# repro differ only where an f32 sum in another order moves a value across
# a quantization step, so they are held to each other at REPRO_TOL: the
# largest reading here was int8's 7.8e-4 (one probability flipped by 2^-6);
# the port computing bf16 in place of a one-pass rung, or one pass in
# place of x3, reads 2.4e-3 to 0.04 from repro, and int8x3 under a scale
# twice too large 4.4e-4.
LOWP_RUNGS = ("fp8", "int8", "fp8x3", "int8x3")
REPRO_TOL = {"fp8": 1e-3, "int8": 2e-3, "fp8x3": 1e-4, "int8x3": 1e-4}
B, S, KV, G, HD = 2, 72, 2, 2, 16


def _qkv(seed, *, s=S, sk=None, hd=HD):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = (rng.uniform(-1, 1, (B, s, KV, G, hd)) * hd ** -0.5).astype(np.float32)
    k = rng.uniform(-1, 1, (B, sk, KV, hd)).astype(np.float32)
    v = rng.uniform(-1, 1, (B, sk, KV, hd)).astype(np.float32)
    return q, k, v


MASKS = {
    "causal": dict(causal=True, window=None, softcap=None),
    "window": dict(causal=True, window=20, softcap=None),
    "full": dict(causal=False, window=None, softcap=None),
    "softcap": dict(causal=True, window=None, softcap=3.0),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_attention_plain_matches_repro(mask, policy):
    q, k, v = _qkv(1)
    kw = MASKS[mask]
    ref = np.asarray(jaf.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), precision=policy,
        block_kv=32, interpret=True, **kw))
    out = taf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), precision=policy, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= ATOL


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ring", [True, False])
def test_flash_decode_plain_matches_repro(ring, policy):
    s_cache = 40
    q, k, v = _qkv(2, s=1, sk=s_cache)
    # ring: before the wrap, at it, and two laps on; linear: early and full
    pos = np.array([5, 39] if ring else [0, 27], np.int32)
    pos2 = np.array([40, 97] if ring else [13, 39], np.int32)
    window = s_cache if ring else None
    for p in (pos, pos2):
        ref = np.asarray(jaf.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(p),
            window=window, softcap=2.0, precision=policy, block_kv=32,
            interpret=True))
        out = taf.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(p),
                               window=window, softcap=2.0, precision=policy)
        assert np.abs(out.numpy() - ref).max() <= ATOL


@pytest.mark.parametrize("mask", list(MASKS))
def test_torch_reference_matches_repro_reference(mask):
    """The ``torch`` attention impl (the chunked two-GEMM reference) at f32
    against the JAX ``xla`` reference."""
    from repro.models.attention import reference_forward as j_reference_forward
    q, k, v = _qkv(3)
    kw = MASKS[mask]
    ref = np.asarray(j_reference_forward(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), policy="f32",
                                         kv_chunk=32, **kw))
    out = reference_forward(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), policy="f32", kv_chunk=32, **kw)
    assert np.abs(out.numpy() - ref).max() <= ATOL
    q1, k1, v1 = _qkv(4, s=1, sk=24)
    pos = np.array([7, 50], np.int32)
    dref = np.asarray(j_reference_decode(jnp.asarray(q1), jnp.asarray(k1),
                                         jnp.asarray(v1), jnp.asarray(pos),
                                         window=24, softcap=None, policy="f32"))
    dout = reference_decode(torch.from_numpy(q1), torch.from_numpy(k1),
                            torch.from_numpy(v1), torch.from_numpy(pos),
                            window=24, softcap=None, policy="f32")
    assert np.abs(dout.numpy() - dref).max() <= ATOL


def test_cuda_fused_declares_only_its_fused_rungs():
    """cuda_fused declares the rungs repro's pallas_fused does (all of
    them) and fuses every one in its kernels; a name off the ladder still
    raises."""
    from repro_torch.core.ops import registry
    caps = registry.get_impl("attention", "cuda_fused").capabilities
    assert caps.policies == caps.fused_policies == registry.ALL_POLICIES
    for rung in ("bf16x6", "fp8", "int8", "fp8x3", "int8x3"):
        pol = tops.ExecutionPolicy(default=rung, backends={"attention": "cuda_fused"})
        assert pol.for_("attention").impl("attention") == "cuda_fused"
    with pytest.raises(ValueError, match="fused attention runs"):
        taf.flash_attention(*(torch.zeros(1, 4, 1, 1, 16),) + (torch.zeros(1, 4, 1, 16),) * 2,
                            precision="bf16x7")


def _oracle_attention(q, k, v, keep):
    """f64 softmax attention: q (B,Sq,Kv,G,hd), k/v (B,Skv,Kv,hd), keep
    broadcastable to (B,Kv,G,Sq,Skv)."""
    s = np.einsum("bqkgd,bskd->bkgqs", q.astype(np.float64), k.astype(np.float64))
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgqs,bskd->bqkgd", p, v.astype(np.float64))


@pytest.mark.parametrize("policy", LOWP_RUNGS)
@pytest.mark.parametrize("mask", ["causal", "window"])
def test_flash_attention_quantized_rungs_match_repro(mask, policy):
    q, k, v = _qkv(5, s=80)
    kw = MASKS[mask]
    ref = np.asarray(jaf.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), precision=policy,
        block_q=taf.BQ, block_kv=32, interpret=True, **kw))
    out = taf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), precision=policy, **kw).numpy()
    rows, cols = np.arange(80)[:, None], np.arange(80)[None, :]
    keep = cols <= rows
    if kw["window"]:
        keep &= cols > rows - kw["window"]
    oracle = _oracle_attention(q, k, v, keep)
    bound = LADDER_BOUNDS[policy]
    assert out.shape == q.shape and np.isfinite(out).all()
    for got in (out, ref):
        assert np.abs(got - oracle).max() <= bound
    assert np.abs(out - ref).max() <= REPRO_TOL[policy]


@pytest.mark.parametrize("policy", LOWP_RUNGS)
def test_flash_decode_quantized_rungs_match_repro(policy):
    """At G = 2 query heads per kv head the port scales q and p over the
    group's heads, repro per head: both within the ladder bound of the
    oracle and of each other.  At G = 1 the scale tiles are the same, and
    the port is held at REPRO_TOL against repro's forward kernel on each
    row's live keys (repro's decode kernel reads 1e-2 from both at fp8,
    1.7e-4 at fp8x3, on these rows)."""
    s_cache = 40
    q, k, v = _qkv(6, s=1, sk=s_cache)
    pos = np.array([45, 17], np.int32)          # one wrapped ring, one not
    ref = np.asarray(jaf.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        window=s_cache, precision=policy, block_kv=32, interpret=True))
    out = taf.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos), window=s_cache, precision=policy).numpy()
    keep = np.zeros((B, 1, 1, 1, s_cache), bool)
    for b, p in enumerate(pos):
        keep[b, ..., :min(int(p) + 1, s_cache)] = True
    oracle = _oracle_attention(q, k, v, keep)
    bound = LADDER_BOUNDS[policy]
    assert out.shape == q.shape and np.isfinite(out).all()
    for got in (out, ref):
        assert np.abs(got - oracle).max() <= bound
    assert np.abs(out - ref).max() <= bound
    q1, lin = np.ascontiguousarray(q[..., :1, :]), np.array([39, 17], np.int32)
    out1 = taf.flash_decode(torch.from_numpy(q1), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(lin), window=None, precision=policy).numpy()
    for b, p in enumerate(lin):
        ref1 = np.asarray(jaf.flash_attention(
            jnp.asarray(q1[b:b + 1]), jnp.asarray(k[b:b + 1, :p + 1]),
            jnp.asarray(v[b:b + 1, :p + 1]), precision=policy, causal=False,
            block_q=taf.BQ, block_kv=32, interpret=True))
        assert np.abs(out1[b:b + 1] - ref1).max() <= REPRO_TOL[policy]
