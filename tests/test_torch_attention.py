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
from repro_torch.kernels import attention_fused as taf
from repro_torch.models.attention import reference_decode, reference_forward

ATOL = 1e-4
POLICIES = ("bf16", "refine_a", "bf16x3", "refine_ab", "f32")
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
    for rung in ("bf16x6", "fp8", "int8", "fp8x3", "int8x3"):
        with pytest.raises(ValueError, match=f"rung '{rung}'"):
            tops.ExecutionPolicy(default=rung, backends={"attention": "cuda_fused"})
    with pytest.raises(ValueError, match="fused attention runs"):
        taf.flash_attention(*(torch.zeros(1, 4, 1, 1, 16),) + (torch.zeros(1, 4, 1, 16),) * 2,
                            precision="bf16x6")
