"""The flash backward's CPU contract around its bf16 wgmma kernels
(``kernels/attention_fused.py``): at the bf16 rung the wrapper rounds q,
k, v and dO to bf16 once before the kernels read them, which must not
change what the plain twins compute; the CPU path touches no kernel
count; the dk/dv grid rule; the public signatures.  The gradients from
the operands the wgmma kernels read (rounded to bf16, ``di`` from the f32
dO) are held against the JAX package's fused backward on the f32 inputs.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_fused as jaf
from repro_torch.kernels import attention_fused as af

# bf16 terms on both sides, f32 sums in other orders, and a probability or
# ds that rounds to the neighbouring bf16 value in one of them (as
# tests/test_torch_train.py holds the port's bf16 flash gradients).
BF16_GRAD_ATOL = 2e-2

MASKS = {"causal": dict(causal=True), "window": dict(causal=True, window=9),
         "full": dict(causal=False), "softcap": dict(causal=True, softcap=5.0)}


def _inputs(seed, b=1, s=40, kv=1, g=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (b, s, kv, g, hd)) * hd ** -0.5
    k, v = (rng.uniform(-1, 1, (b, s, kv, hd)) for _ in range(2))
    do = rng.uniform(-1, 1, (b, s, kv, g, hd))
    return [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, do)]


def _bwd_pair(q, k, v, do, lse, di, **kw):
    dq = af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw)
    return (dq, *af.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw))


@pytest.mark.parametrize("mask", list(MASKS))
def test_bf16_twins_see_only_the_rounded_inputs(mask):
    """At bf16, dq, dk and dv from inputs rounded to bf16 beforehand equal,
    bit for bit, those from the f32 originals (``di`` from the f32 dO in
    both): the wrapper's one cast changes nothing."""
    q, k, v, do = _inputs(1)
    kw = dict(MASKS[mask], precision="bf16")
    out, lse = af.flash_attention_plain(q, k, v, **kw)
    di = af.bwd_delta(out, do)
    got = _bwd_pair(*(x.to(torch.bfloat16) for x in (q, k, v, do)), lse, di, **kw)
    for name, x, ref in zip(("dq", "dk", "dv"), got, _bwd_pair(q, k, v, do, lse, di, **kw)):
        assert torch.equal(x, ref), name


def test_refine_a_twins_see_the_f32_inputs():
    """At refine_a (a bf16 hi + lo pair for one operand) the same rounding
    moves the gradients, so the wrapper rounds at the bf16 rung only."""
    q, k, v, do = _inputs(2)
    kw = dict(causal=True, precision="refine_a")
    out, lse = af.flash_attention_plain(q, k, v, **kw)
    di = af.bwd_delta(out, do)
    got = _bwd_pair(*(x.to(torch.bfloat16) for x in (q, k, v, do)), lse, di, **kw)
    ref = _bwd_pair(q, k, v, do, lse, di, **kw)
    assert all(not torch.equal(x, r) for x, r in zip(got, ref))


@pytest.mark.parametrize("precision", ["bf16", "refine_ab"])
def test_cpu_wrappers_leave_the_kernel_counts(precision):
    """On CPU tensors the wrappers run the twins and count nothing, the
    per-mainloop counts of the backward and the forward included."""
    q, k, v, do = _inputs(3)
    out, lse = af.flash_attention_plain(q, k, v, precision=precision)
    di = af.bwd_delta(out, do)
    counts = (af.LAUNCHES, af.LAUNCHES_BY_LOOP, af.LAUNCHES_BY_LOOP_DQ, af.LAUNCHES_BY_LOOP_DKV)
    before = [dict(c) for c in counts]
    dq = af.flash_attention_bwd_dq(q, k, v, do, lse, di, precision=precision)
    dk, dv = af.flash_attention_bwd_dkv(q, k, v, do, lse, di, precision=precision)
    assert [dict(c) for c in counts] == before
    ref = _bwd_pair(q, k, v, do, lse, di, precision=precision)
    assert all(torch.equal(x, r) for x, r in zip((dq, dk, dv), ref))


@pytest.mark.parametrize("b,skv,kvh,g,sms,per_head", [
    (2, 1024, 1, 4, 132, True),      # gemma3's train shape: 32 CTAs -> 128
    (1, 1024, 8, 4, 132, True),      # Mixtral's: 128 CTAs, below 132
    (1, 2048, 8, 4, 132, False),     # 256 CTAs fill the card
    (2, 1024, 1, 1, 132, False),     # nothing to split
    (1, 150, 2, 2, 6, False),        # 6 CTAs on a 6-SM card
    (1, 150, 2, 2, 7, True),
])
def test_dkv_grid_rule(monkeypatch, b, skv, kvh, g, sms, per_head):
    """One CTA per query head exactly when the group-in-CTA grid (64 KV
    rows of a kv head a CTA) has fewer CTAs than the card has SMs."""
    monkeypatch.setattr(af, "_sm_count", lambda index: sms)
    assert af._dkv_per_head(b, skv, kvh, g, 0) is per_head


def test_backward_signatures_are_unchanged():
    """The six backward entry points keep their public signatures."""
    kw = "*, causal: 'bool' = True, window: 'int | None' = None, " \
         "softcap: 'float | None' = None, precision: 'str' = 'bf16')"
    head, full = "(q, k, v, do, lse, di, " + kw, "(q, k, v, out, lse, do, " + kw
    expect = {
        af.flash_attention_bwd_dq: head + " -> 'torch.Tensor'",
        af.flash_attention_bwd_dq_plain: head + " -> 'torch.Tensor'",
        af.flash_attention_bwd_dkv: head,
        af.flash_attention_bwd_dkv_plain: head,
        af.flash_attention_bwd: full,
        af.flash_attention_bwd_plain: full,
    }
    for fn, sig in expect.items():
        assert str(inspect.signature(fn)) == sig, fn.__name__


@pytest.mark.parametrize("mask", ["causal", "window"])
def test_rounded_operands_give_repros_bf16_gradients(mask):
    """dq, dk and dv from q, k, v and dO rounded to bf16 once (what the
    wrapper hands the wgmma kernels at the bf16 rung), with di from the f32
    dO, against ``repro``'s fused backward in interpret mode on the f32
    inputs, GQA with G = 2 over 2 kv heads."""
    q, k, v, do = _inputs(4, b=2, s=72, kv=2, g=2, hd=16)
    kw = dict(causal=True, window=20 if mask == "window" else None, softcap=None)

    def jloss(q, k, v):
        return jnp.sum(jaf.flash_attention(q, k, v, block_kv=32, interpret=True,
                                           precision="bf16", **kw) * jnp.asarray(do.numpy()))

    args = tuple(jnp.asarray(x.numpy()) for x in (q, k, v))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2))).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    out, lse = af.flash_attention_plain(q, k, v, precision="bf16", **kw)
    di = af.bwd_delta(out, do)
    got = _bwd_pair(*(x.to(torch.bfloat16) for x in (q, k, v, do)), lse, di,
                    precision="bf16", **kw)
    for name, jg, tg in zip(("dq", "dk", "dv"), jgrads, got):
        assert tg.shape == jg.shape, name
        assert np.abs(tg.numpy() - np.asarray(jg)).max() <= BF16_GRAD_ATOL, name
