"""Training the port's encoder-decoder (whisper-medium, the audio family)
and image-prefix VLM (internvl2-76b) against the JAX package, on the CPU.

At the smoke configs, step 0's loss and every gradient leaf (whisper's
encoder layers, its cross-attention and its tied table among them) are
held against ``repro``'s ``jax.value_and_grad`` of its train loss on both
routes and at f32 and bf16 activations, and three smoke steps' losses
against ``repro``'s train step (``torch_train_testlib``).  Controls that
must land outside the f32 bound: whisper's encoder run causal, and
internvl2's image rows rolled by one position.  Also held: the synthetic
frames and image rows bit-equal to ``repro``'s, microbatches that split
them along the batch, the train CLI, and remat over every period, the
encoder's included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JSyntheticLMDataset
from repro_torch.configs.base import execution_policy_for, layer_kinds
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import train as ttrain
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.train_step import make_train_step
from torch_train_testlib import (Step0, assert_step0, batch, cfgs, init_tree, outside,
                                 port_step0, smoke_losses, step0)
from torch_train_testlib import repro_kv_tile, test_train_cli_runs_on_the_cpu  # noqa: F401

ARCHS = ("whisper-medium", "internvl2-76b")


@pytest.mark.parametrize("activation_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["torch", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_and_every_gradient_match_repro(repro_kv_tile, arch, route,
                                                   activation_dtype):
    assert_step0(step0(arch, init_tree(arch), route, activation_dtype), activation_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_smoke_steps_match_repro(repro_kv_tile, arch):
    jl, tl = smoke_losses(arch, init_tree(arch))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_faulty_control_lands_outside_the_bound(repro_kv_tile, monkeypatch, arch):
    """The port with a fault against repro's step 0 at f32 on the kernel
    routes: whisper's encoder run causal (a dropped ``causal=False``),
    internvl2's image rows rolled by one position (rows out of place)."""
    ref = step0(arch, init_tree(arch), "kernels", "float32")
    _, tcfg = cfgs(arch)
    b = batch(tcfg)
    if arch == "whisper-medium":
        real = T.attention
        monkeypatch.setattr(T, "attention", lambda *a, **kw: real(
            *a, **({**kw, "causal": True} if kw.get("mode") == "encode" else kw)))
    else:
        b = dict(b, image_embeds=np.roll(b["image_embeds"], 1, axis=1))
    t_loss, t_grads = port_step0(init_tree(arch), tcfg, "kernels", "float32", b)
    assert outside(Step0(ref.loss, ref.grads, t_loss, t_grads)) > 10
    assert abs(t_loss - ref.loss) > 1e-4


@pytest.mark.parametrize("seed,proc,nproc", [(0, 0, 1), (5, 1, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_frames_and_image_rows_are_bit_equal(arch, seed, proc, nproc):
    """The train CLI's batches for each family, f32 frames or image rows
    drawn after the tokens from the same stream, bit-equal to repro's."""
    _, tcfg = cfgs(arch)
    tdc = ttrain.data_config(tcfg, batch=4, seq=12, seed=seed)
    jds = JSyntheticLMDataset(JDataConfig(**dataclasses.asdict(tdc)), proc=proc, nproc=nproc)
    tds = SyntheticLMDataset(tdc, proc=proc, nproc=nproc)
    extra = "frames" if arch == "whisper-medium" else "image_embeds"
    for i in (0, 1, 17):
        jb, tb = jds.batch(i), tds.batch(i)
        assert set(jb) == set(tb) == {"tokens", "labels", extra}
        for key in tb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])
    rows = tcfg.encoder_seq if extra == "frames" else tcfg.num_image_tokens
    assert tb[extra].shape == (4 // nproc, rows, tcfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_split_frames_and_image_rows(arch):
    """Two microbatches of one row each: the step's loss is the mean of the
    two rows' losses, each with its own frames or image rows."""
    _, tcfg = cfgs(arch)
    policy = execution_policy_for(tcfg, default="f32")
    params = api.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in batch(tcfg).items()}
    with torch.no_grad():
        rows = [float(api.loss_fn(params, {k: v[i:i + 1] for k, v in b.items()}, tcfg,
                                  policy=policy)[1]["loss"]) for i in range(2)]
    for p in leaves(params):
        p.requires_grad_(True)
    step = make_train_step(tcfg, adamw.AdamWConfig(), policy, microbatches=2)
    _, _, metrics = step(params, adamw.init(params), b)
    assert float(metrics["loss"]) == pytest.approx(sum(rows) / 2, abs=1e-6)


def _encoder_runs(monkeypatch, tcfg, params, b, remat):
    """How many times each encoder sublayer runs over one loss and backward."""
    calls = []
    real = T._sublayer
    monkeypatch.setattr(T, "_sublayer", lambda kind, p, x, **kw: (
        calls.append(kw["mode"]), real(kind, p, x, **kw))[1])
    loss, _ = api.loss_fn(params, b, tcfg, policy=execution_policy_for(tcfg, default="f32"),
                          remat=remat)
    grads = torch.autograd.grad(loss, leaves(params))
    monkeypatch.setattr(T, "_sublayer", real)
    n_enc = len(layer_kinds(tcfg, encoder=True))
    return calls.count("encode") / n_enc, calls.count("train") / len(layer_kinds(tcfg)), grads


def test_remat_recomputes_every_encoder_period(monkeypatch):
    """With remat every period runs under ``torch.utils.checkpoint``, the
    encoder's as the decoder's (as repro wraps every scan step in
    ``jax.checkpoint``): each sublayer runs twice over one loss and its
    backward, once without remat, and the gradients are the same."""
    _, tcfg = cfgs("whisper-medium")
    params = api.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    b = {k: torch.from_numpy(v) for k, v in batch(tcfg).items()}
    enc_on, dec_on, g_on = _encoder_runs(monkeypatch, tcfg, params, b, remat=True)
    enc_off, dec_off, g_off = _encoder_runs(monkeypatch, tcfg, params, b, remat=False)
    assert (enc_on, dec_on, enc_off, dec_off) == (2, 2, 1, 1)
    for x, y in zip(g_on, g_off):
        assert torch.equal(x, y)
