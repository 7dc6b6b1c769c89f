"""Shared harness of the port's training parity tests against the JAX
package, on the CPU (``test_torch_train_recurrent.py``,
``test_torch_train_encdec_vlm.py``).

Params come from ``repro``'s ``api.init_params`` (numpy), possibly edited
(the slow-decay copies), and reach the port through
``repro_torch.convert.from_jax_numpy``; batches come from the port's
``SyntheticLMDataset`` (bit-equal to ``repro``'s) and go to both
packages.  The port runs its ``torch`` reference routes and its kernel
routes (``cuda`` / ``cuda_fused``: the kernels' plain versions on CPU
tensors, their backward included); ``repro`` runs ``xla`` and, in
interpret mode, ``pallas`` / ``pallas_fused``, compiled with XLA's excess
precision off and its fused attention on the port's 32-row KV tile.

At bf16 activations both packages run the card's train policy, bf16 with
the logits on refine_ab: XLA:CPU cannot run ``repro``'s interpret-mode
bf16 unembed backward at these smoke configs' 256-row vocabulary (its
DotThunk has no bf16 x bf16 = f32 for that dot), while its refined one
runs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.ops import ExecutionPolicy as JExecutionPolicy
from repro.kernels import attention_fused as jaf
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.runtime.train_step import make_loss_fn as j_make_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.convert import from_jax_numpy
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import data_config
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime.train_step import make_train_step
from test_torch_train import BF16_GRAD_REL, BF16_LOSS_ATOL, EXACT_BF16, F32_ATOL, F32_RTOL

ROUTES = {"torch": {}, "kernels": {"gemm": "cuda", "attention": "cuda_fused"}}
J_ROUTES = {"torch": {}, "kernels": {"gemm": "pallas", "attention": "pallas_fused"}}
# (default rung, logits rung) at each activation dtype
POLICIES = {"float32": ("f32", None), "bfloat16": ("bf16", "refine_ab")}
BATCH, SEQ = 2, 32

# the families these helpers train (test_torch_train.py holds gemma3 and
# test_torch_moe.py the MoE family)
TRAINED_ARCHS = ("rwkv6-7b", "zamba2-7b", "whisper-medium", "internvl2-76b")

__all__ = ["ROUTES", "POLICIES", "BATCH", "SEQ", "TRAINED_ARCHS", "cfgs", "init_tree", "batch",
           "Step0", "step0", "port_step0", "assert_step0", "outside", "smoke_losses",
           "split_chunks", "repro_kv_tile", "test_train_cli_runs_on_the_cpu"]


@pytest.fixture
def repro_kv_tile(monkeypatch):
    """repro's fused attention walks the KV sequence in the port's 32-row
    tiles, so both round probabilities against the same running max."""
    monkeypatch.setattr(jaf, "flash_attention",
                        functools.partial(jaf.flash_attention, block_kv=32))


def cfgs(arch, activation_dtype="float32", **over):
    """(repro config, port config) at the smoke size, the same overrides."""
    return (dataclasses.replace(j_get_smoke(arch), activation_dtype=activation_dtype, **over),
            dataclasses.replace(get_smoke(arch), activation_dtype=activation_dtype, **over))


@functools.lru_cache(maxsize=None)
def init_tree(arch) -> dict:
    """repro's initial params for the smoke config, as numpy (made once an
    arch; callers copy before they change a leaf)."""
    init = jax.jit(japi.init_params, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), j_get_smoke(arch)))


def batch(tcfg, i=0, seed=7) -> dict:
    """Batch ``i`` of the synthetic stream (tokens, and frames or image
    rows) as numpy."""
    return SyntheticLMDataset(data_config(tcfg, batch=BATCH, seq=SEQ, seed=seed)).batch(i)


def _policies(tcfg, route, activation_dtype):
    default, logits = POLICIES[activation_dtype]
    return (JExecutionPolicy(default=default, logits=logits, backends=J_ROUTES[route],
                             interpret=True),
            execution_policy_for(tcfg, default=default, logits=logits, backends=ROUTES[route],
                                 require={"gemm": ("vjp",), "attention": ("vjp",)}))


_J_GRAD_FNS: dict = {}


def _j_grad_fn(jcfg, route, jpol, jparams, jbatch):
    """repro's jitted value_and_grad of its train loss (remat on), compiled
    once per (config, route) for this harness's shapes."""
    key = (jcfg, route)
    if key not in _J_GRAD_FNS:
        fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg, jpol), has_aux=True))
        _J_GRAD_FNS[key] = fn.lower(jparams, jbatch).compile(compiler_options=EXACT_BF16)
    return _J_GRAD_FNS[key]


@dataclasses.dataclass
class Step0:
    loss: float                 # repro's
    grads: dict                 # repro's gradients by the port's leaf path (numpy)
    t_loss: float               # the port's
    t_grads: dict               # the port's, by path


def port_step0(tree, tcfg, route, activation_dtype, b) -> tuple[float, dict]:
    """The port's step-0 loss and gradients by leaf path."""
    _, tpol = _policies(tcfg, route, activation_dtype)
    params = from_jax_numpy(tree, tcfg, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, metrics = api.loss_fn(params, tb, tcfg, policy=tpol, remat=True)
    paths = [p for p, _ in leaves_with_paths(params)]
    grads = torch.autograd.grad(loss, leaves(params))
    return float(metrics["loss"]), {p: g.numpy() for p, g in zip(paths, grads)}


def step0(arch, tree, route, activation_dtype, **over) -> Step0:
    """Step 0 on both packages from the same params and batch."""
    jcfg, tcfg = cfgs(arch, activation_dtype, **over)
    jpol, _ = _policies(tcfg, route, activation_dtype)
    b = batch(tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    (_, jm), jgrads = _j_grad_fn(jcfg, route, jpol, jparams, jbatch)(jparams, jbatch)
    jg = dict((p, g.numpy()) for p, g in leaves_with_paths(
        from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")))
    t_loss, t_grads = port_step0(tree, tcfg, route, activation_dtype, b)
    return Step0(float(jm["loss"]), jg, t_loss, t_grads)


def outside(s: Step0) -> float:
    """How far the port's gradients land from repro's in units of the f32
    tolerance: the largest |got - ref| / (F32_ATOL + F32_RTOL |ref|) over
    every leaf (at most 1 within ``assert_allclose``'s bound)."""
    return max(float((np.abs(s.t_grads[p] - ref) / (F32_ATOL + F32_RTOL * np.abs(ref))).max())
               for p, ref in s.grads.items())


def assert_step0(s: Step0, activation_dtype) -> None:
    """Loss and every gradient leaf: at f32 within F32_ATOL / F32_RTOL, at
    bf16 the loss within BF16_LOSS_ATOL and each leaf within BF16_GRAD_REL
    of its norm."""
    assert list(s.t_grads) == list(s.grads)
    f32 = activation_dtype == "float32"
    assert abs(s.t_loss - s.loss) <= (F32_ATOL if f32 else BF16_LOSS_ATOL)
    for path, ref in s.grads.items():
        got = s.t_grads[path]
        assert got.shape == ref.shape, path
        if f32:
            np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=F32_RTOL, err_msg=path)
        else:
            # a key projection's bias has no gradient in exact arithmetic
            # (each query's softmax is blind to a shift of its scores):
            # only rounding is left on both sides, ~1e-3 of the query
            # bias's, so it is held in units of that sibling's gradient
            scale = s.grads[path[:-len("wk/b")] + "wq/b"] if path.endswith("wk/b") else ref
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(scale), 1e-30)
            assert rel <= BF16_GRAD_REL, (path, rel)


def smoke_losses(arch, tree, steps=3, **over) -> tuple[list, list]:
    """(repro's, the port's) losses over ``steps`` smoke steps on the kernel
    routes at f32, each package on its own twin of the same batches; no
    weight decay (repro decays its stacked norm scales, the port's 1-D
    ones are not decayed)."""
    jcfg, tcfg = cfgs(arch, "float32", **over)
    jpol, tpol = _policies(tcfg, "kernels", "float32")
    opt_cfg = dict(lr=3e-3, warmup_steps=1, total_steps=steps, weight_decay=0.0)
    jopt_cfg = jadamw.AdamWConfig(**opt_cfg)
    j_adamw = jax.jit(jadamw.step, static_argnums=0)
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**opt_cfg), tpol)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.init(jp)
    tp = from_jax_numpy(tree, tcfg, "cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    to = adamw.init(tp)
    jl, tl = [], []
    for i in range(steps):
        b = batch(tcfg, i, seed=3)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        (_, jm), jg = _j_grad_fn(jcfg, "kernels", jpol, jp, jb)(jp, jb)
        jp, jo, _ = j_adamw(jopt_cfg, jo, jp, jg)
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jl, tl


def split_chunks(chunked, seq, chunk, *rest, **kw):
    """Run ``chunked`` on each chunk of the sequence tensors ``seq`` alone
    (the state reset at every chunk boundary: the recurrent controls)."""
    parts = [chunked(*(t[:, c:c + chunk] for t in seq), *rest, **kw)
             for c in range(0, seq[0].shape[1], chunk)]
    return torch.cat([o for o, _ in parts], 1), parts[-1][1]


@pytest.mark.parametrize("arch", TRAINED_ARCHS)
def test_train_cli_runs_on_the_cpu(capsys, arch):
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains
    the family two finite steps on the kernel routes' plain twins."""
    ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--backend", "gemm=cuda", "--backend", "attention=cuda_fused"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert "trained 2 steps" in out and len(losses) == 2 and np.isfinite(losses).all()
