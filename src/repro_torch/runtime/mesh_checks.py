"""The sharded routes held against one device: the parity matrix, its
inputs, and the rank worker that runs it (``runtime.world.spawn``).

A case names a family, an impl, a rung, a mesh and a problem; its inputs
are drawn from a numpy seed, so every rank and the one-device reference
see the same values.  ``run_case(case, device, mesh)`` computes the
case's outputs through the public dispatchers (``ops.gemm``,
``attention_forward`` / ``attention_decode``, ``grouped_matmul``): with
``mesh=None`` on one device, with the case's mesh on a rank.
``parity_worker`` runs a list of cases on every rank of a world: ranks
past a mesh's size take part in building its groups and skip the case.
It returns, per case, a digest of each output on every rank, the outputs
themselves on rank 0, and the rank's kernel launches.

``parity_cases("cpu")`` is ``repro``'s ``tests/test_mesh_shard.py``
matrix at its shapes; ``parity_cases("card")`` the same schemes at
kernel-sized problems on the kernel routes (the card's ``mesh`` phase).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["parity_cases", "within", "case_inputs", "run_case", "parity_worker",
           "train_worker", "serve_worker", "jobs_worker", "launch_counts", "token_losses",
           "step0_reference", "FIVE", "ROW_F32_BOUND"]


# the card's row-parallel GEMM against one device: K in two halves, f32 reduce
ROW_F32_BOUND = 1e-5


def _case(name, family, impl, precision, mesh, expect, **problem):
    return {"name": name, "family": family, "impl": impl, "precision": precision,
            "mesh": mesh, "expect": expect, **problem}


def parity_cases(scale: str = "cpu") -> list[dict]:
    """The matrix; ``expect`` is "bit" (bit-equal) or an absolute bound."""
    cases = []
    if scale == "cpu":
        for impl in ("torch", "cuda"):
            for prec in ("f32", "bf16", "refine_ab"):
                cases.append(_case(f"gemm_col_{prec}_{impl}", "gemm", impl, prec, "dp=2,tp=2",
                                   "bit", mkn=(16, 24, 32), seed=11))
            cases.append(_case(f"gemm_col_k32_{impl}", "gemm", impl, "f32", "dp=2,tp=2", "bit",
                               mkn=(16, 32, 32), seed=11))
            cases.append(_case(f"gemm_row_f32_{impl}", "gemm", impl, "f32", "dp=2,tp=2", 1e-5,
                               mkn=(16, 24, 31), seed=11))
            cases.append(_case(f"gemm_vocab_tp4_{impl}", "gemm", impl, "f32", "tp=4", "bit",
                               mkn=(8, 16, 64), seed=11))
            cases.append(_case(f"gemm_grads_f32_{impl}", "gemm_grad", impl, "f32", "dp=2,tp=2",
                               "bit", mkn=(16, 24, 32), seed=13))
        for impl in ("torch", "cuda_fused"):
            for prec in ("f32", "bf16"):
                cases.append(_case(f"attn_dp_tp_{prec}_{impl}", "attention", impl, prec,
                                   "dp=2,tp=2", "bit", bskgd=(4, 8, 2, 2, 8), window=None,
                                   seed=21))
            cases.append(_case(f"attn_sp_{impl}", "attention", impl, "f32", "dp=2", "bit",
                               bskgd=(1, 8, 2, 2, 8), window=None, seed=21))
            cases.append(_case(f"attn_sp_window_{impl}", "attention", impl, "f32", "dp=2", "bit",
                               bskgd=(1, 8, 2, 2, 8), window=4, seed=21))
            cases.append(_case(f"attn_decode_{impl}", "decode", impl, "f32", "dp=2,tp=2", "bit",
                               bskgd=(4, 16, 2, 2, 8), seed=24))
        for impl, n, bm in (("torch", 16, 4), ("cuda_grouped", 64, 16)):
            g = dict(nedf=(n, 8, 4, 12), bm=bm, seed=31)
            for prec in ("f32", "bf16"):
                cases.append(_case(f"grouped_ep2_{prec}_{impl}", "grouped", impl, prec, "ep=2",
                                   "bit", **g))
            cases.append(_case(f"grouped_ep2_tp2_{impl}", "grouped", impl, "f32", "ep=2,tp=2",
                               "bit", **g))
            cases.append(_case(f"grouped_dp2_ep2_tp2_{impl}", "grouped", impl, "f32",
                               "dp=2,ep=2,tp=2", "bit", **g))
        return cases
    if scale != "card":
        raise ValueError(f"unknown scale {scale!r}")
    from repro_torch.kernels import gemm_grouped
    # A rank plans its block's splits as one device plans the whole problem
    # (``kernels.gemm_tiled.SM_SHARE``), so every case cut on whole tiles
    # sums in one device's order and is held bit-equal.  The row-parallel
    # GEMM sums K in two halves reduced in f32: ROW_F32_BOUND (4.77e-7 on
    # the H100 80GB HBM3, 700.00 W).
    return [
        _case("gemm_col_bf16", "gemm", "cuda", "bf16", "dp=2,tp=2", "bit",
              mkn=(2048, 1152, 6912), seed=11),
        _case("gemm_col_refine_ab", "gemm", "cuda", "refine_ab", "dp=2,tp=2", "bit",
              mkn=(2048, 1152, 6912), seed=11),
        _case("gemm_col_decode_bf16", "gemm", "cuda", "bf16", "dp=2,tp=2", "bit",
              mkn=(16, 1152, 6912), seed=12),
        _case("gemm_row_bf16", "gemm", "cuda", "bf16", "dp=2,tp=2", ROW_F32_BOUND,
              mkn=(2048, 6912, 1151), seed=11),
        _case("gemm_vocab_tp4_refine_ab", "gemm", "cuda", "refine_ab", "tp=4", "bit",
              mkn=(1024, 1152, 262144), seed=14),
        _case("attn_dp_tp_bf16", "attention", "cuda_fused", "bf16", "dp=2,tp=2", "bit",
              bskgd=(4, 1024, 8, 4, 128), window=None, seed=21),
        _case("attn_dp_tp_window_bf16", "attention", "cuda_fused", "bf16", "dp=2,tp=2", "bit",
              bskgd=(4, 1024, 8, 4, 128), window=512, seed=22),
        _case("attn_decode_bf16", "decode", "cuda_fused", "bf16", "dp=2,tp=2", "bit",
              bskgd=(4, 2048, 8, 4, 128), seed=24),
        _case("grouped_ep2_bf16", "grouped", "cuda_grouped", "bf16", "ep=2", "bit",
              nedf=(4096, 1024, 8, 3584), bm=128, seed=31),
        _case("grouped_ep2_tp2_bf16", "grouped", "cuda_grouped", "bf16", "ep=2,tp=2", "bit",
              nedf=(4096, 1024, 8, 3584), bm=128, seed=31),
        _case("grouped_decode_ep2_tp2_bf16", "grouped", "cuda_grouped", "bf16", "ep=2,tp=2",
              "bit", nedf=(128, 1024, 8, 3584), bm=gemm_grouped.ROW_TILE, seed=33),
    ]


def within(err: float, expect) -> bool:
    """A parity case's verdict: ``expect`` "bit" asks for 0.0."""
    return err == 0.0 if expect == "bit" else err <= expect


# ============================================================== inputs

def _u(rng, shape, scale=1.0):
    return torch.from_numpy((rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32))


def case_inputs(case: dict, device) -> dict:
    """The case's operands from its numpy seed, on ``device``."""
    rng = np.random.default_rng(case["seed"])
    fam = case["family"]
    if fam in ("gemm", "gemm_grad"):
        m, k, n = case["mkn"]
        out = {"a": _u(rng, (m, k)), "b": _u(rng, (k, n), k ** -0.5)}
    elif fam == "attention":
        b, s, kv, g, d = case["bskgd"]
        out = {"q": _u(rng, (b, s, kv, g, d), d ** -0.5), "k": _u(rng, (b, s, kv, d)),
               "v": _u(rng, (b, s, kv, d))}
    elif fam == "decode":
        b, s, kv, g, d = case["bskgd"]
        out = {"q": _u(rng, (b, 1, kv, g, d), d ** -0.5), "k": _u(rng, (b, s, kv, d)),
               "v": _u(rng, (b, s, kv, d)),
               "pos": torch.from_numpy(np.sort(rng.integers(s // 8, s, b)).astype(np.int32))}
    else:
        n, d, e, f = case["nedf"]
        bm = case["bm"]
        # ragged runs within n // e rows each, padded to bm; expert 1 empty;
        # the last run's padding fills the buffer
        real = rng.integers(1, n // e + 1, e)
        real[1] = 0
        aligned = -(-real // bm) * bm
        aligned[-1] = n - aligned[:-1].sum()
        offsets = np.concatenate([[0], np.cumsum(aligned)])
        x = np.zeros((n, d), np.float32)
        for gi in range(e):
            x[offsets[gi]:offsets[gi] + real[gi]] = rng.uniform(-1, 1, (real[gi], d))
        out = {"x": torch.from_numpy(x), "w": _u(rng, (e, d, f), d ** -0.5),
               "offsets": torch.from_numpy(offsets.astype(np.int32)),
               "counts": torch.from_numpy(real.astype(np.int32))}
    return {k: v.to(device) for k, v in out.items()}


# ================================================================ runs

def run_case(case: dict, device, mesh=None) -> dict[str, torch.Tensor]:
    """The case's outputs through the public dispatchers (``mesh``: a
    ``MeshSpec`` or None for one device)."""
    from repro_torch.core import ops
    fam = case["family"]
    route = ops.Route(precision=case["precision"], backends={
        {"gemm_grad": "gemm", "decode": "attention"}.get(fam, fam): case["impl"]}, mesh=mesh)
    x = case_inputs(case, device)
    if fam == "gemm":
        return {"out": ops.gemm(x["a"], x["b"], policy=route)}
    if fam == "gemm_grad":
        a, b = x["a"].requires_grad_(), x["b"].requires_grad_()
        ga, gb = torch.autograd.grad(ops.gemm(a, b, policy=route).sum(), (a, b))
        return {"da": ga, "db": gb}
    if fam == "attention":
        return {"out": ops.attention_forward(x["q"], x["k"], x["v"], causal=True,
                                             window=case["window"], policy=route)}
    if fam == "decode":
        return {"out": ops.attention_decode(x["q"], x["k"], x["v"], x["pos"], policy=route)}
    return {"out": ops.grouped_matmul(x["x"], x["w"], x["offsets"], policy=route,
                                      bm=case["bm"], group_counts=x["counts"])}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()).hexdigest()


def launch_counts() -> dict[str, int]:
    """This process's kernel launches: by kernel, by kernel and mainloop
    (``name.loop``) and the decode kernels' split launches
    (``name.split``), as the card script's ``read_launches`` reads them."""
    from repro_torch.kernels import (attention_fused, attention_paged, batched_gemm,
                                     gemm_grouped, gemm_lowp, gemm_naive, gemm_refined,
                                     gemm_tiled, wkv6)
    out = {"gemm_tiled": gemm_tiled.LAUNCHES, "gemm_refined": gemm_refined.LAUNCHES,
           "gemm_lowp": gemm_lowp.LAUNCHES, "gemm_naive": gemm_naive.LAUNCHES,
           "flash_paged_decode": attention_paged.LAUNCHES, "wkv6": wkv6.LAUNCHES}
    for mod in (attention_fused, gemm_grouped, batched_gemm):
        out.update(mod.LAUNCHES)
    loops = {"gemm_tiled": gemm_tiled.LAUNCHES_BY_LOOP,
             "gemm_refined": gemm_refined.LAUNCHES_BY_LOOP,
             "gemm_lowp": gemm_lowp.LAUNCHES_BY_LOOP,
             "grouped_gemm": gemm_grouped.LAUNCHES_BY_LOOP,
             "flash_attention": attention_fused.LAUNCHES_BY_LOOP,
             "grouped_gemm_dw": gemm_grouped.LAUNCHES_BY_LOOP_DW,
             "flash_attention_bwd_dq": attention_fused.LAUNCHES_BY_LOOP_DQ,
             "flash_attention_bwd_dkv": attention_fused.LAUNCHES_BY_LOOP_DKV}
    out.update({f"{name}.{loop}": n for name, d in loops.items() for loop, n in d.items()})
    out["flash_decode.split"] = attention_fused.SPLIT_LAUNCHES["flash_decode"]
    out["flash_paged_decode.split"] = attention_paged.SPLIT_LAUNCHES
    return {k: int(v) for k, v in out.items()}


def parity_worker(rank: int, world: int, cases: list[dict], device: str = "cpu") -> dict:
    """Run ``cases`` on this rank (see the module docstring)."""
    from repro_torch.core.ops import shard
    from repro_torch.runtime.world import rank_device
    dev = rank_device(device, rank) if device == "cuda" else torch.device("cpu")
    before = launch_counts()
    out: dict = {"results": {}, "seconds": {}}
    for case in cases:
        spec = shard.MeshSpec.parse(case["mesh"])
        spec.build()                      # every rank takes part in the groups
        if rank >= spec.size:
            continue
        t0 = shard.STATS["seconds"]
        res = run_case(case, dev, spec)
        out["results"][case["name"]] = {
            k: (_digest(v), v.detach().float().cpu().numpy() if rank == 0 else None)
            for k, v in res.items()}
        out["seconds"][case["name"]] = shard.STATS["seconds"] - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    after = launch_counts()
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    out["collectives"] = dict(shard.STATS)
    out["transport"] = shard.transport()
    return out


# ================================================ train and serve ranks

def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the five gradient leaves the train phases compare, by path
FIVE = {"embed": "embed/table", "local_attn_q": "layers/0/wq/w",
        "global_attn_q": "layers/10/wq/w", "mlp_down": "layers/1/wo/w",
        "unembed": "unembed/table"}


def _five(params: dict) -> dict:
    """The five leaves of a gemma3 params tree."""
    return {"embed": params["embed"]["table"], "local_attn_q": params["layers"][0]["wq"]["w"],
            "global_attn_q": params["layers"][10]["wq"]["w"],
            "mlp_down": params["layers"][1]["wo"]["w"], "unembed": params["unembed"]["table"]}


@torch.no_grad()
def token_losses(loop, full, batch) -> torch.Tensor:
    """Every token's loss at step 0 as the single-device train phase
    reckons it (f32 logsumexp minus the label logit), over the mesh, on
    the whole params ``full`` (``loop.gather_params``): all the data
    ranks' rows, gathered."""
    from repro_torch.core.ops import shard
    from repro_torch.models import transformer
    from repro_torch.runtime.act_sharding import use_constrainer
    with (shard.local_batch(loop.mesh.pod * loop.mesh.dp),
          use_constrainer(loop.constrainer)):
        logits, _, _ = transformer.forward(full, batch["tokens"], loop.cfg, policy=loop.policy,
                                           mode="train")
        logits = logits.float()
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(
            -1, batch["labels"].long()[..., None])[..., 0]
    del logits
    mesh = shard._Mesh(loop.mesh)
    if mesh.size("data") > 1:
        nll = shard._all_gather(nll, 0, mesh, "data")
    return nll


def _rows_repeated(loop):
    """The faulty control: every data rank takes data rank 0's rows."""
    real = loop.batch

    def batch(ds, i):
        coords = loop.coords
        loop.coords = dict(coords, data=0, pod=0)
        try:
            return real(ds, i)
        finally:
            loop.coords = coords
    return batch


def _bf16_row_gemm(impl, a, b, route):
    """The faulty control: every sharded GEMM row-parallel over ``model``
    with its partial products reduced in bf16."""
    from repro_torch.core.ops import shard
    from repro_torch.core.ops.gemm import _impl_gemm_2d
    spec = route.mesh
    if spec.tp == 1 or a.shape[1] % spec.tp:
        return _impl_gemm_2d(impl, a, b, shard.unsharded_route(route))
    mesh = shard._mesh_for(spec)
    out = _impl_gemm_2d(impl, shard._block(a, 1, mesh, "model"),
                        shard._block(b, 0, mesh, "model"), shard.unsharded_route(route))
    return shard._psum(out.to(torch.bfloat16), mesh, "model").float()


def step0_reference(loop, policy, microbatches: int = 1, plan_share: int = 1) -> dict:
    """One device's step 0 on ``loop``'s params and first batch: every
    token's loss (f32 logsumexp minus the label logit) and the five
    leaves' gradients of the mean loss, on the CPU.  The batch's rows go
    in ``microbatches`` equal parts whose gradients are summed and meaned,
    as data ranks mean theirs; every launch plans as ``plan_share`` times
    its grid would (``shard.planned_whole``), as a data rank's does."""
    from repro_torch.core.ops import shard
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import transformer
    params, _, _ = loop.init_or_restore(0)
    batch = loop.batch(SyntheticLMDataset(loop.data_cfg), 0)
    five = _five(params)
    rows = batch["tokens"].shape[0] // microbatches
    nlls, total = [], None
    with shard.planned_whole(plan_share):
        for i in range(microbatches):
            part = slice(i * rows, (i + 1) * rows)
            logits, _, _ = transformer.forward(params, batch["tokens"][part], loop.cfg,
                                               policy=policy, mode="train", remat=True)
            logits = logits.float()
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(
                -1, batch["labels"][part].long()[..., None])[..., 0]
            del logits
            g = torch.autograd.grad(nll.mean(), list(five.values()))
            total = g if total is None else [a + b for a, b in zip(total, g)]
            nlls.append(nll.detach())
    return {"nll": torch.cat(nlls).cpu(),
            "grads": {k: (g / microbatches).cpu() for k, g in zip(five, total)}}


def train_worker(rank: int, world: int, job: dict) -> dict:
    """One rank of the card's mesh training: ``job`` names the arch, the
    mesh (or "auto": fit the world), the batch, the step to train to
    (``run_to``) on a ``schedule_steps`` schedule (the full config, or the
smoke one with ``smoke``), the checkpoint directory
    (saved at ``run_to``; a later world resumes from it) and, where
    ``ref`` names the one-device step 0 saved by the caller, the step-0
    comparison: every token's loss by a forward before the run and the
    five gradients from the run's first step (and against each of the
    reference's ``alt`` gradient sets); the faulty ``controls`` are
    compared on their per-token losses.  ``launches`` are the run's
    alone; the step-0 forward's and the controls' are ``check_launches``."""
    import time

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core import ops
    from repro_torch.core.ops import shard
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import adamw
    from repro_torch.runtime import mesh as meshlib
    from repro_torch.runtime.world import rank_device
    dev = rank_device(job["device"], rank)
    cfg = (get_smoke if job.get("smoke") else get_config)(job["arch"])
    spec = meshlib.resolve_mesh_spec(job["mesh"], cfg, n_devices=world)
    policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab",
                                 backends={"gemm": "cuda", "attention": "cuda_fused"},
                                 require={fam: ("vjp",) for fam in ops.families()}, mesh=spec)
    loop = TrainLoop(cfg, policy=policy,
                     opt_cfg=adamw.AdamWConfig(warmup_steps=1,
                                               total_steps=job["schedule_steps"]),
                     data_cfg=DataConfig(global_batch=job["batch"], seq_len=job["seq"],
                                         vocab_size=cfg.vocab_size),
                     remat=True, device=dev, mesh=spec, ckpt_dir=job["ckpt"],
                     ckpt_every=job["run_to"])
    out: dict = {"mesh": spec.describe(), "rank": rank}
    grads: dict = {}
    if job.get("ref"):
        params, _, _ = loop.init_or_restore(0)
        ds = SyntheticLMDataset(loop.data_cfg)
        ref = torch.load(job["ref"], map_location="cpu") if rank == 0 else None

        def rel(g, want):
            return {k: ((g[k] - want[k]).norm() / want[k].norm()).item() for k in g}

        def compare(nll, g):
            if rank != 0:
                return None
            nll = nll.cpu()
            return {"loss": nll.mean().item(),
                    "loss_err": abs(nll.mean().item() - ref["nll"].mean().item()),
                    "token_loss_max_err": (nll - ref["nll"]).abs().max().item(),
                    "grad_rel_err": rel(g, ref["grads"]),
                    **{f"grad_rel_err_{name}": rel(g, alt)
                       for name, alt in ref.get("alt", {}).items()},
                    "finite": bool(torch.isfinite(nll).all())}

        checks0 = launch_counts()
        t0 = time.monotonic()
        # gathered once for the step-0 forward and the controls' forwards
        full = loop.gather_params(params)
        del params
        nll = token_losses(loop, full, loop.batch(ds, 0))
        _sync(dev)
        out["step0_forward_s"] = time.monotonic() - t0
        out["controls"] = {}
        for name in job.get("controls", ()):
            saved = (loop.batch, shard.sharded_gemm_2d)
            if name == "rows_repeated":
                loop.batch = _rows_repeated(loop)
            elif name == "bf16_row_epilogue":
                shard.sharded_gemm_2d = _bf16_row_gemm
            try:      # a control's per-token losses (its forward) tell it apart
                out["controls"][name] = compare(token_losses(loop, full, loop.batch(ds, 0)), {})
            finally:
                loop.batch, shard.sharded_gemm_2d = saved
        _sync(dev)
        checks1 = launch_counts()
        out["checks_s"] = time.monotonic() - t0
        # the step-0 forward's and the controls' launches: checks, not the path's
        out["check_launches"] = {k: checks1[k] - checks0.get(k, 0) for k in checks1}
        del full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        # step 0's gradients are the run's first step's: each of the five
        # leaves' data-parallel mean, as the step's hook hands it over
        index = {loop.paths.index(p): k for k, p in FIVE.items()}

        def observe(i, g):
            if rank == 0 and i in index and index[i] not in grads:
                grads[index[i]] = g.detach().cpu()
        loop.grad_observer = observe
    c0 = dict(shard.STATS)
    before = launch_counts()
    t0 = time.monotonic()
    _, _, hist = loop.run(job["run_to"], log_every=0)
    _sync(dev)
    wall = time.monotonic() - t0
    after = launch_counts()
    out.update(losses=hist, start=job["run_to"] - len(hist), wall_s=wall,
               step_s=[r["step_s"] for r in loop.log],
               grad_norm=[r["grad_norm"] for r in loop.log],
               peak_mem_gb=_peak_gb(dev),
               collective_s=shard.STATS["seconds"] - c0["seconds"],
               collective_calls=shard.STATS["calls"] - c0["calls"],
               collective_gb=(shard.STATS["bytes"] - c0["bytes"]) / 1e9,
               transport=shard.transport(),
               launches={k: after[k] - before.get(k, 0) for k in after})
    if job.get("ref"):
        out["step0"] = compare(nll, grads)
    return out


def serve_worker(rank: int, world: int, job: dict) -> dict:
    """One rank of the card's mesh serving: ``job`` names the arch (at
    full width, or its smoke config with ``smoke``; ``depth`` layers of
    ``pattern``), the mesh, the requests' prompts, the
    prompt whose prefill logits are compared, and ``ref``, where the
    caller saved the one-device logits."""
    import dataclasses
    import time

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import Segment
    from repro_torch.core import ops
    from repro_torch.core.ops import shard
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import api
    from repro_torch.runtime import serve_step
    from repro_torch.runtime.world import rank_device
    dev = rank_device(job["device"], rank)
    full = (get_smoke if job.get("smoke") else get_config)(job["arch"])
    cfg = dataclasses.replace(full, num_layers=job["depth"],
                              segments=(Segment(tuple(job["pattern"]), job["depth"]),))
    spec = shard.MeshSpec.parse(job["mesh"])
    policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab", backends=job["backends"],
                                 require={"attention": ("decode",)}, mesh=spec)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, batch_size=job["slots"], max_ctx=job["max_ctx"], policy=policy,
                      device=dev)
    eng.load(params)
    eng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=job["max_new"])
            for i, p in enumerate(job["prompts"])]
    before = launch_counts()
    c0 = dict(shard.STATS)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    stats = eng.run(reqs)
    _sync(dev)
    wall = time.monotonic() - t0
    after = launch_counts()
    prompt = {"tokens": torch.as_tensor(job["prompts"][0], device=dev)[None].long()}
    logits, _ = serve_step.make_prefill(cfg, policy, s_ctx=job["max_ctx"])(params, prompt)
    out = {"tokens": [r.out_tokens for r in reqs], "done": all(r.done for r in reqs),
           "wall_s": wall, "ticks": stats["ticks"], "tok_per_s": stats["tok_per_s"],
           "peak_mem_gb": _peak_gb(dev), "collective_s": shard.STATS["seconds"] - c0["seconds"],
           "collective_calls": shard.STATS["calls"] - c0["calls"],
           "transport": shard.transport(),
           "launches": {k: after[k] - before.get(k, 0) for k in after}}
    if rank == 0:
        ref = torch.load(job["ref"], map_location="cpu").to(dev)
        out["logits_max_err"] = (logits.float() - ref.float()).abs().max().item()
        out["logits_finite"] = bool(torch.isfinite(logits).all())
        out["logits_shape"] = list(logits.shape)
    return out


def jobs_worker(rank: int, world: int, jobs: list) -> dict:
    """Run several workers' jobs in one world, in order: ``jobs`` is a list
    of (name, job) with name "parity" (job: the cases), "train" or
    "serve"; returns each job's result by name.  One world saves every
    later worker the ranks' start (the process, CUDA and the kernels'
    libraries)."""
    import gc
    workers = {"parity": lambda r, w, job: parity_worker(r, w, job, "cuda"),
               "train": train_worker, "serve": serve_worker}
    out = {}
    for name, job in jobs:
        out[name] = workers[name](rank, world, job)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out
