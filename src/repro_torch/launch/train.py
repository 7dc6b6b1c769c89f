"""End-to-end training driver (twin of ``repro.launch.train``): data ->
train step -> checkpoint -> restart, with step-time monitoring and
elastic mesh selection.

Fault-tolerance contract, as in the JAX package:

  * checkpoints are atomic and sharded (checkpoint/manager.py); the
    run resumes from the latest complete step on any restart, node
    failure and planned restart alike;
  * the mesh is chosen from the SURVIVING rank count (runtime/mesh.py,
    ``--mesh auto``), so a restart on fewer ranks restores the same
    checkpoint onto the smaller mesh and re-resolves the route under the
    new degrees;
  * the data pipeline is stateless-resumable: batch i is a pure function
    of (seed, i), so only the step counter is checkpointed;
  * per-step wall-time telemetry flags stragglers (runtime/monitor.py);
  * optional residual-compensated gradient compression halves the
    data-parallel all-reduce's bytes (optim/compression.py; Eq. 1).

Over a mesh (``--mesh dp=2,tp=2``), each rank is a process: the launcher
starts ``mesh.size`` ranks itself (``runtime.world.spawn``) or joins the
world ``torchrun`` set up.  Every param and AdamW leaf is stored as the
rank's block of its ``Sharder`` placement (FSDP over ``data``, TP over
``model``) and gathered whole for a step; each data rank runs its rows of
the global batch through the mesh-carrying policy (the routed ops shard
over ``model`` / ``expert``), and the gradients are averaged over the
data axis.  On ``cuda`` there is one rank a card; several ranks share a
card only with ``--share-card``, and the run header says so.  A mesh
larger than the ranks or cards fails; nothing moves to the CPU.

Every family trains: an audio config's batches carry the encoder's
frames and a VLM config's its image rows (``DataConfig``'s frame and
image fields, set from the config as the JAX package's CLI sets them).
Entry points run on ``cuda`` unless asked for ``cpu``; ``cuda`` with no
card raises.  ``--tile-cache PATH`` loads a tile-autotune cache at start
(``core.ops.tiles``; the flag overrides an inherited ``REPRO_TILE_CACHE``).

Usage (CPU-scale example):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --device cpu --steps 5 --batch 2 --seq 32 \\
      --backend gemm=cuda --backend attention=cuda_fused
  (an MoE arch: --arch mixtral-8x7b ... --backend grouped=cuda_grouped;
  whisper-medium, internvl2-76b, rwkv6-7b and zamba2-7b take the same flags;
  four gloo ranks: add --mesh dp=2,tp=2 --ckpt-dir DIR, then resume on two
  with --mesh auto --nprocs 2)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.core import ops
from repro_torch.core.ops import shard
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, host_slice
from repro_torch.models import api
from repro_torch.optim import adamw, compression
from repro_torch.runtime import mesh as meshlib
from repro_torch.runtime import world
from repro_torch.runtime.act_sharding import make_constrainer, use_constrainer
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.monitor import StepMonitor, run_header
from repro_torch.runtime.sharding import MeshLayout, Sharder, gather, local_block, rank_coords
from repro_torch.runtime.train_step import make_loss_fn, make_train_step

__all__ = ["TrainLoop", "data_config", "main"]


def data_config(cfg, *, batch: int, seq: int, seed: int = 0) -> DataConfig:
    """The synthetic batches for ``cfg``: tokens, plus the encoder's frames
    (B, encoder_seq, d_model) for audio and the image rows (B,
    num_image_tokens, d_model) for vlm."""
    audio, vlm = cfg.family == "audio", cfg.family == "vlm"
    return DataConfig(global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size, seed=seed,
                      frames_dim=cfg.d_model if audio else 0,
                      frames_seq=cfg.encoder_seq if audio else 0,
                      image_tokens=cfg.num_image_tokens if vlm else 0,
                      image_dim=cfg.d_model if vlm else 0)


class TrainLoop:
    """Restart-safe training loop over one (config, policy, device[,
    mesh]).  With a non-identity ``mesh`` (a ``MeshSpec``) the loop runs
    as one rank of an initialized process group (see the module
    docstring); ``compress`` sends the data-parallel gradient mean as
    bf16 with f32 error feedback."""

    def __init__(self, cfg, *, policy: PrecisionPolicy,
                 opt_cfg: adamw.AdamWConfig, data_cfg: DataConfig,
                 ckpt_dir: str | None = None, microbatches: int = 1,
                 remat: bool = True, ckpt_every: int = 25,
                 device: str | torch.device = "cuda",
                 mesh: meshlib.MeshSpec | None = None, compress: bool = False):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.ckpt_every = ckpt_every
        self.device = resolve_device(device)
        self.mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.monitor = StepMonitor()
        self.mesh = shard.active_mesh(mesh)
        self.rank = 0
        if self.mesh is None:
            self.step_fn = make_train_step(cfg, opt_cfg, policy,
                                           microbatches=microbatches, remat=remat)
        else:
            import torch.distributed as dist
            if not dist.is_initialized():
                raise RuntimeError(f"mesh {self.mesh.describe()} needs a process group: "
                                   f"start the ranks with the train CLI or torchrun")
            if isinstance(policy, ops.ExecutionPolicy) and policy.mesh != self.mesh:
                policy = dataclasses.replace(policy, mesh=self.mesh)
            self.rank = dist.get_rank()
            self.coords = rank_coords(self.mesh, self.rank)
            self.sharder = Sharder(cfg, self.mesh, policy=policy
                                   if isinstance(policy, ops.ExecutionPolicy) else None)
            self.constrainer = make_constrainer(self.sharder)
            self.microbatches = microbatches
            self.loss_fn = make_loss_fn(cfg, policy, remat=remat)
            self.compress = compress
            self.error = None
            self.step_fn = self._mesh_step
        self.policy = policy
        # per-step records of the last run: step, loss, grad_norm, lr, step_s
        self.log: list[dict] = []

    # ------------------------------------------------------------ state

    def init_or_restore(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = api.init_params(self.cfg, gen, self.device)
        if self.mesh is not None:
            params = self._to_blocks(params)
        opt = adamw.init(params)
        start = 0
        if self.mgr is not None:
            if self.rank == 0:
                self.mgr.clean_tmp()          # crash garbage from a prior run
            latest = self.mgr.latest_step()
            if latest is not None:
                params, opt = self.mgr.restore(latest, (params, opt), layout=self.layout)
                start = latest
        for p in leaves(params):
            p.requires_grad_(self.mesh is None)
        return params, opt, start

    def batch(self, ds: SyntheticLMDataset, i: int) -> dict:
        """Batch ``i``, on a mesh this data rank's rows of it."""
        b = ds.batch(i)
        if self.mesh is not None:
            dp = self.mesh.pod * self.mesh.dp
            d = self.coords.get("pod", 0) * self.mesh.dp + self.coords["data"]
            start, size = host_slice(self.data_cfg.global_batch, self.data_cfg.seq_len,
                                     proc=d, nproc=dp)
            b = {k: v[start:start + size] for k, v in b.items()}
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    # ------------------------------------------------------------- mesh

    layout = None
    # called as (leaf index, whole gradient) with each leaf's data-parallel
    # mean during a mesh step, before its block is taken
    grad_observer = None

    def _to_blocks(self, params):
        """Whole params -> this rank's blocks; fixes the placements and
        the checkpoint layout of (params, AdamW state)."""
        paths = list(leaves_with_paths(params))
        self.paths = [p for p, _ in paths]
        self.specs = [self.sharder.param_spec(p, tuple(x.shape)) for p, x in paths]
        self.shapes = [tuple(x.shape) for _, x in paths]
        self.layout = MeshLayout(self.specs + [()] + self.specs + self.specs,
                                 self.shapes + [()] + self.shapes + self.shapes,
                                 self.mesh, self.rank)
        it = iter(self.specs)
        return tree_map(lambda x: local_block(x, next(it), self.mesh, self.coords), params)

    def gather_params(self, params):
        """The whole params from this rank's blocks (every rank calls it)."""
        dm = self.mesh.build()
        it = iter(self.specs)
        return tree_map(lambda b: gather(b.detach(), next(it), self.mesh, dm), params)

    def _dp_mean(self, tree):
        """Mean over the data-parallel axes, summed in f32 in place."""
        m = shard._Mesh(self.mesh)
        tree = tree_map(lambda g: g.float().contiguous(), tree)
        for a in ("pod", "data"):
            if m.sizes.get(a, 1) > 1:
                for g in leaves(tree):
                    shard.psum_(g, m, a).div_(m.size(a))
        return tree

    def _mesh_step(self, params, opt_state, batch):
        """One step over the mesh.  The rank's rows run as ``microbatches``
        equal pieces, each piece's backward accumulating into ``.grad``;
        the last backward hands each whole gradient (the sum over the
        pieces) to a hook as soon as it is accumulated: the hook divides it
        by the piece count, means it over the data-parallel axes (f32 sums
        in place, or the compressed mean over ``data``), keeps this rank's
        block and drops the rest, so a rank holds the whole params but all
        of their whole gradients only between pieces."""
        full = self.gather_params(params)
        flat = leaves(full)
        m = shard._Mesh(self.mesh)
        axes = [a for a in ("pod", "data") if m.sizes.get(a, 1) > 1]
        compress = self.compress and "data" in axes
        if compress and self.error is None:
            self.error = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                          for p in flat]
        k = self.microbatches
        rows = batch["tokens"].shape[0]
        if rows % k:
            raise ValueError(f"a data rank's {rows} rows not divisible by microbatches {k}")
        n = rows // k
        blocks: list = [None] * len(flat)
        sq: list = [None] * len(flat)

        def reduce(i: int, g: torch.Tensor) -> None:
            g = g.float().contiguous()
            if k > 1:
                g.div_(k)
            if compress:
                g, self.error[i] = compression.compress_mean(g, self.error[i], self.mesh, "data")
            for a in axes:
                if not (compress and a == "data"):
                    shard.psum_(g, m, a).div_(m.size(a))
            sq[i] = g.square().sum()
            if self.grad_observer is not None:
                self.grad_observer(i, g)
            blocks[i] = local_block(g, self.specs[i], self.mesh, self.coords)

        def hook(i):
            def fn(p):
                reduce(i, p.grad)
                p.grad = None
            return fn

        for p in flat:
            p.requires_grad_(True)
        sums: dict = {}
        handles: list = []
        try:
            with (shard.local_batch(self.mesh.pod * self.mesh.dp),
                  use_constrainer(self.constrainer)):
                for j in range(k):
                    if j == k - 1:       # the hooks see the summed gradient only
                        handles = [p.register_post_accumulate_grad_hook(hook(i))
                                   for i, p in enumerate(flat)]
                    piece = {key: v[j * n:(j + 1) * n] for key, v in batch.items()}
                    total, mt = self.loss_fn(full, piece)
                    total.backward()
                    for key, v in mt.items():
                        sums[key] = sums[key] + v.detach() if key in sums else v.detach()
                    del total, mt      # their graph holds the whole params
        finally:
            for h in handles:
                h.remove()
        del full, flat
        metrics = self._dp_mean({key: v / k for key, v in sums.items()})
        gnorm = torch.sqrt(sum(sq))
        it = iter(blocks)
        blocks = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw.step(self.opt_cfg, opt_state, params, blocks,
                                           gnorm=gnorm)
        return params, opt_state, dict(metrics, **om)

    # -------------------------------------------------------------- run

    def run(self, steps: int, *, seed: int = 0, log_every: int = 10,
            fail_at_step: int | None = None):
        """Train to ``steps``.  ``fail_at_step`` injects a crash (tests)."""
        params, opt, start = self.init_or_restore(seed)
        ds = SyntheticLMDataset(self.data_cfg)
        history: list[float] = []
        self.log = []
        try:
            for i in range(start, steps):
                if fail_at_step is not None and i == fail_at_step:
                    raise RuntimeError(f"injected failure at step {i}")
                batch = self.batch(ds, i)
                self.monitor.start()
                params, opt, metrics = self.step_fn(params, opt, batch)
                loss = float(metrics["loss"])          # waits for the step
                stats = self.monitor.stop()
                history.append(loss)
                self.log.append({"step": i + 1, "loss": loss,
                                 "aux_loss": float(metrics["aux_loss"]),
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr": float(metrics["lr"]), "step_s": stats.last_s})
                if stats.straggler and self.rank == 0:
                    print(f"[straggler] step {i}: {stats.last_s:.3f}s "
                          f"vs median {stats.median_s:.3f}s", flush=True)
                if log_every and (i + 1) % log_every == 0 and self.rank == 0:
                    print(f"step {i + 1:5d} loss={loss:.4f} "
                          f"gnorm={self.log[-1]['grad_norm']:.3f} "
                          f"lr={self.log[-1]['lr']:.2e} "
                          f"{stats.last_s * 1e3:.0f}ms", flush=True)
                if self.mgr and (i + 1) % self.ckpt_every == 0:
                    if self.layout is None:
                        self.mgr.save_async(i + 1, (params, opt))
                    else:
                        self.mgr.save(i + 1, (params, opt), layout=self.layout)
        finally:
            if self.mgr:
                self.mgr.wait()
        if self.mgr and self.mgr.latest_step() != steps:
            self.mgr.save(steps, (params, opt), layout=self.layout)
        return params, opt, history


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--policy", default="bf16",
                    help="default precision policy for every matmul")
    ap.add_argument("--logits-policy", default=None)
    ap.add_argument("--backend", action="append", default=None,
                    metavar="FAMILY=IMPL",
                    help="op-registry routing, repeatable: 'family=impl' "
                         f"(families: {', '.join(ops.families())}; impls: "
                         "gemm torch|cuda, attention torch|cuda_fused, "
                         "grouped torch|cuda_grouped)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains; 'cuda' fails without a card")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="device mesh: 'dp=2,tp=2,ep=2' (any subset), 'auto' (fit the "
                         "rank count, capped at the arch's divisible TP/EP degrees), or "
                         "'none' (default, one device).  Every routed impl must declare "
                         "a Partitioning")
    ap.add_argument("--use-mesh", action="store_true",
                    help="DEPRECATED: alias for --mesh auto")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="ranks to start (default: the mesh's size; for --mesh auto the "
                         "visible cards on cuda, 1 on cpu)")
    ap.add_argument("--share-card", action="store_true",
                    help="allow several ranks on one card (gloo collectives)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="bf16-wire data-parallel gradient mean with f32 error feedback")
    ap.add_argument("--timeout", type=float, default=86400.0,
                    help="seconds a rank may run before the launcher stops the world")
    ap.add_argument("--tile-cache", default=None, metavar="PATH",
                    help="JSON tile-autotune cache: loaded at start, and where new "
                         "autotune results are saved (also via REPRO_TILE_CACHE, "
                         "which the flag overrides)")
    return ap


def _policy(args, cfg, mesh):
    # Training differentiates through every routed op: demand vjp of
    # each family's impl at route build.
    return execution_policy_for(
        cfg, default=args.policy, logits=args.logits_policy,
        backends=ops.parse_backend_flags(args.backend),
        require={fam: ("vjp",) for fam in ops.families()}, mesh=mesh)


def _train(args, cfg, policy, device, mesh=None) -> list[float]:
    loop = TrainLoop(
        cfg, policy=policy,
        opt_cfg=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps),
        data_cfg=data_config(cfg, batch=args.batch, seq=args.seq),
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, device=device, mesh=mesh,
        compress=args.compress_grads)
    t0 = time.time()
    _, _, hist = loop.run(args.steps, log_every=1)
    if hist and loop.rank == 0:
        print(f"\ntrained {len(hist)} steps in {time.time() - t0:.1f}s; "
              f"loss {hist[0]:.3f} -> {hist[-1]:.3f}", flush=True)
    return hist


def _rank_main(rank: int, world_size: int, argv: list[str], mesh_text: str):
    """One rank of the launcher's world (``runtime.world.spawn``)."""
    args = _parser().parse_args(argv)
    ops.use_tile_cache(args.tile_cache)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = meshlib.MeshSpec.parse(mesh_text)
    device = world.rank_device(args.device, rank)
    return _train(args, cfg, _policy(args, cfg, mesh), device, mesh)


def main(argv=None) -> list[float]:
    """The CLI; returns the losses of the steps it trained (rank 0's)."""
    argv = list(argv) if argv is not None else None
    args = _parser().parse_args(argv)
    n_tiles = ops.use_tile_cache(args.tile_cache)     # the flag or REPRO_TILE_CACHE
    if n_tiles:
        print(f"tile cache: {n_tiles} shape(s) loaded from {ops.tile_cache_path()}",
              flush=True)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    flag = meshlib.resolve_mesh_flag(args.mesh, args.use_mesh)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    n = args.nprocs
    if torchrun:
        n = int(os.environ["WORLD_SIZE"])
    elif n is None and flag is not None and flag.strip().lower() == "auto":
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = meshlib.resolve_mesh_spec(flag, cfg, n_devices=n)
    ranks = mesh.size if mesh is not None else 1
    if n is not None and n != ranks:
        raise SystemExit(f"--mesh {flag!r} places {ranks} rank(s); the world has {n}")
    policy = _policy(args, cfg, mesh)
    header = run_header(args.arch, policy=policy, mesh=policy.mesh) + f" | device {device}"
    if ranks == 1:
        print(header, flush=True)
        return _train(args, cfg, policy, device)
    backend = world.backend_for(device.type, ranks, share_card=args.share_card)
    if device.type == "cuda" and backend == "gloo":
        header += f" | {ranks} ranks share {torch.cuda.device_count()} card(s) (gloo)"
    else:
        header += f" | {ranks} ranks ({backend})"
    if torchrun:
        rank, _, dev = world.join_from_env(device.type, share_card=args.share_card)
        if rank == 0:
            print(header, flush=True)
        return _train(args, cfg, policy, dev, mesh)
    print(header, flush=True)
    return world.spawn(_rank_main, ranks, args=(argv if argv is not None else sys.argv[1:],
                                                mesh.describe()),
                       device=device.type, share_card=args.share_card, timeout=args.timeout)[0]


if __name__ == "__main__":
    main()
