"""End-to-end training driver (twin of ``repro.launch.train``): data ->
train step -> checkpoint -> restart, with step-time monitoring, on one
device.

Fault-tolerance contract, as in the JAX package:

  * checkpoints are atomic (checkpoint/manager.py); the driver resumes
    from the latest complete step on any restart;
  * the data pipeline is stateless-resumable: batch i is a pure function
    of (seed, i), so only the step counter is checkpointed;
  * per-step wall-time telemetry flags stragglers (runtime/monitor.py).

Every family trains: an audio config's batches carry the encoder's
frames and a VLM config's its image rows (``DataConfig``'s frame and
image fields, set from the config as the JAX package's CLI sets them).
The mesh, elastic resharding and gradient compression wait for the
multi-device slice.  Entry points run on ``cuda`` unless asked for
``cpu``; ``cuda`` with no card raises.

Usage (CPU-scale example):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --device cpu --steps 5 --batch 2 --seq 32 \\
      --backend gemm=cuda --backend attention=cuda_fused
  (an MoE arch: --arch mixtral-8x7b ... --backend grouped=cuda_grouped;
  whisper-medium, internvl2-76b, rwkv6-7b and zamba2-7b take the same flags)
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import execution_policy_for
from repro_torch.core import ops
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.monitor import StepMonitor, run_header
from repro_torch.runtime.train_step import make_train_step

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
    """Restart-safe training loop over one (config, policy, device)."""

    def __init__(self, cfg, *, policy: PrecisionPolicy,
                 opt_cfg: adamw.AdamWConfig, data_cfg: DataConfig,
                 ckpt_dir: str | None = None, microbatches: int = 1,
                 remat: bool = True, ckpt_every: int = 25,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.policy = policy
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.ckpt_every = ckpt_every
        self.device = resolve_device(device)
        self.mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.monitor = StepMonitor()
        self.step_fn = make_train_step(cfg, opt_cfg, policy,
                                       microbatches=microbatches, remat=remat)
        # per-step records of the last run: step, loss, grad_norm, lr, step_s
        self.log: list[dict] = []

    # ------------------------------------------------------------ state

    def init_or_restore(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = api.init_params(self.cfg, gen, self.device)
        opt = adamw.init(params)
        start = 0
        if self.mgr is not None:
            self.mgr.clean_tmp()          # crash garbage from a prior run
            latest = self.mgr.latest_step()
            if latest is not None:
                params, opt = self.mgr.restore(latest, (params, opt))
                start = latest
        for p in leaves(params):
            p.requires_grad_(True)
        return params, opt, start

    def batch(self, ds: SyntheticLMDataset, i: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in ds.batch(i).items()}

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
                if stats.straggler:
                    print(f"[straggler] step {i}: {stats.last_s:.3f}s "
                          f"vs median {stats.median_s:.3f}s", flush=True)
                if log_every and (i + 1) % log_every == 0:
                    print(f"step {i + 1:5d} loss={loss:.4f} "
                          f"gnorm={self.log[-1]['grad_norm']:.3f} "
                          f"lr={self.log[-1]['lr']:.2e} "
                          f"{stats.last_s * 1e3:.0f}ms", flush=True)
                if self.mgr and (i + 1) % self.ckpt_every == 0:
                    self.mgr.save_async(i + 1, (params, opt))
        finally:
            if self.mgr:
                self.mgr.wait()
        if self.mgr:
            self.mgr.save(steps, (params, opt))
        return params, opt, history


def main(argv=None) -> None:
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    # Training differentiates through every routed op: demand vjp of
    # each family's impl at route build.
    policy = execution_policy_for(
        cfg, default=args.policy, logits=args.logits_policy,
        backends=ops.parse_backend_flags(args.backend),
        require={fam: ("vjp",) for fam in ops.families()})
    print(run_header(args.arch, policy=policy) + f" | device {device}", flush=True)
    loop = TrainLoop(
        cfg, policy=policy,
        opt_cfg=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps),
        data_cfg=data_config(cfg, batch=args.batch, seq=args.seq),
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, device=device)
    t0 = time.time()
    _, _, hist = loop.run(args.steps, log_every=1)
    if hist:
        print(f"\ntrained {len(hist)} steps in {time.time() - t0:.1f}s; "
              f"loss {hist[0]:.3f} -> {hist[-1]:.3f}")


if __name__ == "__main__":
    main()
