#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mesh phase (24) alone on one NVIDIA GPU, or
its step-0 witness:

    python3 tools/mesh_phase.py             # the phase
    python3 tools/mesh_phase.py --witness   # what parts the step-0 gradients

Builds the kernels, then the phase's inputs through ``chip_smoke``'s own
builders (``train_setup``: phase 7's gemma3-1b ``TrainLoop``, 2 x 1024
tokens; ``prompt_lens`` and ``moe_setup``: serve_moe's Mixtral policy and
requests), and calls ``chip_smoke.mesh_phase``, which prints the
``mesh_parity``, ``mesh_train``, ``mesh_serve`` and ``mesh`` lines and
exits 1 on a fault.  The lines' one-device train times (phase 7's) are
null here.  About 5-7 minutes of card time.

``--witness`` takes the mesh train run's step 0 apart, one axis at a
time.  On one device it computes step 0 (every token's loss, the five
gradient leaves of ``mesh_checks.FIVE``) on the whole batch, at 2
microbatches, and at 2 microbatches with every launch planned as the
whole batch's (``shard.planned_whole(2)``, as a data rank plans), and
prints each against the whole batch's.  Then it trains one step on two
ranks sharing the card at ``dp=2`` and at ``tp=2``, and prints each
rank-0 step 0 against all three.  About 3 minutes of card time.  Exits 1
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TRAIN_BATCH, TRAIN_SEQ = 2, 1024        # phase 7's batch
WITNESS_MESHES = ("dp=2", "tp=2")


def rel_err(got: dict, want: dict) -> dict:
    return {k: ((got[k] - want[k]).norm() / want[k].norm()).item() for k in want}


def witness(loop, tpolicy) -> None:
    import torch

    import chip_smoke
    from repro_torch.runtime import mesh_checks, world
    refs = {"whole": mesh_checks.step0_reference(loop, tpolicy),
            "microbatches_2": mesh_checks.step0_reference(loop, tpolicy, microbatches=2),
            "microbatches_2_planned": mesh_checks.step0_reference(loop, tpolicy, microbatches=2,
                                                                  plan_share=2)}
    whole = refs["whole"]
    for name, r in refs.items():
        print(json.dumps({"witness": "one_device", "ref": name, "vs": "whole",
                          "token_loss_max_err": (r["nll"] - whole["nll"]).abs().max().item(),
                          "grad_rel_err": rel_err(r["grads"], whole["grads"])}), flush=True)
    with tempfile.TemporaryDirectory(prefix="witness_") as tmp:
        torch.save(dict(whole, alt={k: r["grads"] for k, r in refs.items() if k != "whole"}),
                   f"{tmp}/ref.pt")
        del refs, whole
        torch.cuda.empty_cache()
        for mesh in WITNESS_MESHES:
            job = dict(device="cuda", arch="gemma3-1b", mesh=mesh, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, run_to=1,
                       schedule_steps=chip_smoke.MESH_TRAIN_STEPS + chip_smoke.MESH_RESUME_STEPS,
                       ckpt=None, ref=f"{tmp}/ref.pt", controls=())
            t0 = time.monotonic()
            ranks = world.spawn(mesh_checks.jobs_worker, 2, args=([("train", job)],),
                                device="cuda", share_card=True,
                                timeout=chip_smoke.MESH_TIMEOUT)
            r0 = ranks[0]["train"]
            print(json.dumps({"witness": mesh, "ranks": 2, "mesh_described": r0["mesh"],
                              "step0": r0["step0"], "world_s": time.monotonic() - t0}),
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--witness", action="store_true",
                    help="take the mesh train run's step 0 apart instead of running the phase")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no GPU", file=sys.stderr)
        sys.exit(1)
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.device import resolve_device

    dev = resolve_device("cuda")
    t0 = time.monotonic()
    _build.build_all()
    print(f"build {time.monotonic() - t0:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = get_config("gemma3-1b")
    tpolicy, loop = chip_smoke.train_setup(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    t0 = time.monotonic()
    if args.witness:
        witness(loop, tpolicy)
    else:
        lens = chip_smoke.prompt_lens(np.random.default_rng(0))
        mixtral, moe_backends, mpolicy, mreqs = chip_smoke.moe_setup(
            get_config("mixtral-8x7b"), lens)
        chip_smoke.mesh_phase(dev, cfg, loop, tpolicy, None, None, mixtral, mpolicy,
                              moe_backends, mreqs)
    print(f"{'witness' if args.witness else 'phase'} {time.monotonic() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
