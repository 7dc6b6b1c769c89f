#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phases of the large configs (28-31)
and the check rows of phases 25-30 alone, on one NVIDIA GPU or, at the
smoke configs, on the CPU:

    python3 tools/train_giant_phases.py                  # rows, then 28-31
    python3 tools/train_giant_phases.py --no-rows --phases 30
    python3 tools/train_giant_phases.py --phases 30 --both-cr-controls
    python3 tools/train_giant_phases.py --cpu            # smoke rehearsal

It reads ``chip_smoke.py``'s source and executes, in a namespace of the
script's module globals: ``main()``'s preamble (imports, the launch
counters), the build, the check helpers, the helper functions these
phases call (found by name), a few of ``main()``'s statements (found by
their first words) and the phase blocks (found by their marker
comments), so it runs the script's own code, and needs updating only
where those names or markers change.  A failed check prints ``PROBE
FAIL`` and the run goes on to the next phase.  ``--both-cr-controls``
runs phase 30 a second time with the MLP ``wo`` rows rolled by one as
its control in place of the fp8 MLPs.  ``--cpu`` runs the phases at the
smoke configs with the device calls stubbed (no kernel launches there,
so every launch check fails; ~15 s): a check of the phases' Python.
About 2 minutes of card time with the build.
"""
from __future__ import annotations

import argparse
import ast
import gc
import sys
import textwrap
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# main()'s helper functions the phases call, and the statements (by their
# first words) that define the policies and configs they read
HELPERS = {"grouped_mm_library", "vocab_chunked", "causal_prefill_row", "rolled_experts",
           "recording_top_k", "param_heads", "step0_params", "loop_from_step0", "moe_leaves",
           "pinned_top_k", "moe_loss_and_grads", "flipped", "mrel", "moe_step0", "token_nll",
           "family_loop", "train_run", "unembed_by_checkpointed_chunks", "train_family",
           "giant_config", "seed_biases", "zero_biases"}
STATEMENTS = ("sms = ", "pos = torch.tensor", "mcfg_full = ", "grouped_route = ",
              "mref_policy = ", "fp8_kernel_policy = ", "top_k_fn = ", "mfive = ",
              "real_unembed = ", "from repro_torch.launch.train import data_config",
              "from repro_torch.models import vlm as vlm_mod")
ROLLED_MLP_WO = """def rolled_mlp_wo(p):
    q = dict(p, layers=list(p["layers"]))
    lp = q["layers"][1]
    q["layers"][1] = dict(lp, wo={**lp["wo"], "w": lp["wo"]["w"].detach().roll(1, 0)})
    return q
"""


class Failed(Exception):
    pass


def fail(msg):
    print("PROBE FAIL:", msg, flush=True)
    raise Failed(msg)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-rows", action="store_true")
    ap.add_argument("--phases", default="28,29,30,31")
    ap.add_argument("--both-cr-controls", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    import torch

    src = (ROOT / "chip_smoke.py").read_text()
    lines = src.splitlines()
    script_main = next(n for n in ast.parse(src).body
                       if isinstance(n, ast.FunctionDef) and n.name == "main")
    ns = dict(vars(cs), fail=fail)
    t0 = time.monotonic()

    def seg(a, b):
        return textwrap.dedent("\n".join(lines[a - 1:b]))

    def line_of(marker, after=script_main.lineno):
        return next(i for i, ln in enumerate(lines[after:], after + 1) if marker in ln)

    def run(code, what):
        print(f"--- {what} ({time.monotonic() - t0:.1f} s)", flush=True)
        exec(compile(code, f"<{what}>", "exec"), ns)

    preamble = seg(line_of("if not (ROOT"), line_of("# ---------------------------------------"
                                                     "--------------------- 1 device") - 1)
    run(preamble.replace('sys.path.insert(0, str(ROOT / "src"))', "pass")
        .replace("if not torch.cuda.is_available():", "if False:"), "preamble")
    if args.cpu:
        from repro_torch.configs import get_smoke
        ns.update(get_config=get_smoke, dev=torch.device("cpu"))
        for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
        ns["_build"].BUILD_DIR.mkdir(parents=True, exist_ok=True)
    else:
        ns["dev"] = torch.device("cuda")
        run(seg(line_of("# ------------------------------------------------------------- 2 build"),
                line_of("# ------------------------------------------------------------- 3 check")
                - 1), "build")
    c3 = line_of("# ------------------------------------------------------------- 3 check")
    run(seg(c3, line_of("d, ff, vocab, hd = cfg.d_model", c3)), "check helpers")
    if args.cpu:
        ns["profile_window"] = lambda fn: {}
    ns["moe_backends"] = {"gemm": "cuda", "attention": "cuda_fused", "grouped": "cuda_grouped"}
    for n in script_main.body:
        start = n.decorator_list[0].lineno if getattr(n, "decorator_list", None) else n.lineno
        text = seg(start, n.end_lineno)
        if isinstance(n, ast.FunctionDef) and n.name in HELPERS:
            run(text, n.name)
        elif text.startswith(STATEMENTS) and not (args.cpu and text.startswith(("sms", "pos"))):
            run(text, text.splitlines()[0][:40])

    if not (args.no_rows or args.cpu):
        run("s_cache = 1024\nlive = torch.arange(s_cache, device=dev)[None, :] <= "
            "pos.long()[:, None]\nn_live = int(live.sum())", "decode inputs")
        a = line_of("# ---- the shapes of phases 25-27")
        run(seg(a, line_of("# ------------------------------------------------------------- 4 serve",
                           a) - 1), "check rows 25-30")

    a = line_of("# ----------------------------------------- 28-30 train")
    marks = ["# ---- 28 train_dbrx", "# ---- 29 train_starcoder2", "# ---- 30 train_command_r",
             "# ------------------------------------------------------------- 31 tiles",
             "# ----------------------------------------------------------- 32 kernels"]
    starts = [line_of(m, a) for m in marks]
    blocks = {str(28 + i): (starts[i], starts[i + 1] - 1) for i in range(4)}
    for ph in args.phases.split(","):
        variants = [seg(*blocks[ph])]
        if ph == "30" and args.both_cr_controls:
            run(ROLLED_MLP_WO, "rolled_mlp_wo")
            variants.append(variants[0].replace(
                'control_policy=fp8_kernel_policy, control_name="fp8-MLP"',
                'control_params=rolled_mlp_wo, control_name="rolled-MLP-wo"'))
        for i, code in enumerate(variants):
            try:
                run(code, f"phase {ph}.{i}")
            except Failed:
                pass
            except Exception:
                traceback.print_exc()
                sys.stdout.flush()
            gc.collect()
            if not args.cpu:
                torch.cuda.empty_cache()
    print(f"done in {time.monotonic() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
