#!/usr/bin/env python3
"""How far the bf16 flash kernels part from their plain versions over many
seeded inputs, on one NVIDIA GPU:

    python3 tools/flash_flip_tails.py [--draws 40]

Kernel and plain version round each probability P to bf16 for the P.V
product; where their f32 scores differ in the last place, a P that sits
near a rounding midpoint rounds to neighbouring bf16 values in the two,
which moves an output by 2^-8 |v| / l.  That is rare per element and
largest in the early causal rows (few keys, l near 1), so its worst case
grows with the number of heads.  For each head shape of zamba2-7b (hd 112,
32 heads on 32 kv heads) and nemotron-4-340b (hd 192, 96 on 8) and each
draw (seeds 100, 101, ...; ``chip_smoke.py``'s input recipe): the forward
(S = 700, causal) and the decode (B = 4, a linear 1024-row cache at
``chip_smoke.py``'s positions), max |kernel - plain| and, at the forward's
worst element, each version's distance to the same walk with P unrounded
(precision f32), the forward's error over the query rows with 64 keys or
more and, over the first 64 rows, in units of each output element's
softmax-weighted |v| (the two measures ``chip_smoke.py`` holds nemotron's
row to), and the controls ``chip_smoke.py`` uses (the forward's plain
version at window S / 2, the decode's one key short).  Prints the
card's name and power limit, then one JSON line a head shape.  Exits 1
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"zamba2-7b": (32, 32, 112), "nemotron-4-340b": (96, 8, 192)}
S, S_CACHE = 700, 1024
POS = [40, 300, 611, 1000]
FEW_KEYS = 64


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=40)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_flip_tails: no GPU", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_fused as af

    _build.build_all(["attention_fused"])
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    pos = torch.tensor(POS, dtype=torch.int32, device=dev)
    for arch, (heads, kvh, hd) in SHAPES.items():
        g = heads // kvh
        rows = []
        for seed in range(100, 100 + args.draws):
            gen = torch.Generator(device=dev).manual_seed(seed)

            def randn(shape, scale=1.0, gen=gen):
                return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

            q = randn((1, S, kvh, g, hd), hd ** -0.5)
            k, v = randn((1, S, kvh, hd)), randn((1, S, kvh, hd))
            out = af.flash_attention(q, k, v, causal=True)
            plain = af.flash_attention_plain(q, k, v, causal=True)[0]
            unrounded = af.flash_attention_plain(q, k, v, causal=True, precision="f32")[0]
            control = af.flash_attention_plain(q, k, v, causal=True, window=S // 2)[0]
            diff = (out - plain).abs()
            sc = torch.einsum("tkgd,jkd->kgtj", q[0, :FEW_KEYS].float(),
                              k[0, :FEW_KEYS].float())
            sc = sc.masked_fill(torch.ones(FEW_KEYS, FEW_KEYS, dtype=torch.bool, device=dev
                                           ).triu(1), float("-inf"))
            wv = torch.einsum("kgtj,jkd->tkgd", torch.softmax(sc, -1),
                              v[0, :FEW_KEYS].float().abs())
            worst = int(diff.argmax())
            qd = randn((4, 1, kvh, g, hd), hd ** -0.5)
            kc, vc = randn((4, S_CACHE, kvh, hd)), randn((4, S_CACHE, kvh, hd))
            dec = af.flash_decode(qd, kc, vc, pos)
            rows.append({
                "seed": seed, "forward_err": diff.max().item(),
                "forward_worst_row": int(torch.unravel_index(torch.tensor(worst), diff.shape)[1]),
                "forward_err_64_keys_up": diff[:, FEW_KEYS:].max().item(),
                "first_rows_scaled_err": (diff[0, :FEW_KEYS] / wv).max().item(),
                "kernel_to_unrounded_there": (out - unrounded).abs().flatten()[worst].item(),
                "plain_to_unrounded_there": (plain - unrounded).abs().flatten()[worst].item(),
                "forward_control_err": (out - control).abs().max().item(),
                "decode_err": (dec - af.flash_decode_plain(qd, kc, vc, pos)).abs().max().item(),
                "decode_control_err": (dec - af.flash_decode_plain(qd, kc, vc, pos - 1)
                                       ).abs().max().item()})
        fwd = sorted(r["forward_err"] for r in rows)
        print(json.dumps({
            "arch": arch, "heads": heads, "kv_heads": kvh, "head_dim": hd, "draws": len(rows),
            "forward_err_range": [fwd[0], fwd[-1]], "forward_err_median": fwd[len(fwd) // 2],
            "forward_above_2e-3": sum(e > 2e-3 for e in fwd),
            "forward_64_keys_up_max": max(r["forward_err_64_keys_up"] for r in rows),
            "forward_64_keys_up_above_2e-3": sum(r["forward_err_64_keys_up"] > 2e-3
                                                 for r in rows),
            "first_rows_scaled_max": max(r["first_rows_scaled_err"] for r in rows),
            "forward_control_min": min(r["forward_control_err"] for r in rows),
            "decode_err_max": max(r["decode_err"] for r in rows),
            "decode_control_min": min(r["decode_control_err"] for r in rows),
            "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
