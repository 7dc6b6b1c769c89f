"""Kernel-site rules: judge one traced launch (twin of
``repro.analysis.pallas_rules``).

What a ``KernelSite`` proves without running the kernel:

  PAL001  every split range the wrapper hands the launcher lies inside
          the tile grid it splits (``split_total`` tiles) and none is
          empty; and where the wrapper computes the grid, each operand
          tile map evaluated at the grid's corner CTAs (all-0 / all-max
          block indices) gives a tile inside the operand's tile grid.
  PAL002  where the kernel takes whole tiles only (a ``divisible`` block,
          or an impl that declares ``pads_to_tiles``), the tile divides
          the operand.
  PAL003  a floating accumulator or split-K workspace narrower than f32
          reintroduces the accumulate-in-half error the paper measures.
  PAL004  (judged by the auditor from the trace's plain-version record):
          a ``cuda*`` route reached a kernel's plain version.

Which sites carry which evidence: split ranges at every split launch
(``gemm_tiled`` and ``gemm_refined`` at both mainloops, the grouped
16-row stream, dense and paged decode); corner tile maps where the wrapper
computes the grid (``gemm_lowp``'s decode plan, the packed batched
stream); whole tiles for ``gemm_naive``'s padded operands, the packed
stream's packing, the grouped alignment and the WKV6 chunks.  The grids
the C launchers compute for themselves (the wgmma and WMMA mainloops,
the flash kernels) are out of reach, as ``repro`` skips index maps that
take scalar-prefetch operands.
"""

from __future__ import annotations

import itertools

from repro_torch.analysis.graph_scan import float_bits
from repro_torch.analysis.rules import Finding, make_finding
from repro_torch.kernels._trace import KernelSite

__all__ = ["check_kernel_site"]


def check_kernel_site(site: KernelSite, target: str, *, pads_to_tiles: bool = False,
                      ) -> list[Finding]:
    out: list[Finding] = []
    label = f"{target} kernel {site.kernel!r}"

    for s_idx, (lo, hi) in enumerate(site.splits):
        if not 0 <= lo < hi <= site.split_total:
            out.append(make_finding(
                "PAL001", target,
                f"{label}: split {s_idx} covers tiles [{lo}, {hi}) of "
                f"[0, {site.split_total}) — "
                f"{'empty' if lo >= hi else 'outside the tile grid'}"))

    corners = sorted(set(itertools.product(*[(0, g - 1) for g in site.grid])))
    for blk in site.blocks:
        n_tiles = [max(-(-e // t), 1) for e, t in zip(blk.extent, blk.tile)]
        if blk.divisible or pads_to_tiles:
            for d, (e, t) in enumerate(zip(blk.extent, blk.tile)):
                if t and e % t:
                    out.append(make_finding(
                        "PAL002", target,
                        f"{label}: operand {blk.operand!r} tile {blk.tile} dim {d} ({t}) "
                        f"does not divide its extent {blk.extent} — the kernel takes "
                        f"whole tiles only"))
        if blk.index_map is None or not site.grid:
            continue
        for point in corners:
            idx = blk.index_map(*point)
            for d, i in enumerate(idx):
                if not 0 <= i < n_tiles[d]:
                    out.append(make_finding(
                        "PAL001", target,
                        f"{label}: operand {blk.operand!r} tile index {i} for dim {d} "
                        f"at grid point {point}, outside [0, {n_tiles[d] - 1}] "
                        f"(extent {blk.extent}, tile {blk.tile})"))

    for what, dt in (("accumulator", site.acc_dtype), ("split-K workspace",
                                                       site.workspace_dtype)):
        bits = float_bits(dt)
        if bits is not None and bits < 32:
            out.append(make_finding(
                "PAL003", target,
                f"{label}: {what} is {dt} — a floating accumulator must be f32 "
                f"(the paper's accumulate-in-full-precision invariant)"))
    return out
