"""Kernel launches made visible to the static auditor's trace.

The auditor (``repro_torch.analysis``) traces a routed op with ``make_fx``
over fake tensors: no kernel may run and no library may load.  While
``tracing()`` is active (``ACTIVE``), each kernel entry point returns
``launch(site, *inputs)`` instead of reaching its C launcher: one graph
node ``repro_torch_trace::kernel(Tensor[] inputs, int site)`` per launch,
whose fake implementation returns outputs of the launch's shapes and
dtypes on the inputs' device.  The node's ``site`` indexes the trace's
``KernelSite`` list, the twin of ``repro``'s ``PallasSite``: the C entry
point and its mainloop, the grid and operand tiles the wrapper computes,
the split ranges it hands the launcher, the accumulator and workspace
dtypes and the tensor-core passes it fuses.  The entry points build the
site only inside a trace, so an eager launch pays one test of ``ACTIVE``
and nothing else: no dispatcher hop, no custom op.

``plain_twin`` marks the plain PyTorch version of a kernel: reached
inside a trace it records its name (``TraceState.plain``), the auditor's
PAL004 evidence that a ``cuda*`` route ran the plain version where the
card would launch the kernel.  The op is defined the first time a trace
starts, never at import.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections.abc import Callable, Iterator

import torch

__all__ = ["ACTIVE", "AUDIT_SMS", "Block", "KernelSite", "TraceState", "tracing", "launch",
           "plain_twin", "is_kernel_node", "OP_NAME"]

ACTIVE = False
# Split choosers read the card's SM count; a trace must not query a card,
# so it takes the H100 SXM's 132.
AUDIT_SMS = 132
OP_NAME = "repro_torch_trace::kernel"


@dataclasses.dataclass(frozen=True)
class Block:
    """One operand's tiling as the launch walks it: ``extent`` cut into
    ``tile``-sized tiles, ``index_map(grid point) -> tile index`` the tile
    the CTA at that grid point starts from (None: the launcher computes
    it).  ``divisible``: the kernel takes only whole tiles."""

    operand: str
    extent: tuple[int, ...]
    tile: tuple[int, ...]
    index_map: Callable[..., tuple[int, ...]] | None = None
    divisible: bool = False


@dataclasses.dataclass(frozen=True)
class KernelSite:
    """One kernel launch as the wrapper would hand it to its launcher."""

    kernel: str                      # the entry point (its ``LAUNCHES`` key)
    entry: str                       # the C launcher
    mainloop: str | None             # the ``MAINLOOPS`` id the launcher runs, if it has several
    policy: str
    terms: int                       # tensor-core passes the launch fuses
    contractions: int                # contraction sites a pass
    outputs: tuple[tuple[tuple[int, ...], torch.dtype], ...]
    acc_dtype: torch.dtype = torch.float32
    workspace_dtype: torch.dtype | None = None   # split-K partials, when split
    grid: tuple[int, ...] = ()       # the grid the wrapper computes (empty: the launcher's)
    blocks: tuple[Block, ...] = ()
    split_total: int = 0             # tiles the split ranges cover
    splits: tuple[tuple[int, int], ...] = ()

    @property
    def dots(self) -> int:
        """Contractions inside the kernel, as ``repro`` counts the dots
        inside a ``pallas_call``."""
        return self.terms * self.contractions


@dataclasses.dataclass
class TraceState:
    sites: list[KernelSite] = dataclasses.field(default_factory=list)
    plain: list[str] = dataclasses.field(default_factory=list)


_STATE: TraceState | None = None
_LIB = None


def _define() -> None:
    global _LIB
    if _LIB is not None:
        return
    lib = torch.library.Library("repro_torch_trace", "DEF")
    lib.define("kernel(Tensor[] inputs, int site) -> Tensor[]")

    def fake(inputs, site):
        dev = inputs[0].device if inputs else torch.device("cpu")
        return [torch.empty(shape, dtype=dtype, device=dev)
                for shape, dtype in _STATE.sites[site].outputs]

    torch.library.register_fake(OP_NAME, fake, lib=lib)
    _LIB = lib


@contextlib.contextmanager
def tracing() -> Iterator[TraceState]:
    """Route every kernel entry point to ``launch`` for the duration."""
    global ACTIVE, _STATE
    _define()
    prev = ACTIVE, _STATE
    ACTIVE, _STATE = True, TraceState()
    try:
        yield _STATE
    finally:
        ACTIVE, _STATE = prev


def launch(site: KernelSite, *inputs):
    """The traced launch: one ``repro_torch_trace::kernel`` node; returns
    the site's outputs (a tensor, or a tuple of them)."""
    idx = len(_STATE.sites)
    _STATE.sites.append(site)
    tensors = [x for x in inputs if isinstance(x, torch.Tensor)]
    outs = torch.ops.repro_torch_trace.kernel(tensors, idx)
    return outs[0] if len(outs) == 1 else tuple(outs)


def is_kernel_node(node) -> bool:
    return (_LIB is not None and node.op == "call_function"
            and node.target is torch.ops.repro_torch_trace.kernel.default)


def plain_twin(fn):
    """Mark ``fn`` as a kernel's plain version (see the module docstring)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if ACTIVE:
            _STATE.plain.append(fn.__name__)
        return fn(*args, **kwargs)
    return wrapper
