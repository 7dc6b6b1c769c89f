"""aten-graph walking for the static auditor (twin of
``repro.analysis.jaxpr_scan``).

``make_fx`` over fake tensors gives the full structural graph of a routed
op -- every aten contraction, every kernel launch -- without running
anything: a fake tensor has shapes, strides, dtypes and a device, and no
storage.  Fake CUDA tensors exist without a card, so the ``cuda`` impls
trace on a CPU-only build; their kernel entry points, seeing
``kernels._trace.ACTIVE``, emit one ``repro_torch_trace::kernel`` node a
launch (its ``KernelSite``) and never reach a library.  ``make_fx``
flattens every Python call, ``autograd.Function`` and loop into one
graph, so there is no sub-graph to recurse into: a contraction in a loop
body appears once per iteration, the ladder's passes once each.

A CPU-only build of PyTorch makes fake CUDA tensors but cannot index or
differentiate them: tensor indexing takes a CUDA device guard and the
autograd engine a CUDA stream, and a build without CUDA has neither (the
autograd engine aborts the process).  So there a ``cuda`` audit traces on
fake CPU tensors with the kernel hooks on: every entry point tests
``ACTIVE`` before it looks at a device, so the graph and its kernel sites
are those of the card; only the tensors' device differs.  A CUDA build
(the H100 host) traces on fake CUDA tensors.

Counting convention: a kernel site counts its fused passes times its
contraction sites as contractions inside a kernel, as ``repro`` counts the
``dot_general`` eqns inside a ``pallas_call``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _trace

__all__ = ["ContractionSite", "ScanResult", "GraphTrace", "CONTRACTION_OPS", "trace_graph",
           "scan_graph", "float_bits"]

_aten = torch.ops.aten
# aten contractions: (op packet, index of the two operands)
CONTRACTION_OPS = {
    _aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.matmul: (0, 1), _aten.dot: (0, 1),
    _aten.vdot: (0, 1), _aten.mv: (0, 1), _aten.addmm: (1, 2), _aten.baddbmm: (1, 2),
    _aten.addbmm: (1, 2), _aten.addmv: (1, 2), _aten._scaled_mm: (0, 1), _aten._int_mm: (0, 1),
    _aten.tensordot: (0, 1),
}
_CASTS = (_aten._to_copy, _aten.to, torch.ops.prims.convert_element_type)
_ACCUMULATES = (_aten.add, _aten.add_, _aten.sub, _aten.sub_)
# ops that keep a contraction's values (a view or a copy of them)
_VIEWS = (_aten.view, _aten._unsafe_view, _aten.reshape, _aten.permute, _aten.transpose,
          _aten.t, _aten.expand, _aten.squeeze, _aten.unsqueeze, _aten.clone,
          _aten.contiguous, _aten.alias, _aten.slice, _aten.select)


@dataclasses.dataclass(frozen=True)
class ContractionSite:
    """One aten contraction outside any kernel."""

    op: str
    lhs_dtype: torch.dtype
    rhs_dtype: torch.dtype
    out_dtype: torch.dtype


@dataclasses.dataclass
class ScanResult:
    """Everything one trace yields for the rule engine."""

    contractions: list[ContractionSite]
    kernels: list[_trace.KernelSite]
    # (src_dtype, dst_dtype) for each contraction output converted to a
    # narrower float and then fed into an add or sub
    downcasts: list[tuple[torch.dtype, torch.dtype]]
    plain: list[str]                 # plain versions reached inside the trace

    @property
    def outer_dots(self) -> int:
        return len(self.contractions)

    @property
    def dots(self) -> int:
        """Contractions outside plus inside kernels (``repro``'s
        ``len(scan.dots)``)."""
        return self.outer_dots + sum(s.dots for s in self.kernels)

    @property
    def kernel_calls(self) -> int:
        return len(self.kernels)


@dataclasses.dataclass
class GraphTrace:
    gm: torch.fx.GraphModule
    state: _trace.TraceState | None  # None: traced with the kernel hooks off
    device: str


def float_bits(dtype) -> int | None:
    if isinstance(dtype, torch.dtype) and dtype.is_floating_point:
        return torch.finfo(dtype).bits
    return None


def _leaf(mode, x, device: str, grad: bool):
    if not isinstance(x, torch.Tensor):
        return x
    if mode is None:
        t = x.detach().clone()
    else:
        with mode:
            t = torch.empty_strided(tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
                                    device=device)
    return t.requires_grad_() if grad and t.is_floating_point() else t


def trace_graph(fn, *args, device: str = "cuda", grad_args: tuple[int, ...] = ()
                ) -> GraphTrace:
    """``make_fx(fn)(*args)``: the auditor's only tracing entry (nothing it
    reaches runs a kernel or allocates device memory).  ``args`` may hold
    tensors anywhere in dicts, lists or tuples.  For ``device="cuda"`` each
    becomes a fake tensor of its shape, strides and dtype (see the module
    docstring for a CPU-only build); for ``device="cpu"`` a copy of it, so
    the routes the CPU runs, which read data (the grouped plain version
    reads its offsets to the host), trace on the problem's own values.
    The floating tensors of ``grad_args`` (positions in ``args``) are made
    to require grad.  The kernel hooks are on for ``cuda``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    kernels = device == "cuda"
    mode = None if device == "cpu" else FakeTensorMode()
    if device == "cuda" and not torch.backends.cuda.is_built():
        device = "cpu"                  # fake CPU tensors: see the module docstring
    leaf_args = [pytree.tree_map(lambda x, g=i in grad_args: _leaf(mode, x, device, g), a)
                 for i, a in enumerate(args)]
    flat, spec = pytree.tree_flatten(leaf_args)
    slots = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]

    def run(*tensors):
        leaves = list(flat)
        for i, t in zip(slots, tensors):
            leaves[i] = t
        return fn(*pytree.tree_unflatten(leaves, spec))

    hooks = _trace.tracing() if kernels else contextlib.nullcontext()
    with hooks as state, (mode if mode is not None else contextlib.nullcontext()):
        gm = make_fx(run)(*(flat[i] for i in slots))
    return GraphTrace(gm=gm, state=state, device=device)


def _val_dtype(node) -> Any:
    val = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return val.dtype if isinstance(val, torch.Tensor) else None


def _packet(node):
    return getattr(node.target, "overloadpacket", None)


def scan_graph(trace: GraphTrace) -> ScanResult:
    """Collect every audit-relevant site from a traced graph."""
    sites = trace.state.sites if trace.state is not None else []
    result = ScanResult(contractions=[], kernels=[], downcasts=[],
                        plain=list(trace.state.plain) if trace.state is not None else [])
    from_dot: set = set()                # nodes holding a contraction's values
    narrowed: dict = {}
    for node in trace.gm.graph.nodes:
        if node.op != "call_function":
            continue
        if _trace.is_kernel_node(node):
            result.kernels.append(sites[node.args[1]])
            continue
        pk = _packet(node)
        if pk in CONTRACTION_OPS:
            i, j = CONTRACTION_OPS[pk]
            result.contractions.append(ContractionSite(
                op=str(pk), lhs_dtype=_val_dtype(node.args[i]),
                rhs_dtype=_val_dtype(node.args[j]), out_dtype=_val_dtype(node)))
            from_dot.add(node)
        elif pk in _VIEWS and node.args and node.args[0] in from_dot:
            from_dot.add(node)
        elif pk in _CASTS and node.args and node.args[0] in from_dot:
            src, dst = _val_dtype(node.args[0]), _val_dtype(node)
            sb, db = float_bits(src), float_bits(dst)
            if sb and db and db < sb:
                narrowed[node] = (src, dst)
        elif pk in _ACCUMULATES:
            for a in node.args:
                if isinstance(a, torch.fx.Node) and a in narrowed:
                    result.downcasts.append(narrowed[a])
    return result
