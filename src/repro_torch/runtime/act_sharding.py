"""Activation placement constraints (twin of ``repro.runtime.act_sharding``).

Model code is mesh-agnostic; launchers install a constrainer built from
the ``Sharder`` so that named activations carry explicit placements:
the logits (B: dp, S, V: tp when the routed ``gemm@logits`` impl can
vocab-TP) and the residual stream (B: dp, S, D replicated).  In ``repro``
this pins XLA's partitioner (``with_sharding_constraint``); here
``constrain`` is DTensor's ``redistribute``: a DTensor activation is put
back on the placements the next op supports.  The sharded ops hand back
plain tensors that every rank of their groups holds whole (explicit
SPMD, ``core.ops.shard``), which already satisfy any placement, so a
plain tensor passes through unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Callable

import torch

__all__ = ["constrain", "use_constrainer", "make_constrainer"]

_CONSTRAINER: contextvars.ContextVar[Callable | None] = \
    contextvars.ContextVar("act_constrainer", default=None)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Apply the installed constraint for ``kind`` (no-op when unset)."""
    fn = _CONSTRAINER.get()
    return fn(x, kind) if fn is not None else x


@contextlib.contextmanager
def use_constrainer(fn: Callable):
    tok = _CONSTRAINER.set(fn)
    try:
        yield
    finally:
        _CONSTRAINER.reset(tok)


def make_constrainer(sharder) -> Callable:
    """The standard constrainer of a ``Sharder`` (whose ``mesh`` is a
    ``MeshSpec``); ``fn.spec(x, kind)`` is the placement it pins, as
    ``repro``'s ``PartitionSpec``."""
    dp = sharder.dp_axes if len(sharder.dp_axes) > 1 else (
        sharder.dp_axes[0] if sharder.dp_axes else None)

    def spec(x, kind):
        if kind == "logits" and x.dim() == 3:
            vocab_tp = (x.shape[-1] % sharder.d_model == 0
                        and sharder.shardable("gemm", "tp", "logits"))
            return (dp, None, "model" if vocab_tp else None)
        if kind == "residual" and x.dim() == 3:
            return (dp if x.shape[0] % sharder.dp_size == 0 else None, None, None)
        return None

    def fn(x, kind):
        s = spec(x, kind)
        if s is None or not _is_dtensor(x):
            return x
        from repro_torch.runtime.sharding import placements
        return x.redistribute(x.device_mesh, placements(s, sharder.mesh))

    fn.spec = spec
    return fn


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
