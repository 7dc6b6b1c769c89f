"""Logical -> mesh-axis placement rules (DP / FSDP / TP / EP / SP), twin
of ``repro.runtime.sharding``.

Mesh axes: ``data`` (FSDP + batch), ``model`` (TP), ``expert`` (true EP
when the mesh carries one; otherwise EP rides the model axis) and
``pod`` (pure DP across pods; params are not sharded across pods).

A placement is ``repro``'s ``PartitionSpec`` as a tuple: one entry per
tensor dim, the mesh axis it is split over, a tuple of axes, or None
(replicated).  ``placements()`` turns one into DTensor placements.
Every rule is divisibility-guarded (an axis shards only when its size
divides into the mesh axis) and, given the run's ``ExecutionPolicy``,
capability-gated: a dim shards over ``model`` / ``expert`` only when the
routed impl of the family that consumes it declares the role in its
``Partitioning`` (``shardable``).

The port's params keep each layer in a flat list (``convert.py``), where
``repro`` stacks a segment's layers on a leading ``count`` dim: a flat
layer leaf's placement is ``repro``'s placement of the stacked leaf with
that dim dropped, and so for the per-layer caches.

The train launcher stores each param and optimizer leaf as this rank's
block of its placement (``local_block``) and reassembles the whole leaf
for a step (``gather``): FSDP's storage over ``data``, TP's over
``model``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops.shard import MeshSpec
from repro_torch.core.tree import leaves_with_paths, tree_map

__all__ = ["Sharder", "MeshLayout", "placements", "local_block", "block_index", "gather",
           "rank_coords"]

Spec = tuple


@functools.lru_cache(maxsize=None)
def _estimate_param_bytes(cfg: ModelConfig) -> int:
    """f32 parameter bytes without allocation (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.tree import leaves
    from repro_torch.models import api
    with FakeTensorMode():
        tree = api.init_params(cfg, torch.Generator(), "cpu")
    return int(sum(p.numel() * 4 for p in leaves(tree)))


_STACKED = ("layers", "enc_layers")


class Sharder:
    """Placements for the params / batch / cache of one run.

    ``mode``: "train" applies FSDP (ZeRO-3) to weight input dims; "serve"
    replicates weights over the data axis when the TP-sharded copy fits
    ``SERVE_REPLICATE_BUDGET`` a rank (one token a sequence cannot
    amortize a per-layer FSDP gather).  ``mesh`` is a ``MeshSpec``, or any
    object with ``repro``'s ``shape`` mapping and ``axis_names``.
    """

    SERVE_REPLICATE_BUDGET = 8 * 2 ** 30

    def __init__(self, cfg: ModelConfig, mesh, mode: str = "train",
                 param_bytes: int | None = None, policy=None):
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.policy = policy
        if isinstance(mesh, MeshSpec):
            shape, names = dict(mesh.axis_items()), tuple(a for a, _ in mesh.axis_items())
        else:
            shape, names = dict(mesh.shape), tuple(mesh.axis_names)
        self.axis_sizes = shape
        self.axis_names = names
        self.d_model = shape.get("model", 1)
        self.d_data = shape.get("data", 1)
        self.d_expert = shape.get("expert", 1)
        self.d_pod = shape.get("pod", 1)
        self.dp_axes: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
        self.dp_size = self.d_pod * self.d_data
        self.fsdp = True
        if mode == "serve":
            pb = param_bytes if param_bytes is not None else _estimate_param_bytes(cfg)
            self.fsdp = pb / self.d_model > self.SERVE_REPLICATE_BUDGET

    # ------------------------------------------------------------ helpers

    def _m(self, dim: int) -> str | None:
        return "model" if dim % self.d_model == 0 else None

    def shardable(self, family: str, role: str, layer: str | None = None) -> bool:
        """Does the policy's routed impl for ``family`` (optionally
        layer-scoped) declare ``role`` in its Partitioning?  True with no
        policy: the divisibility-only rules."""
        if self.policy is None:
            return True
        from repro_torch.core.ops import registry
        caps = registry.get_impl(family, self.policy.impl_for(family, layer)).capabilities
        return caps.partitioning is not None and role in caps.partitioning.roles

    def _tp(self, dim: int, family: str = "gemm", layer: str | None = None) -> str | None:
        return self._m(dim) if self.shardable(family, "tp", layer) else None

    def _e(self, e: int) -> str | None:
        if not self.shardable("grouped", "ep"):
            return None
        if self.d_expert > 1:
            return "expert" if e % self.d_expert == 0 else None
        return self._m(e)

    def _f(self, dim: int) -> str | None:
        if not self.fsdp:
            return None
        return "data" if dim % self.d_data == 0 else None

    def _dp(self, batch: int):
        if batch % self.dp_size == 0:
            return self.dp_axes if len(self.dp_axes) > 1 else "data"
        if batch % self.d_data == 0:
            return "data"
        return None

    # ------------------------------------------------------------- params

    def _param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """``repro``'s rule for one (possibly stacked) leaf."""
        cfg = self.cfg
        if path.endswith(("embed/table", "unembed/table")):
            v, _ = shape
            return (self._tp(v, "gemm", "logits"), None)
        if "pos_embed" in path:
            return (None, self._f(shape[-1]))
        if cfg.num_experts and len(shape) == 4:  # (count, E, din, dout)
            _, e, din, dout = shape
            ep = self._e(e)
            if ep == "expert":
                return (None, ep, self._f(din), self._tp(dout, "grouped"))
            if ep is not None:
                return (None, ep, self._f(din), None)
            return (None, None, self._f(din), self._tp(dout, "grouped"))
        if cfg.num_experts and len(shape) == 3 and shape[0] == cfg.num_experts:
            e, din, dout = shape
            ep = self._e(e)
            if ep == "expert":
                return (ep, self._f(din), self._tp(dout, "grouped"))
            if ep is not None:
                return (ep, self._f(din), None)
            return (None, self._f(din), self._tp(dout, "grouped"))
        if path.endswith("/w") and len(shape) >= 2:
            din, dout = shape[-2], shape[-1]
            lead = (None,) * (len(shape) - 2)
            # output-projection style: the CONTRACTING dim takes 'model'
            if any(t in path for t in ("wo/", "out_proj", "ffn_v", "/b/")):
                return (*lead, self._tp(din), self._f(dout))
            return (*lead, self._f(din), self._tp(dout))
        return (None,) * len(shape)

    def param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """The placement of one port param leaf: a flat layer's is the
        stacked leaf's with the ``count`` dim dropped."""
        if path.split("/", 1)[0] in _STACKED:
            return self._param_spec(path, (1, *shape))[1:]
        return self._param_spec(path, tuple(shape))

    def param_specs(self, params: Any) -> Any:
        it = iter([self.param_spec(p, tuple(x.shape)) for p, x in leaves_with_paths(params)])
        return tree_map(lambda _: next(it), params)

    # -------------------------------------------------------------- batch

    def batch_specs(self, batch: dict[str, Any]) -> dict[str, Spec]:
        out = {}
        for name, leaf in batch.items():
            shape = tuple(leaf.shape)
            if not shape:
                out[name] = ()
            elif name == "pos":
                out[name] = (self._dp(shape[0]),)
            else:
                dp = self._dp(shape[0])
                if dp is None and len(shape) >= 2 and shape[1] % self.d_data == 0:
                    out[name] = (None, "data", *(None,) * (len(shape) - 2))
                else:
                    out[name] = (dp, *(None,) * (len(shape) - 1))
        return out

    # -------------------------------------------------------------- cache

    def _cache_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """``repro``'s rule for one stacked cache leaf."""
        if ("wkv" in path or "ssd" in path) and len(shape) == 5:
            _, b, h, _, _ = shape
            return (None, self._dp(b), self._m(h), None, None)
        if len(shape) == 5:
            _, b, s, kv, _ = shape
            kv_ax = self._tp(kv, "attention")
            dp = self._dp(b)
            if dp is None:
                return (None, None, "data" if s % self.d_data == 0 else None, kv_ax, None)
            return (None, dp, None, kv_ax, None)
        if len(shape) == 4:
            _, b, _, c = shape
            return (None, self._dp(b), None, self._m(c))
        if len(shape) == 3:
            _, b, _ = shape
            return (None, self._dp(b), None)
        return (None,) * len(shape)

    def cache_specs(self, cache: Any) -> Any:
        """Placements of a port decode cache (one entry a layer: each leaf
        is one layer's slice of ``repro``'s stacked leaf)."""
        it = iter([None if x is None else self._cache_spec(p, (1, *x.shape))[1:]
                   for p, x in leaves_with_paths(cache)])
        return tree_map(lambda _: next(it), cache)

    # ---------------------------------------------------------- optimizer

    def opt_specs(self, param_specs: Any) -> Any:
        """AdamW's moments mirror the param placements."""
        return param_specs


# ================================================================ blocks

def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh: MeshSpec) -> list:
    """DTensor placements of ``spec`` over ``mesh.build()``'s dims."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis, _ in mesh.axis_items():
        dims = [d for d, e in enumerate(spec) if axis in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def block_index(spec: Spec, shape: tuple[int, ...], mesh: MeshSpec,
                coords: dict[str, int]) -> tuple[tuple[int, int], ...]:
    """The (start, stop) per dim of the block that the rank at ``coords``
    (axis -> coordinate) holds."""
    sizes = dict(mesh.axis_items())
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        start, size = 0, n
        for axis in _axes_of(entry):
            size //= sizes[axis]
            start += coords[axis] * size
        index.append((start, start + size))
    return tuple(index)


def local_block(x: torch.Tensor, spec: Spec, mesh: MeshSpec,
                coords: dict[str, int]) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` (a contiguous copy)."""
    out = x
    for d, (start, stop) in enumerate(block_index(spec, tuple(x.shape), mesh, coords)):
        if stop - start != x.shape[d]:
            out = out.narrow(d, start, stop - start)
    return out.contiguous()


def gather(block: torch.Tensor, spec: Spec, mesh: MeshSpec, dm) -> torch.Tensor:
    """The whole leaf from the ranks' blocks (``dm``: the built
    ``DeviceMesh``); the inverse of ``local_block``."""
    import torch.distributed as dist
    from repro_torch.core.ops import shard
    out = block
    for d in range(len(spec) - 1, -1, -1):
        for axis in reversed(_axes_of(spec[d])):
            n = dict(mesh.axis_items())[axis]
            if n == 1:
                continue
            parts = [torch.empty_like(out) for _ in range(n)]
            src = out.contiguous()
            shard._timed(lambda: dist.all_gather(parts, src, group=dm.get_group(axis)), src)
            out = torch.cat(parts, d)
    return out


def rank_coords(mesh: MeshSpec, rank: int) -> dict[str, int]:
    """Axis -> coordinate of ``rank`` (ranks fill the mesh row-major, as
    ``MeshSpec.build()`` lays them out)."""
    coords = {}
    for axis, n in reversed(mesh.axis_items()):
        coords[axis] = rank % n
        rank //= n
    return coords


class MeshLayout:
    """Which block of each leaf of a tree every rank holds: the
    checkpoint manager's view of a sharded tree (``specs``: the leaves'
    placements in walk order, ``shapes``: their whole shapes)."""

    def __init__(self, specs: list, shapes: list, mesh: MeshSpec, rank: int):
        self.specs, self.shapes, self.mesh = specs, [tuple(s) for s in shapes], mesh
        self.rank, self.world = rank, mesh.size
        self._coords = [rank_coords(mesh, r) for r in range(mesh.size)]

    def shape(self, i: int) -> tuple[int, ...]:
        return self.shapes[i]

    def index(self, i: int, rank: int) -> tuple[tuple[int, int], ...]:
        return block_index(self.specs[i], self.shapes[i], self.mesh, self._coords[rank])

    def writes(self, i: int, rank: int) -> bool:
        """The lowest rank holding a block writes it."""
        mine = self.index(i, rank)
        return all(self.index(i, r) != mine for r in range(rank))

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()
