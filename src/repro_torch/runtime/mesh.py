"""One mesh surface: elastic shape choice, CLI resolution, resharding
(twin of ``repro.runtime.mesh``).

Everything mesh-shaped is expressed through ``core.ops.shard.MeshSpec``,
so the launchers, the sharded ops and the ``Sharder``'s placements agree
on one mesh (axis names and rank order included).

Elastic posture: checkpoints store each shard's GLOBAL index
(``checkpoint/manager.py``), so a restart restores straight onto the new
mesh's placements.  ``resharder_for`` picks the new mesh from the
surviving rank count and, handed the run's ``ExecutionPolicy``,
re-resolves the route under the new degrees, so a rescale re-runs the
same capability validation as a launch.

``choose_mesh_shape`` is config-aware: with the ``ModelConfig`` the model
axis is capped at the largest degree that divides every TP/EP-sharded
dimension.  ``repro``'s production and test mesh constructors build JAX
meshes over a pod's devices; the port's ranks are processes, so
``make_test_mesh`` returns the ``MeshSpec`` a test world of that shape
builds.
"""

from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.ops.shard import MeshSpec

__all__ = [
    "MeshSpec",
    "choose_mesh_shape",
    "make_test_mesh",
    "max_parallel_degree",
    "mesh_spec_for",
    "replica_mesh_spec",
    "resharder_for",
    "resolve_mesh_flag",
    "resolve_mesh_spec",
]


def make_test_mesh(data: int = 2, model: int = 2, expert: int = 1) -> MeshSpec:
    """The MeshSpec of a small test world: (data, expert, model) degrees."""
    return MeshSpec(dp=data, tp=model, ep=expert)


# --------------------------------------------------------- elastic shapes

def max_parallel_degree(cfg, limit: int) -> int:
    """Largest model-axis degree <= limit that every TP/EP-sharded dim of
    ``cfg`` divides into: the FFN width (TP), the expert count (EP) and
    the KV-head count (attention TP).  Dims the arch lacks (0) impose no
    constraint."""
    dims = [d for d in (cfg.d_ff, cfg.num_experts, cfg.num_kv_heads or cfg.num_heads) if d]
    for deg in range(limit, 0, -1):
        if all(d % deg == 0 for d in dims):
            return deg
    return 1


def choose_mesh_shape(n_devices: int, cfg=None, model_parallel: int = 16,
                      pod_size: int = 256) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest supported mesh for the surviving device count; with a
    ``ModelConfig`` the model axis is capped at ``max_parallel_degree``."""
    if cfg is not None:
        model_parallel = min(model_parallel, max_parallel_degree(cfg, model_parallel))
    if n_devices >= 2 * pod_size and n_devices % pod_size == 0:
        pods = n_devices // pod_size
        return ((pods, pod_size // model_parallel, model_parallel), ("pod", "data", "model"))
    model_parallel = min(model_parallel, n_devices)
    while n_devices % model_parallel:
        model_parallel //= 2
    return ((n_devices // model_parallel, model_parallel), ("data", "model"))


def mesh_spec_for(n_devices: int, cfg=None) -> MeshSpec:
    """The MeshSpec ``--mesh auto`` resolves to for this device count."""
    return MeshSpec.from_shape(*choose_mesh_shape(n_devices, cfg))


def replica_mesh_spec(n_devices: int, n_active: int, cfg=None) -> MeshSpec:
    """Per-replica MeshSpec when ``n_devices`` are split evenly across
    ``n_active`` serving replicas: the one mesh surface of the pool's
    scale and replace actions (``serve.autoscale``)."""
    return mesh_spec_for(max(1, n_devices // max(n_active, 1)), cfg)


# ------------------------------------------------------------ CLI surface

def resolve_mesh_flag(mesh_arg: str | None, use_mesh: bool = False) -> str | None:
    """Merge ``--mesh`` with the deprecated ``--use-mesh`` boolean (an
    alias for ``--mesh auto``)."""
    if use_mesh:
        warnings.warn("--use-mesh is deprecated; use --mesh auto",
                      DeprecationWarning, stacklevel=2)
        if mesh_arg is None:
            mesh_arg = "auto"
    return mesh_arg


def resolve_mesh_spec(mesh_arg: str | None, cfg=None,
                      n_devices: int | None = None) -> MeshSpec | None:
    """``--mesh`` value -> MeshSpec: ``auto`` fits ``n_devices`` (the
    ranks the run has; config-aware), the ``dp=2,tp=2,ep=2`` grammar is
    explicit, None stays None (one device)."""
    if mesh_arg is None:
        return None
    if mesh_arg.strip().lower() == "auto":
        if n_devices is None:
            raise ValueError("--mesh auto needs the rank count it fits")
        return mesh_spec_for(n_devices, cfg)
    return MeshSpec.parse(mesh_arg)


# ---------------------------------------------------------------- elastic

def resharder_for(cfg, n_ranks: int, *, policy=None, mode: str = "train"):
    """MeshSpec + Sharder (+ re-routed policy) for the surviving ranks.

    Without ``policy``: ``(spec, sharder)``.  With the run's
    ``ExecutionPolicy``: ``(spec, sharder, policy)``, the policy's ``mesh``
    replaced by the newly chosen spec, which re-runs capability validation
    (``Partitioning`` included)."""
    from repro_torch.runtime.sharding import Sharder
    spec = mesh_spec_for(n_ranks, cfg)
    if policy is None:
        return spec, Sharder(cfg, spec, mode=mode)
    policy = dataclasses.replace(policy, mesh=spec)
    return spec, Sharder(cfg, spec, mode=mode, policy=policy), policy
