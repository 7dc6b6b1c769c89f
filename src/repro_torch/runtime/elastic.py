"""Elastic mesh selection (twin of ``repro.runtime.elastic``): a thin
alias of ``runtime.mesh``, where the config-aware ``choose_mesh_shape``
and the policy-re-routing ``resharder_for`` live."""

from __future__ import annotations

from repro_torch.runtime.mesh import (  # noqa: F401
    choose_mesh_shape,
    max_parallel_degree,
    mesh_spec_for,
    resharder_for,
)

__all__ = ["choose_mesh_shape", "max_parallel_degree", "mesh_spec_for", "resharder_for"]
