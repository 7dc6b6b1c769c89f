"""Capability-aware routing (twin of ``repro.core.ops.route``).

``Route`` is what one contraction carries at dispatch time: a precision
rung plus a (family -> impl) mapping.  ``ExecutionPolicy`` extends
``PrecisionPolicy`` with that mapping and validates every selected impl
against its declared capabilities at construction: an impl lacking a
rung it would run, or a feature listed in ``require``, fails with the
missing capability named (or, with ``fallback=True``, resolves to the
family's reference impl).  A non-identity ``mesh`` (a ``MeshSpec``)
distributes every routed op over the ranks (``core.ops.shard``) and
demands a ``Partitioning`` of every resolved impl, exactly like a rung or
a feature; ``fallback`` resolves an unshardable impl to the reference.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping

from repro_torch.core.ops import registry
from repro_torch.core.ops.shard import MeshSpec, active_mesh
from repro_torch.core.precision import PrecisionPolicy

__all__ = [
    "Route",
    "ExecutionPolicy",
    "as_route",
    "normalize_backends",
    "validate_backends",
    "parse_backend_flags",
]


def normalize_backends(backends) -> tuple[tuple[str, str], ...]:
    """Mapping or pair-tuple -> canonical sorted pair-tuple."""
    items = backends.items() if isinstance(backends, Mapping) else tuple(backends)
    return tuple(sorted((str(k), str(v)) for k, v in items))


LAYER_FAMILIES = tuple(f for f in PrecisionPolicy._PRECISION_FIELDS
                       if f != "default")


@dataclasses.dataclass(frozen=True)
class Route:
    """Everything one contraction needs: precision x impls x mesh."""

    precision: str = "bf16"
    backends: tuple[tuple[str, str], ...] = ()
    mesh: MeshSpec | None = None

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "backends", normalize_backends(self.backends))

    def impl(self, family: str) -> str:
        """The impl this route selects for ``family`` (reference when
        unmapped)."""
        for fam, name in self.backends:
            if fam == family:
                return name
        return registry.reference_impl(family)

    def uses_reference(self, family: str) -> bool:
        return self.impl(family) == registry.reference_impl(family)

    def with_impl(self, family: str, name: str) -> Route:
        d = dict(self.backends)
        d[family] = name
        return dataclasses.replace(self, backends=normalize_backends(d))


def as_route(policy: str | Route) -> Route:
    """Normalize a policy argument: strings mean (rung, all-reference)."""
    if isinstance(policy, Route):
        return policy
    return Route(precision=policy)


def validate_backends(backends, *, rungs_for=None,
                      require: Mapping[str, tuple[str, ...]] | None = None,
                      fallback: bool = False,
                      mesh: MeshSpec | None = None) -> tuple[tuple[str, str], ...]:
    """Check a backends mapping against the registry's capabilities.

    ``rungs_for(op_family, scoped_layer)`` returns the rungs the impl
    will run; ``require`` maps families to feature tags that must be
    present (families absent from the mapping are checked through their
    reference impl).  A non-identity ``mesh`` demands a ``Partitioning``
    of every resolved impl (every family's ops run under the mesh, so
    families absent from the mapping are checked through their reference
    impl).  A miss raises ``ValueError`` naming the missing
    capability, or with ``fallback`` resolves to the reference impl.
    """
    require = dict(require or {})
    mesh = active_mesh(mesh)

    def check(fam, name, scoped, *, allow_fallback):
        spec = registry.get_family(fam)
        caps = registry.get_impl(fam, name).capabilities
        rungs = tuple(rungs_for(fam, scoped or None)) if rungs_for else ()
        missing = [f"precision-policy rung {r!r}" for r in sorted(rungs)
                   if not caps.supports_policy(r)]
        missing += [f"capability {feat!r}" for feat in require.get(fam, ())
                    if not caps.has(feat)]
        if mesh is not None and caps.partitioning is None:
            missing += [f"capability 'partitioning' (mesh {mesh.describe()})"]
        if not missing:
            return name
        if allow_fallback and name != spec.reference:
            warnings.warn(
                f"{fam} impl {name!r} lacks {', '.join(missing)}; "
                f"falling back to the reference impl "
                f"{spec.reference!r}", RuntimeWarning, stacklevel=3)
            return spec.reference
        raise ValueError(
            f"{fam} impl {name!r} does not support "
            f"{', '.join(missing)} (policies: {sorted(caps.policies)}, "
            f"features: {sorted(caps.features)}); pick a capable impl "
            f"or allow fallback to the reference impl "
            f"{spec.reference!r}")

    out = []
    unscoped = set()
    for key, name in normalize_backends(backends):
        fam, _, scoped = key.partition("@")
        if scoped and scoped not in LAYER_FAMILIES:
            raise ValueError(
                f"unknown layer-family scope {scoped!r} in backends key "
                f"{key!r}; valid scopes: {LAYER_FAMILIES}")
        out.append((key, check(fam, name, scoped, allow_fallback=fallback)))
        if not scoped:
            unscoped.add(fam)
    implied = set(require)
    if mesh is not None:
        implied |= set(registry.families())
    for fam in sorted(implied - unscoped):
        check(fam, registry.reference_impl(fam), None, allow_fallback=False)
    return tuple(sorted(out))


def _normalize_require(require) -> tuple[tuple[str, tuple[str, ...]], ...]:
    items = require.items() if isinstance(require, Mapping) else tuple(require)
    return tuple(sorted((str(k), tuple(v)) for k, v in items))


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy(PrecisionPolicy):
    """Per-layer-family precision + the validated backends mapping.

    ``for_(layer_family)`` returns the ``Route`` the models hand to
    ``peinsum`` and the family dispatchers.  ``mesh`` (a ``MeshSpec``)
    distributes every routed op over the ranks; a non-identity mesh is
    validated against each impl's ``Partitioning`` here.
    """

    backends: tuple[tuple[str, str], ...] = ()
    fallback: bool = False
    require: tuple[tuple[str, tuple[str, ...]], ...] = ()
    mesh: MeshSpec | None = None

    def __post_init__(self) -> None:
        super().__post_init__()
        object.__setattr__(self, "require", _normalize_require(self.require))
        object.__setattr__(self, "backends", validate_backends(
            self.backends, rungs_for=self._rungs_for,
            require=dict(self.require), fallback=self.fallback, mesh=self.mesh))

    def _rungs_for(self, op_family: str, scoped: str | None):
        """The rungs impl selection ``op_family`` will execute."""
        if scoped is not None:
            return {PrecisionPolicy.for_(self, scoped)}
        spec = registry.get_family(op_family)
        if spec.layer_families:
            return {PrecisionPolicy.for_(self, lf)
                    for lf in spec.layer_families}
        return {getattr(self, f) or self.default
                for f in self._PRECISION_FIELDS}

    def impl_for(self, op_family: str, layer_family: str | None = None) -> str:
        """The impl ``op_family`` runs (for ``layer_family``, when a
        layer-scoped key names one)."""
        d = dict(self.backends)
        if layer_family is not None and f"{op_family}@{layer_family}" in d:
            return d[f"{op_family}@{layer_family}"]
        return d.get(op_family, registry.reference_impl(op_family))

    def route(self, layer_family: str) -> Route:
        chosen = {fam: name for fam, name in self.backends if "@" not in fam}
        for key, name in self.backends:
            fam, _, scoped = key.partition("@")
            if scoped == layer_family:
                chosen[fam] = name
        return Route(precision=PrecisionPolicy.for_(self, layer_family),
                     backends=chosen, mesh=self.mesh)

    def for_(self, layer_family: str) -> Route:  # type: ignore[override]
        return self.route(layer_family)


def parse_backend_flags(specs) -> dict[str, str]:
    """Parse repeatable ``--backend FAMILY=IMPL`` flags into a backends
    mapping, validating names against the registry."""
    backends: dict[str, str] = {}
    for spec in specs or ():
        fam, sep, name = spec.partition("=")
        if not sep:
            raise ValueError(
                f"--backend {spec!r}: expected FAMILY=IMPL "
                f"(families: {registry.families()})")
        registry.get_impl(fam.partition("@")[0], name)
        backends[fam] = name
    return backends
