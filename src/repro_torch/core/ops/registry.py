"""The op registry (twin of ``repro.core.ops.registry``).

An ``OpSpec`` declares a kernel family (its contract, reference impl
and parity hooks); a ``KernelImpl`` is one registered implementation
with declarative ``Capabilities``; ``register_impl`` is the one
decorator every impl registers through, and routing
(``core.ops.route``) validates requested impls against their
capabilities at route-build time.  The audit hooks (``grad_args``,
``audit_contractions``, ``audit_runs``) drive the static auditor
(``repro_torch.analysis``); ``capability_rows`` / ``capability_markdown``
give the family x impl table with its ``shardable`` and ``audited``
columns.  ``Partitioning`` declares how an impl shards under a device
mesh (``core.ops.shard``); ``OpSpec.audit_meshes`` names the meshes the
auditor traces it on.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable
from typing import Any

from repro_torch.core.precision import POLICIES

__all__ = [
    "Capabilities",
    "Partitioning",
    "OpSpec",
    "KernelImpl",
    "register_family",
    "register_impl",
    "get_family",
    "get_impl",
    "families",
    "available_impls",
    "reference_impl",
    "capability_rows",
    "capability_markdown",
    "LADDER_BOUNDS",
]

ALL_POLICIES = frozenset(POLICIES)

# Max-abs-error ladder vs a fp64 oracle for U[-1,1] operands with
# K ~ O(100) (the paper's Fig. 8 rungs, with slack for summation order).
LADDER_BOUNDS = {
    "fp8": 2e0,
    "int8": 8e-1,
    "fp8x3": 8e-2,
    "int8x3": 8e-3,
    "bf16": 2e-1,
    "refine_a": 1e-1,
    "bf16x3": 1e-3,
    "refine_ab": 1e-3,
    "bf16x6": 1e-4,
    "f32": 1e-4,
}


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """How one impl shards under a device mesh (``core.ops.shard``).

    ``specs`` maps each contract operand (plus ``out``) to a per-dim
    template of mesh ROLES -- ``dp`` (batch/data), ``tp`` (tensor
    parallel), ``ep`` (expert parallel), ``sp`` (sequence parallel) -- or
    None (replicated): the impl's canonical scheme, which the shard
    builder binds to mesh axes at dispatch time with divisibility guards
    (it may pick a role-compatible alternative, e.g. row-parallel GEMM
    when only k divides).  ``collectives`` names the reductions the
    sharded body applies (``psum_f32:tp``: f32 partial-sum epilogue over
    the tp axis; ``all_gather_kv:sp``: the KV gather of the sequence
    walk).  ``roles`` (derived) is what route-build validation checks.
    """

    specs: tuple[tuple[str, tuple[str | None, ...]], ...] = ()
    collectives: tuple[str, ...] = ()

    @property
    def roles(self) -> frozenset[str]:
        out = {r for _, dims in self.specs for r in dims if r}
        out |= {c.partition(":")[2] for c in self.collectives if ":" in c}
        return frozenset(out)


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """Declarative metadata for one registered impl: the rungs it serves
    (``policies``), the subset it runs in one fused call
    (``fused_policies``) and feature tags.  ``pads_to_tiles`` says the
    impl's kernels take only tile-divisible operands (its wrapper pads
    them), which the auditor's PAL002 holds every kernel site to; most
    port kernels mask ragged edges and leave it False.  ``partitioning``
    (None: one device only) declares how the impl shards under a mesh;
    routes carrying a non-identity mesh validate against it like any
    other capability."""

    policies: frozenset[str] = ALL_POLICIES
    fused_policies: frozenset[str] = frozenset()
    features: frozenset[str] = frozenset()
    pads_to_tiles: bool = False
    partitioning: Partitioning | None = None

    def has(self, feature: str) -> bool:
        return feature in self.features

    def supports_policy(self, policy: str) -> bool:
        return policy in self.policies


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One kernel family: abstract contract + reference + test hooks.

    The audit hooks drive the static auditor (``repro_torch.analysis``)
    with no family-specific auditor code: ``grad_args`` names the operand
    the backward surface differentiates; ``audit_contractions`` is the
    number of tensor-core contraction sites one forward call performs
    (the pass-count rule checks ``contractions == num_passes(policy) *
    audit_contractions``); ``audit_runs`` lists extra feature-gated entry
    points as ``(feature_tag, contractions, fn(problem, route) ->
    tensor)``, audited only for impls declaring that feature (attention
    registers its ``decode`` / ``paged_decode`` surfaces here);
    ``audit_meshes`` names the mesh specs whose sharded traces must
    jointly exercise every declared ``Partitioning`` collective.
    """

    family: str
    contract: str
    reference: str
    label: str = ""
    layer_families: tuple[str, ...] = ()
    make_problem: Callable[[int], dict] | None = None
    run: Callable[..., Any] | None = None
    oracle: Callable[[dict], Any] | None = None
    error_bound: Callable[[str], float] | None = None
    grad_args: tuple[str, ...] = ()
    audit_contractions: int = 1
    audit_runs: tuple[tuple[str, int, Callable[..., Any]], ...] = ()
    audit_meshes: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.label:
            object.__setattr__(self, "label", f"{self.family} backend")

    @property
    def auditable(self) -> bool:
        """Whether ``repro_torch.analysis`` can audit this family (a
        problem builder and a routed runner)."""
        return self.make_problem is not None and self.run is not None


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of a family."""

    family: str
    name: str
    fn: Any
    capabilities: Capabilities


_FAMILIES: dict[str, OpSpec] = {}
_IMPLS: dict[str, dict[str, KernelImpl]] = {}


def register_family(spec: OpSpec) -> OpSpec:
    """Register (or replace) a kernel family."""
    _FAMILIES[spec.family] = spec
    _IMPLS.setdefault(spec.family, {})
    return spec


def register_impl(family: str, name: str, *,
                  capabilities: Capabilities | None = None,
                  policies: Iterable[str] | None = None,
                  fused_policies: Iterable[str] = (),
                  features: Iterable[str] = (),
                  pads_to_tiles: bool = False,
                  partitioning: Partitioning | None = None):
    """Decorator registering ``fn`` as impl ``name`` of ``family``."""
    if family not in _FAMILIES:
        raise ValueError(
            f"unknown op family {family!r}; registered: {families()} "
            f"(register_family first)")
    caps = capabilities or Capabilities(
        policies=(ALL_POLICIES if policies is None else frozenset(policies)),
        fused_policies=frozenset(fused_policies),
        features=frozenset(features),
        pads_to_tiles=pads_to_tiles,
        partitioning=partitioning,
    )

    def wrap(fn):
        _IMPLS[family][name] = KernelImpl(
            family=family, name=name, fn=fn, capabilities=caps)
        return fn

    return wrap


def get_family(family: str) -> OpSpec:
    if family not in _FAMILIES:
        raise ValueError(
            f"unknown op family {family!r}; registered: {families()}")
    return _FAMILIES[family]


def get_impl(family: str, name: str) -> KernelImpl:
    """Look up one impl; unknown names fail with the registered list."""
    spec = get_family(family)
    impls = _IMPLS[family]
    if name not in impls:
        raise ValueError(
            f"unknown {spec.label} {name!r}; registered: "
            f"{available_impls(family)}")
    return impls[name]


def families() -> tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def available_impls(family: str) -> tuple[str, ...]:
    get_family(family)
    return tuple(sorted(_IMPLS[family]))


def reference_impl(family: str) -> str:
    return get_family(family).reference


# ========================================================== introspection

def _fmt_policies(pols: frozenset[str]) -> str:
    if pols == ALL_POLICIES:
        return "all"
    return ",".join(p for p in POLICIES if p in pols) or "-"


def capability_rows() -> list[dict[str, str]]:
    """The family x impl x capability table as data rows."""
    rows = []
    for family in families():
        spec = get_family(family)
        for name in available_impls(family):
            c = get_impl(family, name).capabilities
            rows.append({
                "family": family,
                "impl": name,
                "role": "reference" if name == spec.reference else "kernel",
                "policies": _fmt_policies(c.policies),
                "fused": _fmt_policies(c.fused_policies),
                "features": ",".join(sorted(c.features)) or "-",
                "shardable": (",".join(sorted(c.partitioning.roles))
                              if c.partitioning else "-"),
                "audited": "yes" if spec.auditable else "-",
            })
    return rows


_COLS = ("family", "impl", "role", "policies", "fused", "features", "shardable",
         "audited")


def capability_markdown() -> str:
    """The capability table as a markdown block."""
    lines = ["| " + " | ".join(_COLS) + " |",
             "|" + "|".join("---" for _ in _COLS) + "|"]
    for r in capability_rows():
        lines.append("| " + " | ".join(f"`{r[c]}`" if c == "impl" else r[c]
                                       for c in _COLS) + " |")
    return "\n".join(lines)

