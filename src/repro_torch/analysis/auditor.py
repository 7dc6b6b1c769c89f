"""The registry auditor: prove capability contracts from traced graphs
alone (twin of ``repro.analysis.auditor``).

For every registered ``(family, impl, policy)`` triple the auditor traces
the family's ``OpSpec`` hooks with ``make_fx`` over fake tensors on the
audited device (``graph_scan.trace_graph``: no kernel runs, no device
memory is allocated, no library loads) and judges the graph against the
impl's declared capabilities:

  precision flow   every aten contraction outside a kernel accumulates in
                   >= 32 bits (PRE001), no narrowing cast sits between a
                   contraction and its accumulate (PRE003), and the trace
                   holds exactly ``num_passes(policy) * audit_contractions``
                   contractions, a kernel's fused passes counted as its
                   contractions (PRE002);
  capabilities     a ``vjp`` claim must yield a traceable backward
                   (CAP001, ``torch.autograd.grad`` under ``make_fx``),
                   ``decode``-class claims must trace through the family's
                   ``audit_runs`` (CAP002), and ``fused_policies`` must fuse
                   in the kernel -- one launch count across fused rungs,
                   no contraction outside it -- while router-decomposed
                   rungs show one launch a pass (CAP003);
  sharding         over each ``OpSpec.audit_meshes`` trace (``shard.
                   abstract_meshes``: coordinate 0, no peers, every
                   collective recorded), the body's collectives against the
                   impl's declared ``Partitioning``: none undeclared
                   (SHD001), none declared but never observed (SHD002), an
                   ``*_f32`` reduction on an f32 operand (SHD003).  The
                   gather that assembles a sharded output for the caller
                   (``repro``'s ``shard_map`` out_specs) is not a body
                   collective;
  kernels          each launch's split ranges, tile maps, tile divisibility
                   and accumulator dtypes (``kernel_rules``), and a ``cuda*``
                   route never reaching a plain version (PAL004).

The audited device is ``cuda`` by default: the ``cuda*`` impls' kernel
sites are what is judged, on fake CUDA tensors that need no card.
``device="cpu"`` judges the routes the CPU tests run (the plain versions,
no kernel sites).  Targets enumerate from the registry, so a future
``register_impl`` is audited with no auditor change.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections.abc import Iterable, Sequence

import torch

from repro_torch.analysis.graph_scan import ScanResult, scan_graph, trace_graph
from repro_torch.analysis.kernel_rules import check_kernel_site
from repro_torch.analysis.rules import Finding, make_finding
from repro_torch.analysis.source_rules import scan_cuda_source, scan_source
from repro_torch.core.precision import num_passes

__all__ = [
    "audit_impl",
    "audit_family",
    "audit_all",
    "audit_execution_policy",
    "load_baseline",
    "save_baseline",
    "apply_baseline",
    "default_baseline_path",
    "BaselineResult",
]

# Policies the per-surface sweeps (vjp / decode) sample: one single-pass
# rung, one multi-pass rung, the exact rung.
_SURFACE_POLICIES = ("bf16", "bf16x3", "f32")


def _registry():
    from repro_torch.core import ops
    return ops.registry


def _route(family: str, impl: str, policy: str, mesh=None):
    from repro_torch.core.ops.route import Route
    return Route(precision=policy, backends=((family, impl),), mesh=mesh)


# role -> mesh axis, as the sharded ops bind them
ROLE_AXIS = {"dp": "data", "sp": "data", "tp": "model", "ep": "expert", "pod": "pod"}
# longest-prefix match for declared collective names ("psum_f32:tp" ->
# psum over the tp role's axis, f32 required)
_COLL_PREFIXES = ("reduce_scatter", "psum_scatter", "all_gather", "all_to_all", "ppermute",
                  "psum")


def parse_collective(name: str) -> tuple[str, str, bool] | None:
    """Declared collective -> (primitive, mesh axis, f32 required)."""
    label, _, role = name.partition(":")
    prim = next((p for p in _COLL_PREFIXES if label.startswith(p)), None)
    axis = ROLE_AXIS.get(role)
    if prim is None or axis is None:
        return None
    return prim, axis, "_f32" in label


def _acc_ok(dtype) -> bool:
    """>= 32-bit accumulation (f32/f64 floats, i32 for integer products)."""
    if not isinstance(dtype, torch.dtype) or dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return torch.finfo(dtype).bits >= 32
    if dtype.is_complex:
        return True
    return torch.iinfo(dtype).bits >= 32


def _judge_trace(scan: ScanResult, target: str, policy: str, contractions: int, caps,
                 impl_name: str, *, check_passes: bool = True) -> list[Finding]:
    out: list[Finding] = []
    for i, dot in enumerate(scan.contractions):
        if not _acc_ok(dot.out_dtype):
            out.append(make_finding(
                "PRE001", target,
                f"contraction {i} ({dot.op}) accumulates in {dot.out_dtype} "
                f"({dot.lhs_dtype} x {dot.rhs_dtype}) — tensor-core "
                f"contractions must accumulate in f32"))
    if check_passes:
        expected = num_passes(policy) * contractions
        if scan.dots != expected:
            out.append(make_finding(
                "PRE002", target,
                f"traced {scan.dots} contractions ({scan.outer_dots} outside "
                f"kernels), expected {expected} (= {num_passes(policy)} passes x "
                f"{contractions} contraction sites) — the {policy!r} "
                f"decomposition is not the declared rung structure"))
    for src_dt, dst_dt in scan.downcasts:
        out.append(make_finding(
            "PRE003", target,
            f"contraction output downcast {src_dt} -> {dst_dt} feeds an "
            f"accumulation add — the multiply/accumulate chain loses the f32 "
            f"accumulator"))
    for site in scan.kernels:
        out.extend(check_kernel_site(site, target, pads_to_tiles=caps.pads_to_tiles))
    if impl_name.startswith("cuda"):
        for name in sorted(set(scan.plain)):
            out.append(make_finding(
                "PAL004", target,
                f"{name} (a kernel's plain version) ran on the audited device — "
                f"a cuda route must launch its kernel there or raise"))
    return out


def _check_fusion_structure(scans: dict[str, ScanResult], caps, target_base: str,
                            suffix: str = "") -> list[Finding]:
    """CAP003: kernel-launch structure vs fused_policies (kernel-backed
    impls only: reference chains have no launches to structure)."""
    out: list[Finding] = []
    fused = {p: s for p, s in scans.items() if p in caps.fused_policies}
    if not any(s.kernel_calls for s in fused.values()):
        return out
    per_pass = min(s.kernel_calls for s in fused.values() if s.kernel_calls)
    for p, s in sorted(fused.items()):
        tgt = f"{target_base}/{p}{suffix}"
        if s.kernel_calls != per_pass:
            out.append(make_finding(
                "CAP003", tgt,
                f"declared fused but traces {s.kernel_calls} kernel launches "
                f"where the impl's fused baseline is {per_pass} — this rung "
                f"decomposes router-side"))
        elif s.outer_dots:
            out.append(make_finding(
                "CAP003", tgt,
                f"declared fused but {s.outer_dots} contraction(s) run OUTSIDE "
                f"the kernel — the ladder is not in-kernel"))
    for p, s in sorted(scans.items()):
        if p in caps.fused_policies:
            continue
        tgt = f"{target_base}/{p}{suffix}"
        expected = 0 if p == "f32" else num_passes(p) * per_pass
        if s.kernel_calls != expected:
            what = ("exact-f32 reference fallback (0 kernel launches)"
                    if p == "f32" else
                    f"router decomposition ({num_passes(p)} passes x "
                    f"{per_pass} launch(es))")
            out.append(make_finding(
                "CAP003", tgt,
                f"non-fused rung traces {s.kernel_calls} kernel launches; "
                f"expected {expected} — {what}"))
    return out


def _err(e: Exception) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"


def _audit_sharded(spec, impl, problem, policies: Sequence[str], device: str,
                   at: str) -> list[Finding]:
    """SHD001-003 (and the trace rules) over the family's audit meshes."""
    from repro_torch.core.ops import shard
    caps = impl.capabilities
    part = caps.partitioning
    out: list[Finding] = []
    declared: dict[tuple[str, str], tuple[str, bool]] = {}
    for name in part.collectives:
        parsed = parse_collective(name)
        if parsed is not None:
            prim, axis, f32 = parsed
            declared[(prim, axis)] = (name, f32)
    observed: set[tuple[str, str]] = set()
    policy = next((p for p in _SURFACE_POLICIES if p in policies),
                  next(iter(policies), "bf16"))
    for mesh_text in spec.audit_meshes:
        mesh = shard.MeshSpec.parse(mesh_text)
        target = f"{spec.family}/{impl.name}/{policy}@{mesh_text}{at}"
        route = _route(spec.family, impl.name, policy, mesh=mesh)
        try:
            with shard.abstract_meshes() as sites:
                trace = trace_graph(lambda p, r=route: spec.run(p, r), problem, device=device)
        except Exception as e:
            out.append(make_finding("AUD001", target, f"sharded trace failed: {_err(e)}"))
            continue
        out.extend(_judge_trace(scan_graph(trace), target, policy, spec.audit_contractions,
                                caps, impl.name))
        for site in sites:
            if site.boundary:
                continue
            for axis in site.axes:
                observed.add((site.prim, axis))
                dec = declared.get((site.prim, axis))
                if dec is None:
                    out.append(make_finding(
                        "SHD001", target,
                        f"traced {site.prim} over axis {axis!r}; the impl's Partitioning "
                        f"declares {sorted(part.collectives) or 'no collectives'}"))
                elif dec[1] and site.dtype != torch.float32:
                    out.append(make_finding(
                        "SHD003", target,
                        f"collective {dec[0]!r} declares an f32 reduction but the traced "
                        f"{site.prim} operand is {site.dtype}"))
    for (prim, axis), (name, _) in sorted(declared.items()):
        if (prim, axis) not in observed:
            out.append(make_finding(
                "SHD002", f"{spec.family}/{impl.name}@audit-meshes{at}",
                f"declared collective {name!r} ({prim} over {axis!r}) never observed on "
                f"audit meshes {list(spec.audit_meshes)} — drift between Partitioning and "
                f"the sharded body, or a mesh gap"))
    return out


def audit_impl(family: str, impl_name: str, *, policies: Iterable[str] | None = None,
               device: str = "cuda", meshes: bool = True) -> list[Finding]:
    """All findings for one registered impl, traced on ``device`` (a
    ``cpu`` audit's targets end in ``@cpu``); ``meshes`` adds the sharded
    traces of the family's ``audit_meshes``."""
    registry = _registry()
    spec = registry.get_family(family)
    if not spec.auditable:
        return []
    impl = registry.get_impl(family, impl_name)
    caps = impl.capabilities
    keep = None if policies is None else set(policies)
    pols = tuple(p for p in sorted(caps.policies) if keep is None or p in keep)
    problem = spec.make_problem(0)
    at = "" if device == "cuda" else f"@{device}"
    out: list[Finding] = []

    scans: dict[str, ScanResult] = {}
    for policy in pols:
        target = f"{family}/{impl_name}/{policy}{at}"
        route = _route(family, impl_name, policy)
        try:
            trace = trace_graph(lambda p, r=route: spec.run(p, r), problem, device=device)
        except Exception as e:
            out.append(make_finding("AUD001", target, f"forward trace failed: {_err(e)}"))
            continue
        scans[policy] = scan_graph(trace)
        out.extend(_judge_trace(scans[policy], target, policy, spec.audit_contractions, caps,
                                impl_name))
    out.extend(_check_fusion_structure(scans, caps, f"{family}/{impl_name}", at))

    if caps.has("vjp") and spec.grad_args:
        arg = spec.grad_args[0]
        policy = next((p for p in _SURFACE_POLICIES if p in pols), pols[0] if pols else "bf16")
        target = f"{family}/{impl_name}/{policy}{at}#vjp"
        route = _route(family, impl_name, policy)

        def _grad(p, x):
            y = spec.run({**p, arg: x}, route)
            return torch.autograd.grad(y.sum(), x)

        # every floating operand requires grad, as a training step's weights
        # do, so the backward computes (and the trace holds) all cotangents
        rest = {k: v for k, v in problem.items() if k != arg}
        try:
            trace = trace_graph(_grad, rest, problem[arg], device=device, grad_args=(0, 1))
        except Exception as e:
            out.append(make_finding(
                "CAP001", target,
                f"impl declares 'vjp' but the backward does not trace: {_err(e)}"))
        else:
            out.extend(_judge_trace(scan_graph(trace), target, policy,
                                    spec.audit_contractions, caps, impl_name,
                                    check_passes=False))

    for feature, contractions, run in spec.audit_runs:
        if not caps.has(feature):
            continue
        for policy in (p for p in _SURFACE_POLICIES if p in pols):
            target = f"{family}/{impl_name}/{policy}{at}#{feature}"
            route = _route(family, impl_name, policy)
            try:
                trace = trace_graph(lambda p, r=route, fn=run: fn(p, r), problem, device=device)
            except Exception as e:
                out.append(make_finding(
                    "CAP002", target,
                    f"impl declares {feature!r} but the surface does not trace: {_err(e)}"))
                continue
            out.extend(_judge_trace(scan_graph(trace), target, policy, contractions, caps,
                                    impl_name))

    if meshes and caps.partitioning is not None and spec.audit_meshes and pols:
        out.extend(_audit_sharded(spec, impl, problem, pols, device, at))
    return out


def audit_family(family: str, *, impl: str | None = None,
                 policies: Iterable[str] | None = None,
                 device: str = "cuda", meshes: bool = True) -> list[Finding]:
    registry = _registry()
    names = (impl,) if impl else registry.available_impls(family)
    out: list[Finding] = []
    for name in names:
        out.extend(audit_impl(family, name, policies=policies, device=device, meshes=meshes))
    return out


def audit_all(*, source: bool = True, source_root: str | None = None,
              cuda_root: str | None = None, device: str = "cuda",
              meshes: bool = True) -> list[Finding]:
    """Every registered (family, impl, policy) triple, the sharded traces
    of each family's audit meshes (unless ``meshes=False``) and both
    source sweeps (the Python SRC001 sweep and the CUDA PAL003 sweep)."""
    registry = _registry()
    out: list[Finding] = []
    for family in registry.families():
        out.extend(audit_family(family, device=device, meshes=meshes))
    if source:
        out.extend(scan_source(source_root))
        out.extend(scan_cuda_source(cuda_root))
    return out


def audit_execution_policy(policy, *, device: str = "cuda") -> list[Finding]:
    """Audit exactly the surfaces an ``ExecutionPolicy`` resolves to: each
    family's selected impl (layer-scoped overrides included) on the rungs
    the policy will run."""
    registry = _registry()
    out: list[Finding] = []
    seen: set[tuple[str, str, tuple[str, ...]]] = set()
    for family in registry.families():
        spec = registry.get_family(family)
        scopes: list[str | None] = [None]
        scopes += [lf for lf in (spec.layer_families or ())
                   if policy.impl_for(family, lf) != policy.impl_for(family)]
        for scope in scopes:
            impl = policy.impl_for(family, scope)
            rungs = tuple(sorted(policy._rungs_for(family, scope)))
            key = (family, impl, rungs)
            if key in seen:
                continue
            seen.add(key)
            out.extend(audit_impl(family, impl, policies=rungs, device=device))
    return out


# ============================================================== baselines

_BASELINE_SCHEMA = "analysis_baseline/v1"


def default_baseline_path() -> str:
    """``baseline.json`` beside this module: the port's reviewed
    suppressions, each with its reason."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: str | None) -> dict:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {"schema": _BASELINE_SCHEMA, "suppressions": []}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("schema") != _BASELINE_SCHEMA:
        raise ValueError(
            f"baseline {path}: unknown schema {data.get('schema')!r} "
            f"(expected {_BASELINE_SCHEMA!r})")
    return data


def save_baseline(path: str | None, findings: Sequence[Finding],
                  reason: str = "baselined (review before trusting)") -> str:
    path = path or default_baseline_path()
    data = {
        "schema": _BASELINE_SCHEMA,
        "suppressions": [
            {"key": f.key, "rule": f.rule_id, "reason": reason}
            for f in sorted(findings, key=lambda f: f.key)],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


@dataclasses.dataclass(frozen=True)
class BaselineResult:
    unsuppressed: tuple[Finding, ...]
    suppressed: tuple[Finding, ...]
    stale_keys: tuple[str, ...]      # suppressions that no longer fire


def apply_baseline(findings: Sequence[Finding], baseline: dict) -> BaselineResult:
    keys = {s["key"] for s in baseline.get("suppressions", ())}
    hit = {f.key for f in findings}
    return BaselineResult(
        unsuppressed=tuple(f for f in findings if f.key not in keys),
        suppressed=tuple(f for f in findings if f.key in keys),
        stale_keys=tuple(sorted(keys - hit)),
    )
