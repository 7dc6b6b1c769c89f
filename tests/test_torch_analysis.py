"""The port's static auditor (``repro_torch.analysis``) held against
``repro.analysis`` on the CPU.

* Catalogue and findings: the rule IDs and severities are ``repro``'s,
  the sharding rules (SHD001-003, over each family's ``audit_meshes``
  traces) included, and a finding's key, dict and text are ``repro``'s
  for the same fields.
* Baselines: a file saved by either package loads in the other and
  suppresses the same findings.
* Structure: for every (family, port impl <-> ``repro`` impl) pair and
  policy both declare, the port's contraction count (outside plus inside
  kernels) and kernel-launch count equal ``repro``'s ``len(scan.dots)``
  and ``scan.pallas_calls`` (``interpret=True`` routes).
* Mutations: one seeded violation per kept rule in a sandboxed registry
  fires exactly that rule.
* Clean runs: the real registry on the audited ``cuda`` device and both
  source sweeps over the real trees are clean after the package's
  baseline; a trace of every kernel entry point on fake CUDA tensors
  launches nothing and loads no library.
* The functions whose contractions the source sweep made explicit, on
  bf16 inputs against ``repro``'s.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import auditor as j_auditor
from repro.analysis.jaxpr_scan import scan_jaxpr, trace_jaxpr
from repro.analysis.rules import RULES as J_RULES
from repro.analysis.rules import make_finding as j_make_finding
from repro.core.ops import registry as j_registry
from repro_torch.analysis import auditor
from repro_torch.analysis.graph_scan import scan_graph, trace_graph
from repro_torch.analysis.rules import RULES, make_finding
from repro_torch.analysis.source_rules import scan_cuda_source, scan_source
from repro_torch.core.ops import registry, shard
from repro_torch.core.ops.registry import OpSpec, Partitioning
from repro_torch.kernels import (_build, _trace, attention_fused, attention_paged, batched_gemm,
                                 gemm_grouped, gemm_lowp, gemm_naive, gemm_refined, gemm_tiled,
                                 wkv6)

FAM = "mutantfam"
SHARDING_RULES = {"SHD001", "SHD002", "SHD003"}


# ============================================================ catalogue

def test_catalogue_matches_repro():
    assert SHARDING_RULES <= set(RULES)
    assert set(RULES) == set(J_RULES)
    for rule_id, r in RULES.items():
        assert (r.rule_id, r.severity) == (J_RULES[rule_id].rule_id, J_RULES[rule_id].severity)


@pytest.mark.parametrize("rule_id", sorted(RULES))
def test_finding_model_matches_repro(rule_id):
    target, msg = "gemm/cuda/bf16#vjp", "seeded message"
    mine, theirs = make_finding(rule_id, target, msg), j_make_finding(rule_id, target, msg)
    assert mine.key == theirs.key
    assert mine.as_dict() == theirs.as_dict()
    assert str(mine) == str(theirs)


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_baselines_cross_load(tmp_path, writer):
    path = str(tmp_path / "baseline.json")
    pairs = [("PRE001", "fam/impl/bf16"), ("CAP003", "fam/impl/bf16x3"),
             ("SRC001", "models/ssm.py:12")]
    mine = [make_finding(r, t, "seeded") for r, t in pairs]
    theirs = [j_make_finding(r, t, "seeded") for r, t in pairs]
    (auditor if writer == "port" else j_auditor).save_baseline(
        path, (mine if writer == "port" else theirs)[:2])
    for pkg, found in ((auditor, mine), (j_auditor, theirs)):
        base = pkg.load_baseline(path)
        assert base["schema"] == "analysis_baseline/v1"
        res = pkg.apply_baseline(found[1:] + [make_finding("PAL001", "fam/impl/f32", "new")]
                                 if pkg is auditor else
                                 found[1:] + [j_make_finding("PAL001", "fam/impl/f32", "new")],
                                 base)
        assert [f.key for f in res.suppressed] == [pairs[1][0] + "|" + pairs[1][1]]
        assert [f.key for f in res.unsuppressed] == ["SRC001|models/ssm.py:12",
                                                     "PAL001|fam/impl/f32"]
        assert res.stale_keys == ("PRE001|fam/impl/bf16",)


def test_baseline_missing_file_is_empty(tmp_path):
    assert auditor.load_baseline(str(tmp_path / "absent.json"))["suppressions"] == []


def test_package_baseline_gives_every_suppression_a_reason():
    data = json.load(open(auditor.default_baseline_path()))
    assert data["schema"] == "analysis_baseline/v1"
    for s in data["suppressions"]:
        assert s["reason"].strip() and "review before trusting" not in s["reason"]


# ============================================================ structure

PAIRS = {"torch": "xla", "cuda": "pallas", "cuda_naive": "pallas_naive",
         "cuda_grouped": "pallas_grouped", "cuda_fused": "pallas_fused"}
# (family, port impl, policy, surface) -> why the counts differ.  Every
# pair both packages declare is compared; none differs today.
DIFFERENCES: dict[tuple, str] = {}


def _structure_cases():
    out = []
    for fam in registry.families():
        spec = registry.get_family(fam)
        surfaces = ["forward"] + [feat for feat, _, _ in spec.audit_runs]
        for impl in registry.available_impls(fam):
            j_impl = PAIRS[impl]
            assert j_impl in j_registry.available_impls(fam), (fam, impl)
            both = (registry.get_impl(fam, impl).capabilities.policies
                    & j_registry.get_impl(fam, j_impl).capabilities.policies)
            for pol in sorted(both):
                out += [(fam, impl, pol, s) for s in surfaces]
    return out


def _runner(spec, surface):
    if surface == "forward":
        return spec.run
    return next(run for feat, _, run in spec.audit_runs if feat == surface)


@pytest.mark.parametrize("fam,impl,pol,surface", _structure_cases())
def test_structure_matches_repro(fam, impl, pol, surface):
    spec, j_spec = registry.get_family(fam), j_registry.get_family(fam)
    route = auditor._route(fam, impl, pol)
    scan = scan_graph(trace_graph(lambda p: _runner(spec, surface)(p, route),
                                  spec.make_problem(0)))
    j_route = j_auditor._route(fam, PAIRS[impl], pol)
    j_problem = j_spec.make_problem(0)
    j_scan = scan_jaxpr(trace_jaxpr(lambda: _runner(j_spec, surface)(j_problem, j_route)))
    got, want = (scan.dots, scan.kernel_calls), (len(j_scan.dots), j_scan.pallas_calls)
    if (fam, impl, pol, surface) in DIFFERENCES:
        assert got != want, f"named difference no longer differs: {DIFFERENCES}"
    else:
        assert got == want
    assert scan.outer_dots == j_scan.outer_dots


@pytest.mark.parametrize("fam", ["gemm", "attention", "grouped"])
def test_reference_backward_downcasts_as_repro(fam):
    """The reference routes' backward at a multi-pass rung sums the terms'
    cotangents in bf16 (the transpose of the term split's casts), in both
    packages: PRE003 fires at the same surfaces for ``torch`` and ``xla``.
    The default audit samples the backward at bf16 and does not reach it;
    the kernel routes' backward sums in f32 (ROADMAP C, reference state)."""
    pols = ["bf16x3", "refine_ab"]
    mine = {(f.rule_id, f.target.replace("/torch/", "/"))
            for f in auditor.audit_impl(fam, "torch", policies=pols)}
    theirs = {(f.rule_id, f.target.replace("/xla/", "/"))
              for f in j_auditor.audit_impl(fam, "xla", policies=pols, meshes=False)}
    assert mine == theirs == {("PRE003", f"{fam}/bf16x3#vjp")}
    assert auditor.audit_impl(fam, "cuda" if fam == "gemm" else registry.available_impls(fam)[0],
                              policies=pols) == []


# ============================================================ mutations

@pytest.fixture
def sandbox():
    """Snapshot/restore the registry around a synthetic-family test."""
    fams = dict(registry._FAMILIES)
    impls = {k: dict(v) for k, v in registry._IMPLS.items()}
    yield
    registry._FAMILIES.clear()
    registry._FAMILIES.update(fams)
    registry._IMPLS.clear()
    registry._IMPLS.update(impls)


def _problem(seed: int) -> dict:
    return {"a": torch.ones((8, 8)), "b": torch.ones((8, 8))}


def _register(run, *, impl="probe", policies=("bf16",), fused=(), features=(),
              contractions=1, audit_runs=(), grad_args=(), pads_to_tiles=False,
              partitioning=None, audit_meshes=()):
    registry.register_family(OpSpec(
        family=FAM, contract="a, b -> out", reference=impl, make_problem=_problem, run=run,
        grad_args=tuple(grad_args), audit_contractions=contractions,
        audit_runs=tuple(audit_runs), audit_meshes=tuple(audit_meshes)))
    registry.register_impl(FAM, impl, policies=policies, fused_policies=fused,
                           features=features, pads_to_tiles=pads_to_tiles,
                           partitioning=partitioning)(lambda *a, **k: None)


def _audit(impl="probe", **kw):
    return auditor.audit_impl(FAM, impl, **kw)


def _ids(findings):
    return {f.rule_id for f in findings}


def _site(**kw):
    fields = dict(kernel="probe", entry="probe_launch", mainloop=None, policy="bf16", terms=1,
                  contractions=1, outputs=(((8, 8), torch.float32),))
    fields.update(kw)
    return _trace.KernelSite(**fields)


def _kernel(site):
    """A run whose one launch is ``site`` (the plain product off a trace)."""
    def run(problem, route):
        a, b = problem["a"], problem["b"]
        if _trace.ACTIVE:
            return _trace.launch(site, a, b)
        return a.float() @ b.float()
    return run


def test_mut_aud001_untraceable_surface(sandbox):
    def run(problem, route):
        raise ValueError("deliberately untraceable")
    _register(run, contractions=0)
    assert _ids(_audit()) == {"AUD001"}


def test_mut_pre001_narrow_accumulation(sandbox):
    def run(problem, route):
        return torch.mm(problem["a"].bfloat16(), problem["b"].bfloat16())
    _register(run)
    found = _audit()
    assert _ids(found) == {"PRE001"}
    assert found[0].target == f"{FAM}/probe/bf16"


def test_mut_pre002_pass_count_drift(sandbox):
    # declares the 3-pass bf16x3 rung but traces one contraction
    def run(problem, route):
        return problem["a"].float() @ problem["b"].float()
    _register(run, policies=("bf16x3",))
    assert _ids(_audit()) == {"PRE002"}


def test_mut_pre003_downcast_before_accumulate(sandbox):
    def run(problem, route):
        d = torch.mm(problem["a"].float(), problem["b"].float())
        return d.to(torch.bfloat16) + problem["a"].to(torch.bfloat16)
    _register(run)
    assert _ids(_audit()) == {"PRE003"}


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("no backward")


def test_mut_cap001_vjp_claim_without_backward(sandbox):
    def run(problem, route):
        return _NoBackward.apply(problem["a"])
    _register(run, features=("vjp",), grad_args=("a",), contractions=0)
    assert _ids(_audit()) == {"CAP001"}


def test_mut_cap002_decode_claim_untraceable(sandbox):
    def run(problem, route):
        return problem["a"].float() @ problem["b"].float()

    def decode(problem, route):
        raise ValueError("no decode path")
    _register(run, features=("decode",), audit_runs=(("decode", 1, decode),))
    assert _ids(_audit()) == {"CAP002"}


def test_mut_cap003_fused_claim_decomposes_router_side(sandbox):
    # bf16x3 is declared fused but the runner launches the kernel 3 times
    def run(problem, route):
        a, b = problem["a"], problem["b"]
        if route.precision == "bf16x3":
            return gemm_tiled.gemm_tiled(a, b) + gemm_tiled.gemm_tiled(a, b) \
                + gemm_tiled.gemm_tiled(a, b)
        return gemm_tiled.gemm_tiled(a, b)
    _register(run, policies=("bf16", "bf16x3"), fused=("bf16", "bf16x3"))
    found = _audit()
    assert _ids(found) == {"CAP003"}
    assert found[0].target == f"{FAM}/probe/bf16x3"


def _sharded(*reductions):
    """A run whose sharded trace reduces its product over each (axis,
    dtype) of ``reductions``."""
    def run(problem, route):
        out = problem["a"].float() @ problem["b"].float()
        spec = shard.active_mesh(route.mesh)
        if spec is not None:
            mesh = shard._mesh_for(spec)
            for axis, dtype in reductions:
                out = shard._psum(out.to(dtype), mesh, axis).float()
        return out
    return run


_PSUM_TP = Partitioning(specs=(("b", (None, "tp")),), collectives=("psum_f32:tp",))


def test_mut_shd001_undeclared_collective(sandbox):
    _register(_sharded(("model", torch.float32), ("data", torch.float32)),
              partitioning=_PSUM_TP, audit_meshes=("dp=2,tp=2",))
    found = _audit()
    assert _ids(found) == {"SHD001"}
    assert found[0].target == f"{FAM}/probe/bf16@dp=2,tp=2"
    assert _audit(meshes=False) == []


def test_mut_shd002_declared_collective_never_observed(sandbox):
    part = Partitioning(specs=_PSUM_TP.specs, collectives=("psum_f32:tp", "all_gather_kv:sp"))
    _register(_sharded(("model", torch.float32)), partitioning=part,
              audit_meshes=("dp=2,tp=2",))
    found = _audit()
    assert _ids(found) == {"SHD002"}
    assert found[0].target == f"{FAM}/probe@audit-meshes"


def test_mut_shd003_f32_reduction_on_a_narrow_operand(sandbox):
    # the row-parallel epilogue reduced in bf16
    _register(_sharded(("model", torch.bfloat16)), partitioning=_PSUM_TP,
              audit_meshes=("tp=2",))
    assert _ids(_audit()) == {"SHD003"}


def test_mut_pal001_split_range_leaves_grid(sandbox):
    _register(_kernel(_site(split_total=4, splits=((0, 2), (2, 5)),
                            workspace_dtype=torch.float32)))
    assert _ids(_audit()) == {"PAL001"}


def test_mut_pal001_tile_origin_leaves_grid(sandbox):
    blk = _trace.Block("a", (64,), (32,), lambda i: (i + 1,))      # off by one
    _register(_kernel(_site(grid=(2,), blocks=(blk,))))
    assert _ids(_audit()) == {"PAL001"}


def test_mut_pal002_tile_does_not_divide(sandbox):
    _register(_kernel(_site(blocks=(_trace.Block("a", (48,), (32,), divisible=True),))))
    assert _ids(_audit()) == {"PAL002"}


def test_mut_pal002_pads_to_tiles_impl(sandbox):
    _register(_kernel(_site(blocks=(_trace.Block("a", (48,), (32,)),))), pads_to_tiles=True)
    assert _ids(_audit()) == {"PAL002"}


def test_mut_pal003_narrow_site_accumulator(sandbox):
    _register(_kernel(_site(acc_dtype=torch.bfloat16)))
    assert _ids(_audit()) == {"PAL003"}


def test_mut_pal003_narrow_accumulator_in_cuda_source(tmp_path):
    (tmp_path / "bad.cu").write_text(
        'asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f16.bf16.bf16 "\n'
        '             "{%0}");\n'
        'asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 {%0}");\n'
        "wmma::fragment<wmma::accumulator, 16, 16, 16, half> acc;\n")
    (tmp_path / "ok.cuh").write_text(
        'asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
        'asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0}");\n'
        "wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;\n")
    found = scan_cuda_source(str(tmp_path))
    assert _ids(found) == {"PAL003"}
    assert [f.target for f in found] == ["bad.cu:1", "bad.cu:3", "bad.cu:4"]


def test_mut_pal004_cuda_route_reaches_plain_version(sandbox):
    def run(problem, route):
        return gemm_tiled.gemm_tiled_plain(problem["a"], problem["b"])
    _register(run, impl="cuda_probe")
    found = _audit("cuda_probe")
    assert _ids(found) == {"PAL004"}
    assert "gemm_tiled_plain" in found[0].message


def test_mut_src001_raw_contraction(tmp_path):
    (tmp_path / "bad.py").write_text(
        "import torch\n"
        "def f(a, b):\n"
        "    return torch.einsum('ij,jk->ik', a, b)\n"
        "def g(a, b):\n"
        "    return a @ b.float()\n")
    (tmp_path / "ok.py").write_text(
        "import numpy as np\n"
        "import torch\n"
        "def f(a, b):\n"
        "    return torch.einsum('ij,jk->ik', a.float(), b.to(torch.float32))\n"
        "def g(a, b):\n"
        "    return torch.mm(a, b, out_dtype=torch.float32) + a.double() @ b.double()\n"
        "def h(a, b):\n"
        "    return a.astype(np.float64) @ b.astype(np.float64)\n")
    found = scan_source(str(tmp_path))
    assert _ids(found) == {"SRC001"}
    assert [f.target for f in found] == ["bad.py:3", "bad.py:5"]


def test_every_rule_has_a_mutation_test():
    """The catalogue and this file move together: a new rule ID without a
    seeded violation here fails immediately."""
    import pathlib
    src = pathlib.Path(__file__).read_text()
    for rule_id in RULES:
        assert f"test_mut_{rule_id.lower()}" in src, f"rule {rule_id} has no mutation test"


# ============================================================ clean runs

_KERNEL_MODULES = (gemm_tiled, gemm_refined, gemm_lowp, gemm_naive, attention_fused,
                   attention_paged, gemm_grouped, batched_gemm, wkv6)


def _counters():
    return {(m.__name__, k): copy.deepcopy(v) for m in _KERNEL_MODULES
            for k, v in vars(m).items() if "LAUNCHES" in k}


class _NoLoad:
    """Patch ``_build.load`` to record (and refuse) every library load."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.orig = _build.load
        _build.load = lambda name: self.calls.append(name) or (_ for _ in ()).throw(
            AssertionError(f"library {name!r} loaded inside a trace"))
        return self

    def __exit__(self, *exc):
        _build.load = self.orig


@pytest.fixture(scope="module")
def real_audit():
    before = _counters()
    with _NoLoad() as nl:
        findings = auditor.audit_all(device="cuda", source=False)
    return findings, before, _counters(), nl.calls


def test_real_registry_audits_clean(real_audit):
    findings = real_audit[0]
    res = auditor.apply_baseline(findings, auditor.load_baseline(None))
    assert res.unsuppressed == ()
    assert res.stale_keys == ()


def test_real_registry_trace_launches_nothing(real_audit):
    _, before, after, loads = real_audit
    assert after == before
    assert loads == []


def test_source_trees_audit_clean():
    assert scan_source() == []
    assert scan_cuda_source() == []


def test_registry_reports_audited_column():
    rows = registry.capability_rows()
    assert rows and all(r["audited"] == "yes" for r in rows)
    md = registry.capability_markdown()
    assert md.count("\n") == len(rows) + 1 and "| audited |" in md.splitlines()[0]


def test_cli_list_rules_and_family(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule_id in out for rule_id in RULES)
    assert main(["--family", "gemm", "--impl", "cuda", "--policy", "bf16", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []
    assert main(["--family", "grouped", "--impl", "torch", "--policy", "bf16", "--no-meshes",
                 "--no-source", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []
    assert main(["--impl", "cuda"]) == 2


def test_cpu_audit_names_its_differences():
    """``device="cpu"`` judges the routes the CPU runs: the plain versions.
    The grouped plain version multiplies each group on its own (E = 3
    products at make_problem), so the pass count sees E contractions a
    pass -- by design, and only there."""
    found = auditor.audit_family("grouped", device="cpu")
    assert {(f.rule_id, f.target.split("/")[1]) for f in found} == {("PRE002", "cuda_grouped")}
    assert all(f.target.endswith("@cpu") for f in found)
    assert auditor.audit_family("gemm", device="cpu") == []


def _fake(mode, shape, dtype=torch.float32):
    with mode:
        return torch.empty(shape, dtype=dtype, device="cuda")


def _entry_point_calls(mode):
    """Every kernel entry point, once, on fake CUDA tensors."""
    from repro_torch.core.ops.paged import PagedKVCache
    f = lambda *s, **k: _fake(mode, s, **k)  # noqa: E731
    a, b, a4 = f(48, 132), f(132, 40), f(4, 132)
    a_dec, w_dec = f(4, 1024), f(1024, 64)          # enough K tiles to split
    # (no indexing: a CPU-only build cannot index a fake CUDA tensor)
    q, q1, kv, do = f(2, 16, 2, 2, 32), f(2, 1, 2, 2, 32), f(2, 16, 2, 32), f(2, 16, 2, 2, 32)
    lse = f(2, 4, 16)
    pos = f(2, dtype=torch.int32)
    kv_long = f(2, 512, 2, 32)                      # enough KV tiles to split
    pages = f(129, 8, 2, 32, dtype=torch.bfloat16)
    cache = PagedKVCache(k_pages=pages, v_pages=pages, page_table=f(2, 64, dtype=torch.int32),
                         k_scale=None, v_scale=None, s_cache=512)
    x, w, off = f(64, 36), f(3, 36, 24), f(4, dtype=torch.int32)
    g, r = f(64, 16, 16), f(1, 64, 2, 16)
    return {
        "gemm_tiled": lambda: (gemm_tiled.gemm_tiled(a, b),
                              gemm_tiled.gemm_tiled(a_dec, w_dec)),
        "gemm_refined": lambda: gemm_refined.gemm_refined(a4, b, policy="bf16x3"),
        "gemm_lowp": lambda: (gemm_lowp.gemm_lowp(a, b, policy="int8", bm=48, bn=40, bk=132),
                              gemm_lowp.gemm_lowp(a4, b, policy="fp8x3", bm=4, bn=40, bk=132)),
        "gemm_naive": lambda: gemm_naive.gemm_naive(a, b),
        "flash_attention": lambda: attention_fused.flash_attention_fwd(q, kv, kv),
        "flash_attention_bwd_dq": lambda: attention_fused.flash_attention_bwd_dq(
            q, kv, kv, do, lse, lse),
        "flash_attention_bwd_dkv": lambda: attention_fused.flash_attention_bwd_dkv(
            q, kv, kv, do, lse, lse),
        "flash_decode": lambda: attention_fused.flash_decode(q1, kv_long, kv_long, pos),
        "flash_paged_decode": lambda: attention_paged.flash_paged_decode(q1, cache, pos),
        "grouped_gemm": lambda: gemm_grouped.grouped_gemm(x, w, off, bm=16),
        "grouped_gemm_dw": lambda: gemm_grouped.grouped_gemm_dw(x, f(64, 24), off),
        "grouped_dw_scales": lambda: gemm_grouped.grouped_dw_scales(x, f(64, 24), off,
                                                                    policy="fp8"),
        "batched_gemm": lambda: batched_gemm.batched_gemm(g, g),
        "batched_gemm_naive": lambda: batched_gemm.batched_gemm_naive(g, g),
        "wkv6": lambda: wkv6.wkv6(r, r, r, r, f(2, 16), chunk=32),
    }


def test_entry_points_on_fake_cuda_launch_nothing():
    from repro_torch.analysis.kernel_rules import check_kernel_site
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    calls = _entry_point_calls(mode)
    before = _counters()
    with _NoLoad() as nl, _trace.tracing() as state, mode:
        for call in calls.values():
            call()
    assert _counters() == before and nl.calls == []
    assert state.plain == []
    seen = {s.kernel for s in state.sites}
    assert seen == set(calls)
    for site in state.sites:
        assert check_kernel_site(site, "entry-points") == [], site
    by_kernel = {s.kernel: s for s in state.sites}       # each kernel's last launch
    assert by_kernel["gemm_tiled"].mainloop == "splitk" and by_kernel["gemm_tiled"].splits
    assert by_kernel["gemm_lowp"].grid and by_kernel["gemm_lowp"].blocks
    assert by_kernel["flash_decode"].splits and by_kernel["flash_paged_decode"].splits


def test_eager_entry_points_make_no_custom_op_call():
    """Outside a trace an entry point runs its plain version on CPU
    tensors with no dispatcher hop: the op's dispatcher sees no call."""
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gemm_tiled.gemm_tiled(a, b)
    names = {e.name for e in prof.events()}
    assert not any("repro_torch_trace" in n for n in names)
    assert not _trace.ACTIVE


# ==================================== the source sweep's sites on bf16 inputs

def _bf16(rng, shape, lo=-1.0, hi=1.0):
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_ssd_chunked_on_bf16_matches_repro():
    """bf16 contraction operands (x, B, C); the decays rel and dt stay f32,
    as every caller passes them (an elementwise chain on bf16 rounds
    differently under XLA's fusion, which is not what this holds)."""
    from repro.models.ssm import _ssd_chunked as j_ssd
    from repro_torch.models.ssm import _ssd_chunked
    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 12, 2, 4, 4
    (x, jx), (bm, jbm), (cm, jcm) = (_bf16(rng, sh) for sh in ((b, s, h, p), (b, s, n),
                                                                 (b, s, n)))
    rel = rng.uniform(-0.2, 0.0, (b, s, h)).astype(np.float32)
    dt = rng.uniform(0.0, 1.0, (b, s, h)).astype(np.float32)
    y, st = _ssd_chunked(x, bm, cm, torch.from_numpy(rel), torch.from_numpy(dt), 4, "f32")
    jy, jst = j_ssd(jx, jbm, jcm, jnp.asarray(rel), jnp.asarray(dt), 4, "f32")
    assert y.dtype == st.dtype == torch.float32
    _close(y, jy)
    _close(st, jst)


def test_wkv_chunked_on_bf16_matches_repro():
    """bf16 r, k, v; the log decay and the bonus u f32, as every caller
    passes them."""
    from repro.models.rwkv import _wkv_chunked as j_wkv
    from repro_torch.models.rwkv import _wkv_chunked
    rng = np.random.default_rng(1)
    shape = (1, 16, 2, 8)
    (r, jr), (k, jk), (v, jv) = (_bf16(rng, shape) for _ in range(3))
    logw = rng.uniform(-1.0, -0.01, shape).astype(np.float32)
    u = rng.uniform(-1, 1, (2, 8)).astype(np.float32)
    out, st = _wkv_chunked(r, k, v, torch.from_numpy(logw), torch.from_numpy(u), 8,
                           policy="f32")
    jout, jst = j_wkv(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u), 8, policy="f32")
    assert out.dtype == st.dtype == torch.float32
    _close(out, jout)
    _close(st, jst)


def test_wkv6_plain_on_bf16_matches_repro():
    from repro.kernels.ref import wkv6_ref as j_wkv6_ref
    rng = np.random.default_rng(2)
    shape = (1, 32, 2, 16)
    (r, jr), (k, jk), (v, jv) = (_bf16(rng, shape) for _ in range(3))
    logw, jlogw = _bf16(rng, shape, -1.0, -0.01)
    u, ju = _bf16(rng, (2, 16))
    out, st = wkv6.wkv6_plain(r, k, v, logw, u, chunk=16)
    jout, jst = j_wkv6_ref(jr, jk, jv, jlogw, ju)
    _close(out, jout, 1e-3)
    _close(st, jst, 1e-3)
