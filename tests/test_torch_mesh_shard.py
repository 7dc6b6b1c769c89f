"""The port's mesh layer (``repro_torch.core.ops.shard``) held against
``repro.core.ops.shard`` on the CPU.

* ``MeshSpec`` grammar, route validation, ``fallback`` and the
  capability table's ``shardable`` column: ``repro``'s
  ``tests/test_mesh_shard.py`` cases, each checked on both packages.
* An identity mesh traces the same ``make_fx`` graph as ``mesh=None``.
* The parity matrix of ``repro``'s ``tests/test_mesh_shard.py`` on the
  ``torch`` and ``cuda*`` routes (``runtime.mesh_checks.parity_cases``;
  on the CPU the ``cuda*`` routes run their kernels' plain versions): one
  spawned gloo world of 4 ranks runs every case of up to 4 ranks, one of
  8 ranks the dp=2,ep=2,tp=2 cases.  Every rank must hold the same
  result; rank 0's is bit-equal to the one-rank result where ``repro``
  asserts bit-equality and within 1e-5 for the row-parallel f32 case; the
  one-rank result is within the rung's ladder bound of ``repro``'s on the
  same seeded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.core import ops as jops
from repro.core.ops.shard import MeshSpec as JMeshSpec
from repro.runtime.monitor import run_header as j_run_header
from repro_torch.core import ops
from repro_torch.core.ops import registry, shard
from repro_torch.core.ops.registry import LADDER_BOUNDS
from repro_torch.core.ops.shard import MeshSpec
from repro_torch.runtime import mesh_checks, world
from repro_torch.runtime.monitor import run_header

# each port impl and its repro twin
TWIN = {("gemm", "torch"): "xla", ("gemm", "cuda"): "pallas",
        ("gemm", "cuda_naive"): "pallas_naive", ("attention", "torch"): "xla",
        ("attention", "cuda_fused"): "pallas_fused", ("grouped", "torch"): "xla",
        ("grouped", "cuda_grouped"): "pallas_grouped"}
WORLD_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's own small CPU ops on one thread (the spawned ranks
    take their share of the cores themselves), leaving the cores to the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ================================================== MeshSpec grammar

@pytest.mark.parametrize("text", ["dp=2,tp=2,ep=2", "tp=4", "dp=8", "dp=2,pod=2", "none", "",
                                  "1", "identity", "NONE", " dp=2 , tp=2 "])
def test_parse_describe_size_match_repro(text):
    mine, theirs = MeshSpec.parse(text), JMeshSpec.parse(text)
    assert (mine.dp, mine.tp, mine.ep, mine.pod) == (theirs.dp, theirs.tp, theirs.ep, theirs.pod)
    assert mine.describe() == theirs.describe()
    assert (mine.size, mine.is_identity) == (theirs.size, theirs.is_identity)
    assert MeshSpec.parse(mine.describe()) == mine
    assert mine.axis_items() == theirs._axis_items()


@pytest.mark.parametrize("text", ["dp=2,fsdp=4", "dp2", "dp=x"])
def test_bad_tokens_fail_like_repro(text):
    with pytest.raises(ValueError) as mine:
        MeshSpec.parse(text)
    with pytest.raises(ValueError) as theirs:
        JMeshSpec.parse(text)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="positive int"):
        MeshSpec(dp=0)


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data", "model")),
                                        ((2, 2, 2), ("data", "expert", "model"))])
def test_from_shape_matches_repro(shape, axes):
    assert MeshSpec.from_shape(shape, axes).describe() == \
        JMeshSpec.from_shape(shape, axes).describe()


def test_spec_rides_in_the_policy_and_active_mesh():
    p = ops.ExecutionPolicy(default="bf16", mesh=MeshSpec(dp=2, tp=2))
    assert hash(p) == hash(ops.ExecutionPolicy(default="bf16", mesh=MeshSpec(dp=2, tp=2)))
    assert p.for_("mlp").mesh == MeshSpec(dp=2, tp=2)
    assert shard.active_mesh(None) is None
    assert shard.active_mesh(MeshSpec()) is None
    assert shard.active_mesh(MeshSpec(dp=2)) == MeshSpec(dp=2)
    r = ops.Route(precision="f32", backends={"gemm": "cuda"}, mesh=MeshSpec(dp=2))
    inner = shard.unsharded_route(r)
    assert inner.mesh is None and inner.impl("gemm") == "cuda" and inner.precision == "f32"
    plain = ops.Route(precision="f32")
    assert shard.unsharded_route(plain) is plain


# ===================================== Partitioning-gated validation

def test_unshardable_impl_rejected_naming_capability_and_mesh():
    with pytest.raises(ValueError) as mine:
        ops.ExecutionPolicy(default="bf16", backends={"gemm": "cuda_naive"},
                            mesh=MeshSpec(dp=2, tp=2))
    with pytest.raises(ValueError) as theirs:
        jops.ExecutionPolicy(default="bf16", backends={"gemm": "pallas_naive"},
                             mesh=JMeshSpec(dp=2, tp=2))
    for msg in (str(mine.value), str(theirs.value)):
        assert "capability 'partitioning' (mesh dp=2,tp=2,ep=1)" in msg


def test_identity_mesh_skips_partitioning_demand():
    p = ops.ExecutionPolicy(default="bf16", backends={"gemm": "cuda_naive"}, mesh=MeshSpec())
    assert p.impl_for("gemm") == "cuda_naive"


def test_fallback_resolves_unshardable_to_reference():
    with pytest.warns(RuntimeWarning, match="falling back"):
        p = ops.ExecutionPolicy(default="bf16", backends={"gemm": "cuda_naive"},
                                mesh=MeshSpec(dp=2, tp=2), fallback=True)
    assert dict(p.backends)["gemm"] == ops.reference_impl("gemm") == "torch"


def test_mesh_demands_partitioning_of_unmapped_families():
    p = ops.ExecutionPolicy(default="bf16", backends={}, mesh=MeshSpec(dp=2, ep=2, tp=2))
    for fam in ops.families():
        assert ops.get_impl(fam, p.impl_for(fam)).capabilities.partitioning is not None


def test_shardable_column_matches_repro():
    theirs = {(r["family"], r["impl"]): r for r in jops.capability_rows()}
    rows = registry.capability_rows()
    assert "shardable" in registry.capability_markdown().splitlines()[0]
    for r in rows:
        assert r["shardable"] == theirs[(r["family"], TWIN[(r["family"], r["impl"])])]["shardable"]
    for fam in ops.families():
        assert ops.get_family(fam).audit_meshes == jops.get_family(fam).audit_meshes


@pytest.mark.parametrize("mesh", [None, "dp=2,tp=2", "tp=16,pod=2"])
def test_run_header_matches_repro(mesh):
    spec, jspec = ((None, None) if mesh is None else (MeshSpec.parse(mesh), JMeshSpec.parse(mesh)))
    p = ops.ExecutionPolicy(default="bf16", backends={"attention": "cuda_fused"}, mesh=spec)
    jp = jops.ExecutionPolicy(default="bf16", backends={"attention": "pallas_fused"}, mesh=jspec)
    mine = run_header("gemma3-1b", policy=p, mesh=p.mesh).split(" | ")
    theirs = j_run_header("gemma3-1b", policy=jp, mesh=jp.mesh).split(" | ")
    assert mine[:2] == theirs[:2]
    twins = " ".join(f"{fam}={TWIN[(fam, impl)]}" for fam, impl in
                     (part.split("=") for part in mine[2].split()))
    assert twins == theirs[2]
    assert run_header("gemma3-1b") == j_run_header("gemma3-1b")


# ================================ identity mesh: the same traced graph

def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("family", ["gemm", "attention", "grouped"])
@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_identity_mesh_traces_the_same_graph(family, impl):
    name = {"reference": "torch", "kernel": {"gemm": "cuda", "attention": "cuda_fused",
                                             "grouped": "cuda_grouped"}[family]}[impl]
    if family == "gemm":
        args = (_rand((8, 16), 1), _rand((16, 8), 2))

        def fn(route):
            return lambda a, b: ops.gemm(a, b, policy=route)
    elif family == "attention":
        args = (_rand((2, 8, 1, 2, 8), 3), _rand((2, 8, 1, 8), 4), _rand((2, 8, 1, 8), 5))

        def fn(route):
            return lambda q, k, v: ops.attention_forward(q, k, v, policy=route)
    else:
        offs = torch.tensor([0, 16, 32], dtype=torch.int32)
        args = (_rand((32, 8), 6), _rand((2, 8, 8), 7))

        def fn(route):
            return lambda x, w: ops.grouped_matmul(x, w, offs, policy=route, bm=16)

    def code(mesh):
        route = ops.Route(precision="bf16", backends={family: name}, mesh=mesh)
        return make_fx(fn(route))(*args).code

    assert code(None) == code(MeshSpec())


# ============================= sharded vs one rank: the parity matrix

CASES = mesh_checks.parity_cases("cpu")
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def worlds():
    """Every case's results: a 4-rank world for the meshes of up to 4
    ranks, an 8-rank world for the rest."""
    small = [c for c in CASES if MeshSpec.parse(c["mesh"]).size <= 4]
    large = [c for c in CASES if MeshSpec.parse(c["mesh"]).size > 4]
    out = {}
    for n, cases in ((4, small), (8, large)):
        ranks = world.spawn(mesh_checks.parity_worker, n, args=(cases,), timeout=WORLD_TIMEOUT)
        for c in cases:
            out[c["name"]] = [r["results"][c["name"]] for r in ranks if c["name"] in r["results"]]
    return out


def _repro_single(case, x):
    """``repro``'s one-device result on the same inputs (its ``xla`` route)."""
    j = {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    route = jops.Route(precision=case["precision"])
    fam = case["family"]
    if fam == "gemm":
        return {"out": jops.gemm(j["a"], j["b"], policy=route)}
    if fam == "gemm_grad":
        da, db = jax.grad(lambda a, b: jops.gemm(a, b, policy=route).sum(),
                          argnums=(0, 1))(j["a"], j["b"])
        return {"da": da, "db": db}
    if fam == "attention":
        return {"out": jops.attention_forward(j["q"], j["k"], j["v"], causal=True,
                                              window=case["window"], policy=route)}
    if fam == "decode":
        return {"out": jops.attention_decode(j["q"], j["k"], j["v"], j["pos"], policy=route)}
    return {"out": jops.grouped_matmul(j["x"], j["w"], j["offsets"], policy=route)}


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_sharded_matches_one_rank(worlds, name):
    case = BY_NAME[name]
    ranks = worlds[name]
    assert len(ranks) == MeshSpec.parse(case["mesh"]).size
    want = {k: v.detach().numpy() for k, v in mesh_checks.run_case(case, "cpu").items()}
    for key, expect in want.items():
        assert len({r[key][0] for r in ranks}) == 1, f"{key}: the ranks hold different results"
        got = ranks[0][key][1]
        if case["expect"] == "bit":
            np.testing.assert_array_equal(got, expect, err_msg=key)
        else:
            np.testing.assert_allclose(got, expect, rtol=0, atol=case["expect"], err_msg=key)
    theirs = _repro_single(case, mesh_checks.case_inputs(case, "cpu"))
    for key, expect in want.items():
        err = np.abs(expect - np.asarray(theirs[key], np.float32)).max()
        assert err <= LADDER_BOUNDS[case["precision"]], (key, err)
