"""The port's placements, mesh choice, compression, sharded checkpoints
and the small mesh-facing helpers held against ``repro`` on the CPU.

* ``choose_mesh_shape`` / ``mesh_spec_for`` / ``replica_mesh_spec`` /
  ``resolve_mesh_spec`` and ``Autoscaler.mesh_for``: equal to ``repro``'s
  for all ten configs at 1-16 devices (pure functions, no devices).
* ``Sharder``: every param leaf's placement equals ``repro``'s
  ``_param_spec`` of the stacked leaf it came from (the ``count`` dim
  dropped), and ``batch_specs`` / ``_cache_spec`` equal ``repro``'s, for
  all ten configs at dp=2,tp=2, dp=2,ep=2,tp=2 and tp=16, in train and
  serve modes, with no policy and with the naive GEMM (no Partitioning).
  ``repro``'s ``Sharder`` reads only ``mesh.shape`` and
  ``mesh.axis_names``: it gets a plain stand-in.
* The activation constrainer pins ``repro``'s placements.
* Compression: bit-equal to ``repro``'s ``compressed_pmean`` in a
  one-device ``shard_map`` over three steps of error feedback; on 4
  ranks the reduced vector is the mean of the ranks' ``split2`` hi parts.
* A checkpoint saved by 4 ranks (dp=2,tp=2) restores bit-equal on 2
  ranks (dp=2) and on 1.
* ``host_slice`` equals ``repro``'s.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS
from repro.configs import get_config as j_get_config
from repro.core import ops as jops
from repro.core.ops.shard import MeshSpec as JMeshSpec
from repro.data.pipeline import host_slice as j_host_slice
from repro.models import api as japi
from repro.optim.compression import compressed_pmean as j_compressed_pmean
from repro.runtime import act_sharding as j_act
from repro.runtime import mesh as jmesh
from repro.runtime import sharding as jsharding
from repro.serve.autoscale import Autoscaler as JAutoscaler
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import ops
from repro_torch.core.ops.shard import MeshSpec
from repro_torch.core.precision import split2
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.data.pipeline import host_slice
from repro_torch.models import api
from repro_torch.optim import adamw, compression
from repro_torch.runtime import act_sharding, mesh, sharding, world
from repro_torch.serve.autoscale import Autoscaler

MESHES = ("dp=2,tp=2", "dp=2,ep=2,tp=2", "tp=16")
# no policy (divisibility alone) and one whose GEMM impl declares no
# Partitioning (the capability gate)
POLICIES = {
    "none": (None, None),
    "naive": ({"gemm": "cuda_naive"}, {"gemm": "pallas_naive"}),
}
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


# ============================================================ mesh choice

@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_choice_matches_repro(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert mesh.max_parallel_degree(cfg, 16) == jmesh.max_parallel_degree(jcfg, 16)
    for n in range(1, 17):
        assert mesh.choose_mesh_shape(n, cfg) == jmesh.choose_mesh_shape(n, jcfg)
        assert mesh.choose_mesh_shape(n) == jmesh.choose_mesh_shape(n)
        assert mesh.mesh_spec_for(n, cfg).describe() == jmesh.mesh_spec_for(n, jcfg).describe()
        assert mesh.resolve_mesh_spec("auto", cfg, n_devices=n).describe() == \
            jmesh.resolve_mesh_spec("auto", jcfg, n_devices=n).describe()
        for active in range(1, 5):
            assert mesh.replica_mesh_spec(n, active, cfg).describe() == \
                jmesh.replica_mesh_spec(n, active, jcfg).describe()
    pol = ops.ExecutionPolicy(backends={"gemm": "cuda"})
    spec, sh, rerouted = mesh.resharder_for(cfg, 8, policy=pol)
    assert spec.describe() == jmesh.mesh_spec_for(8, jcfg).describe()
    assert rerouted.mesh == spec and sh.mesh == spec and rerouted.impl_for("gemm") == "cuda"
    assert mesh.resharder_for(cfg, 4)[0] == mesh.mesh_spec_for(4, cfg)
    for flag in (None, "dp=2,tp=2", "none", "tp=4,ep=2"):
        mine = mesh.resolve_mesh_spec(flag, cfg)
        theirs = jmesh.resolve_mesh_spec(flag, jcfg)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.describe() == theirs.describe()
    with pytest.warns(DeprecationWarning):
        assert mesh.resolve_mesh_flag(None, True) == "auto"
    with pytest.warns(DeprecationWarning):
        assert jmesh.resolve_mesh_flag(None, True) == "auto"
    assert mesh.resolve_mesh_flag("tp=2") == jmesh.resolve_mesh_flag("tp=2") == "tp=2"


def test_autoscaler_mesh_for_matches_repro():
    cfg, jcfg = get_smoke("gemma3-1b"), j_get_config("mixtral-8x7b")
    for n_dev in (1, 2, 4, 8, 16):
        for c, jc in ((cfg, cfg), (get_config("mixtral-8x7b"), jcfg)):
            pool = types.SimpleNamespace(max_replicas=1, cfg=c)
            jpool = types.SimpleNamespace(max_replicas=1, cfg=jc)
            mine = Autoscaler(pool, cfg=c, n_devices=n_dev)
            theirs = JAutoscaler(jpool, cfg=jc, n_devices=n_dev)
            for active in range(1, 5):
                assert mine.mesh_for(active).describe() == theirs.mesh_for(active).describe()


def test_host_slice_matches_repro():
    assert host_slice(8, 32) == j_host_slice(8, 32) == (0, 8)
    assert host_slice(8, 32, proc=1, nproc=2) == (4, 4)


# ============================================================ placements

def _stand_in(text):
    items = JMeshSpec.parse(text)._axis_items()
    return types.SimpleNamespace(shape=dict(items), axis_names=tuple(a for a, _ in items))


def _repro_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                     for k in kp): tuple(leaf.shape)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _layer_map(cfg):
    """Port flat layer index -> repro's (segment, position), in scan order."""
    out = {}
    for key, prefix, segs in (("layers", "seg", cfg.segments),
                              ("enc_layers", "enc_seg", cfg.encoder_segments or ())):
        k = 0
        for i, seg in enumerate(segs):
            for _ in range(seg.count):
                for j in range(len(seg.pattern)):
                    out[(key, k)] = f"{prefix}{i}/pos{j}"
                    k += 1
    return out


@pytest.fixture(scope="module")
def trees():
    """Per arch: the port's param leaves (fake tensors, full size) and
    repro's abstract params and caches."""
    out = {}
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        with FakeTensorMode():
            params = api.init_params(cfg, torch.Generator(), "cpu")
        jparams = jax.eval_shape(lambda c=jcfg: japi.init_params(jax.random.PRNGKey(0), c))
        jcaches = {b: jax.eval_shape(lambda c=jcfg, b=b: japi.init_cache(c, b, 64))
                   for b in (1, 8)}
        out[arch] = ([(p, tuple(x.shape)) for p, x in leaves_with_paths(params)],
                     _repro_leaves(jparams), {b: _repro_leaves(c) for b, c in jcaches.items()},
                     sharding._estimate_param_bytes(cfg))
    return out


@pytest.mark.parametrize("mesh_text", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharder_placements_match_repro(trees, arch, mesh_text):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    port_leaves, j_leaves, j_caches, pbytes = trees[arch]
    assert pbytes == jsharding._estimate_param_bytes(jcfg)
    layer = _layer_map(cfg)
    spec, jmesh_ = MeshSpec.parse(mesh_text), _stand_in(mesh_text)
    for mode in ("train", "serve"):
        for pol_name, (backends, jbackends) in POLICIES.items():
            pol = None if backends is None else ops.ExecutionPolicy(backends=backends)
            jpol = None if jbackends is None else jops.ExecutionPolicy(backends=jbackends)
            mine = sharding.Sharder(cfg, spec, mode=mode, policy=pol)
            theirs = jsharding.Sharder(jcfg, jmesh_, mode=mode, policy=jpol,
                                       param_bytes=pbytes)
            theirs.ns = lambda s: s
            where = (mode, pol_name)
            assert mine.fsdp == theirs.fsdp, where
            for path, shape in port_leaves:
                head, _, rest = path.partition("/")
                if head in ("layers", "enc_layers"):
                    k, _, tail = rest.partition("/")
                    jpath = f"{layer[(head, int(k))]}/{tail}"
                    want = tuple(theirs._param_spec(jpath, j_leaves[jpath]))[1:]
                    assert j_leaves[jpath][1:] == shape, (jpath, shape)
                else:
                    jpath = path
                    want = tuple(theirs._param_spec(jpath, shape))
                    assert j_leaves[jpath] == shape, (jpath, shape)
                assert mine.param_spec(path, shape) == want, (where, path)
            for b in (1, 2, 8, 32):
                batch = {"tokens": np.zeros((b, 64)), "labels": np.zeros((b, 64)),
                         "pos": np.zeros((b,)), "frames": np.zeros((b, 64, 8)),
                         "step": np.zeros(())}
                want = {k: tuple(v) for k, v in theirs.batch_specs(batch).items()}
                assert mine.batch_specs(batch) == want, (where, b)
            for b, cache in j_caches.items():
                for path, shape in cache.items():
                    assert mine._cache_spec(path, shape) == \
                        tuple(theirs._cache_spec(path, shape)), (where, path)


def test_param_specs_tree_and_placements():
    cfg = get_smoke("gemma3-1b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sh = sharding.Sharder(cfg, MeshSpec(dp=2, tp=2))
    specs = sh.param_specs(params)
    assert specs["embed"]["table"] == ("model", None)
    assert specs["layers"][0]["wq"]["w"] == ("data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements(("data", "model"), MeshSpec(dp=2, tp=2)) == \
        [Shard(0), Replicate(), Shard(1)]
    cache = api.init_cache(cfg, 2, 16, device="cpu")
    kv = sh.cache_specs(cache)[0]
    assert kv.k == ("data", None, None, None)     # (B: dp, S, Kv = 1: replicated, hd)


@pytest.mark.parametrize("kind,shape", [("logits", (4, 8, 256)), ("logits", (3, 8, 255)),
                                        ("residual", (4, 8, 16)), ("residual", (3, 8, 16)),
                                        ("other", (4, 8, 16))])
@pytest.mark.parametrize("pol_name", ["none", "naive"])
def test_constrainer_pins_repro_placements(monkeypatch, kind, shape, pol_name):
    cfg, jcfg = get_smoke("gemma3-1b"), j_get_config("gemma3-1b")
    backends, jbackends = POLICIES[pol_name]
    pol = None if backends is None else ops.ExecutionPolicy(backends=backends)
    jpol = None if jbackends is None else jops.ExecutionPolicy(backends=jbackends)
    mine = act_sharding.make_constrainer(sharding.Sharder(cfg, MeshSpec(dp=2, tp=2), policy=pol))
    jsh = jsharding.Sharder(jcfg, _stand_in("dp=2,tp=2"), policy=jpol)
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)
    got = j_act.make_constrainer(jsh)(jnp.zeros(shape), kind)
    want = None if not isinstance(got, jax.sharding.PartitionSpec) else tuple(got)
    assert mine.spec(torch.zeros(shape), kind) == want
    x = torch.zeros(shape)
    with act_sharding.use_constrainer(mine):
        assert act_sharding.constrain(x, kind) is x      # plain tensors pass through
    assert act_sharding.constrain(x, kind) is x


# ============================================================ compression

def test_compression_matches_repro_one_device():
    from jax.sharding import Mesh, PartitionSpec as P
    jm = Mesh(np.array(jax.devices()[:1]), ("data",))
    body = jax.shard_map(lambda g, e: j_compressed_pmean(g, e, "data"), mesh=jm,
                         in_specs=(P(), P()), out_specs=(P(), P()))
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (13,)}
    err = compression.init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    jerr = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        red, err = compression.compressed_pmean({k: torch.from_numpy(v) for k, v in g.items()},
                                                err, "data")
        jred, jerr = body({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        for k in shapes:
            np.testing.assert_array_equal(red[k].numpy(), np.asarray(jred[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))
    flat, tdef, shp = compression.flatten_tree(red)
    back = compression.unflatten_tree(flat, tdef, shp)
    assert all(torch.equal(back[k], red[k]) for k in shapes)


# ================================================== checkpoint world

def _tree(cfg):
    params = api.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    opt = adamw.init(params)
    for x in leaves(opt.m) + leaves(opt.v):
        x.copy_(torch.randn(x.shape, generator=torch.Generator().manual_seed(x.numel())))
    return params, opt


def _layout(cfg, spec, rank, tree):
    sh = sharding.Sharder(cfg, spec)
    params, _ = tree
    specs = [sh.param_spec(p, tuple(x.shape)) for p, x in leaves_with_paths(params)]
    shapes = [tuple(x.shape) for x in leaves(params)]
    return sharding.MeshLayout(specs + [()] + specs + specs, shapes + [()] + shapes + shapes,
                               spec, rank)


def _blocks(tree, layout):
    from repro_torch.core.tree import tree_map
    it = iter(range(len(leaves(tree))))

    def block(x):
        i = next(it)
        idx = layout.index(i, layout.rank)
        return x[tuple(slice(a, b) for a, b in idx)].contiguous() if idx else x.clone()
    return tree_map(block, tree)


def ckpt_worker(rank, world_size, root, mode):
    """Save the smoke tree's blocks (``mode`` "save", dp=2,tp=2) or
    restore them onto dp=2 (``mode`` "restore"); plus, on save, the
    4-rank compressed mean."""
    cfg = get_smoke("gemma3-1b")
    tree = _tree(cfg)
    mgr = CheckpointManager(root)
    if mode == "save":
        spec = MeshSpec(dp=2, tp=2)
        layout = _layout(cfg, spec, rank, tree)
        mgr.save(7, _blocks(tree, layout), layout=layout)
        g = torch.from_numpy(np.random.default_rng(rank).standard_normal(257).astype(np.float32))
        red, new_e = compression.make_compressed_allreduce(MeshSpec(dp=4))(g, torch.zeros(257))
        return red.numpy(), new_e.numpy()
    spec = MeshSpec(dp=2)
    layout = _layout(cfg, spec, rank, tree)
    like = _blocks(tree, layout)
    got = mgr.restore(7, like, layout=layout)
    return all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(like)))


def test_sharded_checkpoint_restores_on_two_ranks_and_one(tmp_path):
    import test_torch_sharding as me
    root = str(tmp_path / "ckpt")
    saved = world.spawn(me.ckpt_worker, 4, args=(root, "save"), timeout=WORLD_TIMEOUT)
    assert sorted(p.name for p in (tmp_path / "ckpt" / "step_000000007").iterdir()) == \
        ["meta.json", "proc_000", "proc_001", "proc_002", "proc_003"]
    assert world.spawn(me.ckpt_worker, 2, args=(root, "restore"), timeout=WORLD_TIMEOUT) == \
        [True, True]
    tree = _tree(get_smoke("gemma3-1b"))
    like = tuple(tree)
    got = CheckpointManager(root).restore(7, like)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(like)))
    # the 4-rank compressed mean: the mean of the ranks' bf16 hi parts
    his = [split2(torch.from_numpy(np.random.default_rng(r).standard_normal(257)
                                   .astype(np.float32)))[0].float() for r in range(4)]
    want = ((his[0] + his[1]) + his[2] + his[3]) / 4
    for r, (red, new_e) in enumerate(saved):
        np.testing.assert_array_equal(red, want.numpy())
        g = np.random.default_rng(r).standard_normal(257).astype(np.float32)
        np.testing.assert_array_equal(new_e, g - his[r].numpy())
