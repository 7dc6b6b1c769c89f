"""The port's train CLI over a mesh of gloo ranks, with an elastic resume,
held against the one-rank port and ``repro``'s headers on the CPU.

``--mesh dp=2,tp=2`` trains smoke gemma3-1b for 3 steps at f32 on four
ranks and checkpoints every step (each rank writes its blocks of the
params and the AdamW state); ``--mesh auto`` on two ranks (dp=2) resumes
from step 3 and trains 2 more.  Every step's loss is within 1e-5 of the
one-rank port's on the same batches taken as 2 microbatches: the same
arithmetic as the data-parallel mean (each half's gradient, summed and
halved), and in fact bit-equal.  The one-rank port on the whole batch
sums the gradient in another order, and AdamW's normalized update makes
that grow (5e-7 at step 3, 6e-5 at step 5, 5e-4 at step 6 here): the
first 3 steps are held to it within 1e-5 too.  The run headers name the
mesh as ``repro``'s ``run_header`` does.  A mesh larger than its ranks fails
before any rank starts.
"""

import math

import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import execution_policy_for as j_execution_policy_for
from repro.core import ops as jops
from repro.core.ops.shard import MeshSpec as JMeshSpec
from repro.runtime import mesh as jmesh
from repro.runtime.monitor import run_header as j_run_header
from repro_torch.launch.train import main
from repro_torch.runtime import world

ARGS = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--policy", "f32", "--backend", "gemm=cuda", "--backend", "attention=cuda_fused",
        "--timeout", "120"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's own small CPU ops on one thread (the spawned ranks
    take their share of the cores themselves), leaving the cores to the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repro_header(mesh):
    jcfg = j_get_smoke("gemma3-1b")
    pol = j_execution_policy_for(jcfg, default="f32",
                                 backends={"gemm": "pallas", "attention": "pallas_fused"},
                                 require={f: ("vjp",) for f in jops.families()}, mesh=mesh)
    return j_run_header("gemma3-1b", policy=pol, mesh=pol.mesh)


def test_train_cli_mesh_then_elastic_resume(tmp_path, capfd):
    ckpt = str(tmp_path / "ckpt")
    mesh_hist = main(ARGS + ["--steps", "3", "--mesh", "dp=2,tp=2", "--ckpt-dir", ckpt,
                             "--ckpt-every", "1"])
    out4 = capfd.readouterr().out
    resumed = main(ARGS + ["--steps", "5", "--mesh", "auto", "--nprocs", "2",
                           "--ckpt-dir", ckpt])
    out2 = capfd.readouterr().out
    halves = main(ARGS + ["--steps", "5", "--microbatches", "2"])
    one = main(ARGS + ["--steps", "3"])
    assert len(mesh_hist) == 3 and len(resumed) == 2
    assert max(abs(a - b) for a, b in zip(mesh_hist + resumed, halves)) <= 1e-5, \
        (mesh_hist, resumed, halves)
    assert max(abs(a - b) for a, b in zip(mesh_hist, one)) <= 1e-5, (mesh_hist, one)
    assert "trained 3 steps" in out4 and "trained 2 steps" in out2
    assert (tmp_path / "ckpt" / "step_000000003" / "proc_003").is_dir()
    # the headers: repro's mesh and route string (impl names mapped to the twins)
    twins = {"cuda_fused": "pallas_fused", "cuda": "pallas", "torch": "xla"}
    jcfg = j_get_smoke("gemma3-1b")
    for out, jmesh_spec in ((out4, JMeshSpec(dp=2, tp=2)),
                            (out2, jmesh.resolve_mesh_spec("auto", jcfg, n_devices=2))):
        line = next(x for x in out.splitlines() if x.startswith("run: "))
        parts = line.split(" | ")
        mapped = " ".join(f"{k}={twins[v]}" for k, v in (p.split("=") for p in parts[2].split()))
        assert " | ".join(parts[:2] + [mapped]) == _repro_header(jmesh_spec)
    assert "mesh dp=2,tp=2,ep=1 (4 devices)" in out4
    assert "mesh dp=2,tp=1,ep=1 (2 devices)" in out2


def test_mesh_larger_than_its_ranks_fails_loudly():
    with pytest.raises(SystemExit, match="places 4 rank"):
        main(ARGS + ["--steps", "1", "--mesh", "dp=2,tp=2", "--nprocs", "2"])
    # more ranks than cards: only with share_card, never on the CPU instead
    with pytest.raises(RuntimeError, match="--share-card"):
        world.backend_for("cuda", torch.cuda.device_count() + 1)


def test_compressed_gradient_mean_trains(capfd):
    """``--compress-grads`` over dp=2: step 1's loss is the uncompressed
    run's (nothing has been applied yet; a dp=2 run is the one-rank run at
    2 microbatches), step 2 trains on the bf16-wire mean with f32 error
    feedback: finite, and not the f32 mean's."""
    plain = main(ARGS + ["--steps", "2", "--microbatches", "2"])
    packed = main(ARGS + ["--steps", "2", "--mesh", "dp=2", "--nprocs", "2", "--compress-grads"])
    capfd.readouterr()
    assert packed[0] == plain[0]
    assert math.isfinite(packed[1]) and packed[1] != plain[1]
