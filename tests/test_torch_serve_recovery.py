"""Token-exact recovery at bf16 activations, the serve policy and the
kernel routes (their plain versions on the CPU), on smoke gemma3-1b.

A replica crashes under load; its streams are rehomed and resume by
replaying their emitted tokens through the new slot (``ServeEngine``'s
``_replay``).  Every completed stream must equal the stream of a
reference engine serving it alone.  The reference has the pool's 4 slots:
on the CPU a one-row matmul may sum in another order than a four-row one
(the card's kernels do not; chip_smoke.py's reference has one slot).  The
control is ``repro``'s recovery, a re-prefill of ``prompt +
out_tokens[:-1]``: at bf16 activations its K/V round apart from the
decode's and a resumed stream forks."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import ops
from repro_torch.launch.serve import RecoveryMismatch, Request, ServeEngine
from repro_torch.models import api
from repro_torch.runtime import serve_step
from repro_torch.serve import loadgen
from repro_torch.serve.autoscale import Autoscaler, AutoscalePolicy
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.pool import ReplicaPool

SPEC = loadgen.LoadSpec(n_requests=8, prompt_median=120, prompt_sigma=0.5, max_prompt=300,
                        out_median=24, out_sigma=0.3, max_out=40, seed=0)
RATE = 0.3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These engines' CPU ops are small: one thread runs them as fast as
    every core does, and leaves the other cores to the suite's other
    workers (under xdist, every worker's OpenMP threads otherwise contend
    for the same cores and spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    cfg = get_smoke("gemma3-1b")
    assert cfg.activation_dtype == "bfloat16"
    params = api.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    out = {}
    for layout in ("dense", "paged"):
        policy = ops.ExecutionPolicy(
            default="bf16", logits="refine_ab",
            backends={"gemm": "cuda", "attention": "cuda_fused"},
            require={"attention": ("decode", "paged_decode") if layout == "paged"
                     else ("decode",)})

        def engine(idx, pol, batch=4, layout=layout):
            e = ServeEngine(cfg, batch_size=batch, max_ctx=512, policy=pol, eos_id=-1,
                            replica=str(idx), device="cpu", kv_layout=layout)
            e.load(params)
            return e

        plan = FaultPlan.parse("0:crash@5@r0")
        pool = ReplicaPool(cfg, params, replicas=2, batch_size=4, max_ctx=512, policy=policy,
                           eos_id=-1, engine_factory=plan.wrap_factory(engine, n_replicas=2))
        work = loadgen.sample_workload(SPEC, RATE, cfg.vocab_size)
        point = loadgen.run_point(pool, SPEC, RATE, vocab=cfg.vocab_size, chaos=plan, work=work,
                                  autoscaler=Autoscaler(pool, AutoscalePolicy(2, 2)))
        out[layout] = (engine("ref", policy), [r for _, r in work], point, pool)
    return out


def _reference(ref, prompt, max_new):
    req = Request(rid=0, prompt=prompt, max_new_tokens=max_new)
    ref.run([req])
    return req.out_tokens


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_every_completed_stream_equals_the_reference_engines(served, layout):
    ref, reqs, point, pool = served[layout]
    assert point["replica_deaths"] == 1 and point["requests_recovered"] >= 2
    assert point["completed"] == len(reqs) and point["leaked_pages"] == 0
    assert pool.pages_outstanding() == 0
    for r in reqs:
        assert r.out_tokens == _reference(ref, r.prompt, r.max_new_tokens), r.rid


def test_replay_writes_the_decoded_kv_and_a_re_prefill_does_not(served):
    """On the full-context (global) layers: the K/V rows a stream's ticks
    wrote, the rows a recovery replay writes for the same tokens (bit-
    equal), and the rows ``repro``'s re-prefill of ``prompt +
    out_tokens[:-1]`` computes (the control: at bf16 they part)."""
    ref, reqs, _, _ = served["dense"]
    cfg = ref.cfg
    glob = [i for i, _, cap in serve_step.attn_cache_walk(cfg, ref.max_ctx) if cap == ref.max_ctx]
    assert glob
    parted = 0
    for r in reqs[:3]:
        ticked = Request(rid=0, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        ref.run([ticked])
        n = len(r.prompt) + len(ticked.out_tokens) - 1      # rows the ticks wrote
        rows = [(ref.cache[i].k[0, :n].clone(), ref.cache[i].v[0, :n].clone()) for i in glob]
        held = ticked.out_tokens[:len(ticked.out_tokens) - 1]
        resumed = Request(rid=1, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                          out_tokens=list(held))
        assert ref.admit(resumed)
        m = len(r.prompt) + len(held) - 1
        for i, (k, v) in zip(glob, rows):
            assert torch.equal(ref.cache[i].k[0, :m], k[:m])
            assert torch.equal(ref.cache[i].v[0, :m], v[:m])
        ref.cancel(1)
        toks = np.concatenate([r.prompt, np.asarray(held[:-1], np.int32)])
        _, cache1 = ref._prefill(ref.params, ref._prefill_batch(toks))
        for i, (k, v) in zip(glob, rows):
            kp = cache1[i].k[0, len(r.prompt):m].to(k.dtype)
            parted += not torch.equal(kp, k[len(r.prompt):m])
    assert parted >= 1


def test_forged_token_raises_and_frees_the_slot(served):
    ref, reqs, _, _ = served["paged"]
    r = reqs[0]
    for index in (0, 3):
        forged = Request(rid=-1, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                         out_tokens=list(r.out_tokens[:4]))
        forged.out_tokens[index] = (forged.out_tokens[index] + 1) % ref.cfg.vocab_size
        with pytest.raises(RecoveryMismatch) as e:
            ref.admit(forged)
        assert e.value.index == index
        assert ref.pages_outstanding() == 0 and ref.slot_req == [None] * 4
        assert all(not bool(t.any()) for t in ref._tables.values())


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b", "whisper-medium", "internvl2-76b",
                                  "mixtral-8x7b"])
def test_replay_resumes_every_family_token_exactly(arch, layout):
    """Streams evacuated after 5 ticks (3 in slots, one queued) resume on a
    fresh engine with the tokens an undisturbed engine gives them: the
    replay copies back recurrent state (RWKV-6's, Mamba-2's), keeps the
    cross-attention and image-prefix state, and runs the grouped experts."""
    cfg = get_smoke(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    backends = {"gemm": "cuda", "attention": "cuda_fused"}
    if cfg.family == "moe":
        backends["grouped"] = "cuda_grouped"
    policy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab", backends=backends,
        require={"attention": ("decode", "paged_decode") if layout == "paged" else ("decode",)})

    def engine():
        e = ServeEngine(cfg, batch_size=3, max_ctx=400, policy=policy, device="cpu",
                        kv_layout=layout, eos_id=-1)
        e.load(params)
        return e

    def stream():
        rng = np.random.default_rng(1)
        return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, 5 + 7 * i).astype(np.int32),
                        max_new_tokens=12) for i in range(4)]

    ref = stream()
    engine().run(ref)
    reqs = stream()
    first = engine()
    for r in reqs:
        first.submit(r)
    for _ in range(5):
        first.step()
    orphans = first.evacuate()
    assert sorted(len(r.out_tokens) for r in orphans) == [0, 6, 6, 6]
    second = engine()
    second.run(orphans)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref]
    assert first.pages_outstanding() == second.pages_outstanding() == 0
