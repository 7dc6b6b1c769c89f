"""Start, join and stop a world of ranks (``torch.distributed``).

``spawn(fn, nprocs, ...)`` starts ``nprocs`` processes (``spawn`` start
method, so ``fn`` must be importable: a module-level function of a
package), gives each a process group over ``tcp://127.0.0.1:<free
port>`` and runs ``fn(rank, world, *args)``; it returns the ranks'
results in rank order.  Every process it starts is stopped before it
returns: a rank that raises, dies or outlives ``timeout`` fails the call
with that rank's traceback (or exit code) and the others are killed, so
a hung collective cannot hang the caller.

Backends: NCCL with one rank a card where there are as many cards as
ranks; otherwise gloo, whose collectives take CUDA tensors by staging
them through host memory.  Several ranks on one card happen only when
the caller passes ``share_card=True``: a mesh larger than the cards
fails loudly, and nothing moves to the CPU.

``join_from_env()`` joins a world that ``torchrun`` set up instead.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

__all__ = ["spawn", "free_port", "backend_for", "join_from_env", "rank_device"]


def free_port() -> int:
    """A TCP port the OS reports free on 127.0.0.1 (two concurrent
    worlds never draw the same one while both hold it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: str, world: int, *, share_card: bool = False) -> str:
    """``nccl`` for one rank a card, ``gloo`` on the CPU or for ranks that
    share a card (``share_card`` must say so)."""
    if device == "cpu":
        return "gloo"
    import torch
    cards = torch.cuda.device_count()
    if cards >= world:
        return "nccl"
    if not share_card:
        raise RuntimeError(
            f"{world} ranks need {world} cards; {cards} visible.  Pass share_card "
            f"(--share-card) to put several ranks on one card")
    return "gloo"


def rank_device(device: str, rank: int):
    import torch
    if device == "cpu":
        return torch.device("cpu")
    idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def _init(rank: int, world: int, addr: str, backend: str, device: str, timeout: float):
    import torch
    import torch.distributed as dist

    from repro_torch.core.ops import shard
    if device == "cpu":     # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    dev = rank_device(device, rank)
    shard.set_device_type(dev.type)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=addr, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return dev


def _entry(rank, world, addr, backend, device, timeout, fn, args, results):
    if device == "cuda":
        # ranks that share a card share its memory: grow segments in place
        # rather than leave reserved gaps (this process's allocator only)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch.distributed as dist

    from repro_torch.core.ops import shard
    try:
        _init(rank, world, addr, backend, device, timeout)
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - handed to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shard.reset()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), *, device: str = "cpu",
          share_card: bool = False, timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``nprocs`` new ranks; their
    results in rank order (see the module docstring)."""
    import torch.multiprocessing as mp

    backend = backend_for(device, nprocs, share_card=share_card)
    addr = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, nprocs, addr, backend, device, timeout, fn, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} died with exit code {dead[0][1]}")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(nprocs)) - set(out))
                    raise TimeoutError(f"ranks {missing} did not finish in {timeout:.0f} s")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(nprocs)]


def join_from_env(device: str, *, share_card: bool = False, timeout: float = 1800.0):
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); returns (rank, world, device)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    backend = backend_for(device, world, share_card=share_card)
    return rank, world, _init(rank, world, addr, backend, device, timeout)
