"""Deterministic synthetic LM data (twin of ``repro.data.pipeline``).

Batch i is a pure function of (seed, i, proc): the same numpy stream
``SeedSequence([seed, i, proc])`` as the JAX package draws (the tokens,
then an audio config's frames, then a VLM config's image rows), so the
two packages train on bit-equal batches, and a restart needs no data state
(the checkpoint stores only the step).  Batches are host numpy arrays;
the train loop moves them to the device.  ``host_slice`` gives a
process its rows of the global batch (rank and world from
``torch.distributed``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections.abc import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLMDataset", "Prefetcher", "host_slice"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    frames_dim: int = 0        # audio stub: emit frames (B, frames_seq, frames_dim)
    frames_seq: int = 0
    image_tokens: int = 0      # vlm stub: emit image_embeds (B, image_tokens, image_dim)
    image_dim: int = 0


class SyntheticLMDataset:
    """batch(i) -> {"tokens", "labels"} int32 (B, seq_len) numpy arrays for
    process ``proc`` of ``nproc``, with f32 ``frames`` and ``image_embeds``
    where the config asks for them."""

    def __init__(self, cfg: DataConfig, proc: int = 0, nproc: int = 1):
        if cfg.global_batch % nproc:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.proc, self.nproc = proc, nproc
        self.local_batch = cfg.global_batch // nproc

    def batch(self, i: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, i, self.proc]))
        shape = (self.local_batch, cfg.seq_len + 1)
        stream = rng.integers(0, cfg.vocab_size, size=shape, dtype=np.int32)
        out = {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
        if cfg.frames_dim:
            out["frames"] = rng.standard_normal(
                (self.local_batch, cfg.frames_seq, cfg.frames_dim), dtype=np.float32)
        if cfg.image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.image_tokens, cfg.image_dim), dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over a dataset iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def host_slice(global_batch: int, seq_len: int, *, proc: int | None = None,
               nproc: int | None = None) -> tuple[int, int]:
    """This process's (start, size) slice of the global batch: process
    ``proc`` of ``nproc``, by default the rank and world size of the
    default process group (0 of 1 without one)."""
    del seq_len
    if proc is None or nproc is None:
        import torch.distributed as dist
        up = dist.is_available() and dist.is_initialized()
        proc = dist.get_rank() if up else 0
        nproc = dist.get_world_size() if up else 1
    per = global_batch // nproc
    return proc * per, per
