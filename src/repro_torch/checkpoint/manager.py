"""Sharded, atomic, restart-safe checkpointing (twin of
``repro.checkpoint.manager``).

Layout (one directory per step):

    <root>/step_000123.tmp-<pid>/      # staged writes
    <root>/step_000123/                # atomic rename on completion
        meta.json                      # step, leaf paths, shapes, dtypes
        leaf_0000.npy ...              # one file per leaf, walk order

A run over a mesh passes a ``layout`` (``runtime.sharding.MeshLayout``):
each rank then writes only its own blocks (one writer per distinct
block), under ``proc_<rank>/leaf_<i>_shard_0.npy``, and ``meta.json``
records every shard's GLOBAL index, so ``restore`` can assemble each
block a rank requests on a DIFFERENT mesh from whichever saved shards
intersect it: the elastic-rescale path (``runtime/mesh.py``).  A restore
without a layout assembles whole leaves.

A checkpoint directory is valid iff the rename happened; a crash
mid-save leaves only ``.tmp-*`` garbage that ``latest_step`` ignores and
``clean_tmp`` removes.  ``save_async`` copies the tree to host memory
first (so the train loop may update its tensors in place right after)
and writes it on a background thread, with at most one save
outstanding (one process; a mesh run saves blocking, since the ranks
meet at barriers).  ``restore`` rebuilds tensors with the dtype and
device of a template tree.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, tree_map

__all__ = ["CheckpointManager"]


def _host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of ``x`` that later in-place updates of ``x`` leave
    alone."""
    return x.detach().to("cpu", copy=True)


class CheckpointManager:
    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, layout=None) -> str:
        """Blocking save of a tree of tensors (this rank's blocks of it
        under a ``layout``)."""
        if layout is not None:
            return self._save_sharded(step, tree, layout)
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        meta: dict[str, Any] = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
            fn = f"leaf_{i:04d}.npy"
            np.save(os.path.join(tmp, fn), leaf.detach().cpu().numpy())
            meta["leaves"].append({"path": path, "file": fn,
                                   "shape": list(leaf.shape),
                                   "dtype": str(leaf.dtype)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._gc()
        return final

    def _save_sharded(self, step: int, tree: Any, layout) -> str:
        final = self._step_dir(step)
        tmp = f"{final}.tmp-mesh"
        if layout.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)      # a crashed save's leftovers
            os.makedirs(tmp)
        layout.barrier()
        mine = os.path.join(tmp, f"proc_{layout.rank:03d}")
        os.makedirs(mine, exist_ok=True)
        pairs = list(leaves_with_paths(tree))
        for i, (_, leaf) in enumerate(pairs):
            if layout.writes(i, layout.rank):
                np.save(os.path.join(mine, f"leaf_{i:04d}_shard_0.npy"),
                        leaf.detach().cpu().numpy())
        layout.barrier()
        if layout.rank == 0:
            meta: dict[str, Any] = {"step": step, "leaves": []}
            for i, (path, leaf) in enumerate(pairs):
                shards = [{"file": f"proc_{r:03d}/leaf_{i:04d}_shard_0.npy",
                           "index": [list(se) for se in layout.index(i, r)]}
                          for r in range(layout.world) if layout.writes(i, r)]
                meta["leaves"].append({"path": path, "shape": list(layout.shape(i)),
                                       "dtype": str(leaf.dtype), "shards": shards})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, final)
            self._gc()
        layout.barrier()
        return final

    def save_async(self, step: int, tree: Any) -> None:
        """Background save; waits for any outstanding save first."""
        self.wait()
        host_tree = tree_map(_host, tree)

        def run():
            try:
                self.save(step, host_tree)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the outstanding save is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------------------------------------------------- restore

    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.root)
                 if d.startswith("step_") and ".tmp" not in d
                 and os.path.exists(os.path.join(self.root, d, "meta.json"))]
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, layout=None) -> Any:
        """Rebuild the tree saved at ``step`` with the structure, dtypes
        and devices of ``like``: whole leaves, or this rank's blocks of
        them under a ``layout`` (on any mesh, whichever mesh saved)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            entries = json.load(f)["leaves"]
        paths = [p for p, _ in leaves_with_paths(like)]
        if paths != [e["path"] for e in entries]:
            raise ValueError(f"checkpoint at step {step} holds {len(entries)} leaves "
                             f"that do not match the tree's {len(paths)}: "
                             f"structure changed?")
        it = iter(enumerate(entries))

        def one(x: torch.Tensor) -> torch.Tensor:
            i, e = next(it)
            want = (layout.index(i, layout.rank) if layout is not None
                    else tuple((0, n) for n in e.get("shape", x.shape)))
            arr = _assemble(d, e, want)
            return torch.from_numpy(arr).to(device=x.device, dtype=x.dtype)

        return tree_map(one, like)

    # --------------------------------------------------------------- gc

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                       if d.startswith("step_") and ".tmp" not in d)
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def clean_tmp(self) -> None:
        for d in os.listdir(self.root):
            if ".tmp-" in d:
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)


def _assemble(d: str, entry: dict, want) -> np.ndarray:
    """The block ``want`` ((start, stop) per dim) of one saved leaf, read
    from every saved shard that intersects it."""
    if "file" in entry:                          # one whole-leaf file
        arr = np.load(os.path.join(d, entry["file"]))
        if all(a == 0 and b == n for (a, b), n in zip(want, arr.shape)):
            return arr
        return np.array(arr[tuple(slice(a, b) for a, b in want)])
    out = None
    for sh in entry["shards"]:
        have = sh["index"]
        lo = [max(a, h[0]) for (a, _), h in zip(want, have)]
        hi = [min(b, h[1]) for (_, b), h in zip(want, have)]
        if any(l_ >= h_ for l_, h_ in zip(lo, hi)) and want:
            continue
        arr = np.load(os.path.join(d, sh["file"]), mmap_mode="r")
        if out is None:
            out = np.empty(tuple(b - a for a, b in want), dtype=arr.dtype)
        src = tuple(slice(l_ - h[0], h_ - h[0]) for l_, h_, h in zip(lo, hi, have))
        dst = tuple(slice(l_ - a, h_ - a) for l_, h_, (a, _) in zip(lo, hi, want))
        out[dst] = arr[src]
    if out is None:
        raise ValueError(f"no saved shard of {entry['path']} covers {want}")
    return out
