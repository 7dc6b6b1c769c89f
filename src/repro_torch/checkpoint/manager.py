"""Atomic, restart-safe checkpointing for one process (twin of
``repro.checkpoint.manager``).

Layout (one directory per step):

    <root>/step_000123.tmp-<pid>/      # staged writes
    <root>/step_000123/                # atomic rename on completion
        meta.json                      # step, leaf paths, shapes, dtypes
        leaf_0000.npy ...              # one file per leaf, walk order

A checkpoint directory is valid iff the rename happened; a crash
mid-save leaves only ``.tmp-*`` garbage that ``latest_step`` ignores and
``clean_tmp`` removes.  ``save_async`` copies the tree to host memory
first (so the train loop may update its tensors in place right after)
and writes it on a background thread, with at most one save
outstanding.  ``restore`` rebuilds tensors with the dtype and device of
a template tree.  Sharded saves and resharding restore wait for the
multi-device slice.
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

    def save(self, step: int, tree: Any) -> str:
        """Blocking save of a tree of tensors."""
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

    def restore(self, step: int, like: Any) -> Any:
        """Rebuild the tree saved at ``step`` with the structure, dtypes
        and devices of ``like``."""
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            entries = json.load(f)["leaves"]
        paths = [p for p, _ in leaves_with_paths(like)]
        if paths != [e["path"] for e in entries]:
            raise ValueError(f"checkpoint at step {step} holds {len(entries)} leaves "
                             f"that do not match the tree's {len(paths)}: "
                             f"structure changed?")
        files = iter(e["file"] for e in entries)

        def one(x: torch.Tensor) -> torch.Tensor:
            arr = np.load(os.path.join(d, next(files)))
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
